"""pantax-tpu command-line interface.

Flag surface mirrors the reference CLI (/root/reference/pantax/src/cli.rs):
database construction (-f/--create), alignment indexing (--index), read
profiling (-s/-l, -r, --species/--strain), and the tuning knobs (--fr, --fc,
--sr, --sd, -a, --min_cov, --min_depth, --shift, --sample*, --ds, --smode,
--solver).  Stage skipping is file-existence driven (main.rs:195-230 parity):
rerunning resumes where outputs are missing unless --force.
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
import time
from pathlib import Path

log = logging.getLogger("pantax_tpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pantax-tpu",
        description="JAX pangenome-graph strain-level metagenomic profiler",
    )
    from . import __version__

    p.add_argument("--version", action="version",
                   version=f"pantax-tpu {__version__}")
    g = p.add_argument_group("general")
    g.add_argument("-f", "--genomesInformation", dest="genomes_info",
                   help="genomes_info.txt (5 tab columns with header)")
    g.add_argument("-d", "--db", default="pantax_db", help="database directory")
    g.add_argument("-s", "--short-read", action="store_true", dest="short_read")
    g.add_argument("-l", "--long-read", action="store_true", dest="long_read")
    g.add_argument("-p", "--paired", action="store_true",
                   help="paired short reads: two files (R1 R2) or one "
                        "interleaved file; mates are aligned jointly with a "
                        "fragment model (consistency bonus + weak-mate rescue)")
    g.add_argument("-r", "--reads", nargs="+", default=[], help="FASTQ/FASTA file(s)")
    g.add_argument("--species", action="store_true")
    g.add_argument("--strain", action="store_true")
    g.add_argument("-t", "--threads", type=int, default=8)

    c = p.add_argument_group("database construction")
    c.add_argument("--create", action="store_true", help="build database and exit")
    c.add_argument("--index", action="store_true", help="build alignment index and exit")
    c.add_argument("--warm-kernels", action="store_true",
                   help="with --index: also pre-compile the device query and "
                        "fused-coverage graphs into the persistent compile "
                        "cache (slow once; first query run then skips "
                        "compilation)")
    c.add_argument("--base-dir", default=None,
                   help="directory genome paths resolve against (default: cwd)")
    c.add_argument("--fast", action="store_true", dest="fast_query",
                   help="screen genomes against the read sample by containment "
                        "ANI before building the database")
    c.add_argument("-A", "--ani", type=float, default=99.0,
                   help="--fast mode: min coverage-adjusted ANI to keep a genome")
    c.add_argument("--qt", action="store_true", dest="query_and_filter",
                   help="only run the --fast genome screen and exit "
                        "(writes the filtered genomes_info)")
    c.add_argument("--syldb", default=None,
                   help="genome sketch cache directory (built on first use)")
    c.add_argument("--export-gfa", default=None, metavar="PATH",
                   help="write the combined pangenome GFA (global node ids) "
                        "and exit (reference_pangenome.gfa interop)")
    c.add_argument("--gfa-dir", default=None,
                   help="directory of externally built <taxid>.gfa species "
                        "graphs (e.g. pggb) to import instead of constructing")

    a = p.add_argument_group("alignment")
    a.add_argument("--long-read-type", default="hifi",
                   choices=["hifi", "ontr10", "ontr9", "clr"],
                   help="sets chunking and DP band width (GraphAligner's "
                        "--precise-clipping analog, alignment.rs:144-165)")
    a.add_argument("--batch-size", type=int, default=None,
                   help="reads per device dispatch (default: 65536 short, "
                        "16384 long)")
    a.add_argument("--mesh", default="auto", metavar="auto|off|N",
                   help="shard read batches over a device mesh: 'auto' uses "
                        "all visible devices (coverage psum-merged across "
                        "them), 'off' stays on one device, N uses the first "
                        "N devices")
    a.add_argument("--distributed", default=None, metavar="HOST:PORT,N,I",
                   help="multi-host runtime: jax.distributed coordinator "
                        "address, process count N, this process id I; every "
                        "process runs the same command and the device mesh "
                        "spans all hosts (parallel/distributed.py)")
    a.add_argument("--coverage", default="auto",
                   choices=["auto", "host", "device"],
                   help="strain coverage engine (device = jitted device "
                        "path)")
    a.add_argument("--tail", default="auto",
                   choices=["auto", "host", "device"],
                   help="fused profile tail: keep na/ta/bc on device "
                        "(device) or download and filter on host (host)")
    a.add_argument("--fastpath", action="store_true",
                   help="short reads: array-native profiling without writing "
                        "the GAF artifact (fastest; no alignment resume file)")

    q = p.add_argument_group("profiling")
    q.add_argument("-a", dest="min_species_abundance", type=float, default=1e-4)
    q.add_argument("--fr", dest="unique_trio_nodes_fraction", type=float, default=None,
                   help="min covered fraction of a strain's unique trio nodes "
                        "(default 0.3 short / 0.5 long)")
    q.add_argument("--fc", dest="unique_trio_nodes_count", type=float, default=0.46)
    q.add_argument("--sr", dest="single_cov_ratio", type=float, default=0.85)
    q.add_argument("--sd", dest="single_cov_diff", type=float, default=0.2)
    q.add_argument("--min_cov", type=float, default=0.0)
    q.add_argument("--min_depth", type=float, default=0.0)
    q.add_argument("--shift", default=None, choices=[None, "true", "false"])
    q.add_argument("--no_filter", action="store_true",
                   help="disable the species mapq credibility filter")
    q.add_argument("--sample", dest="sample_nodes", type=int, default=500000)
    q.add_argument("--sample_test", action="store_true")
    q.add_argument("--ds", dest="designated_species", default=None,
                   help="comma-separated species taxids to profile")
    q.add_argument("--smode", type=int, default=2)
    q.add_argument("--solver", default="admm", choices=["admm", "highs"])

    o = p.add_argument_group("output")
    o.add_argument("-T", "--tmp-dir", default="pantax_db_tmp")
    o.add_argument("-o", "--output", dest="pantax_output", default=None,
                   help="output file prefix")
    o.add_argument("-R", "--report", dest="pantax_report", default=None,
                   help="reads classification output file")
    o.add_argument("-n", "--next", action="store_true", dest="next_for_strain",
                   help="keep tmp dir for a later --strain run")
    o.add_argument("--force", action="store_true")
    o.add_argument("--debug", action="store_true")
    o.add_argument("-v", "--verbose", action="store_true")
    o.add_argument("--log-dir", default=None, help="also write a log file here")
    o.add_argument("--log_m", default=None, help="log file name discriminant")
    o.add_argument("--trace-dir", default=None,
                   help="write a jax.profiler trace of the alignment stage "
                        "(alignment+coverage with --fastpath)")
    return p


def main(argv: list[str] | None = None) -> int:
    try:
        return _main(argv)
    except FileNotFoundError as e:
        print(f"pantax-tpu: file not found: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"pantax-tpu: {e}", file=sys.stderr)
        return 1


def _main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.batch_size is None:
        args.batch_size = 16384 if args.long_read else 65536
    from .utils import enable_compilation_cache
    from .utils.logging import device_trace, setup_logging, stage_timer

    enable_compilation_cache()
    setup_logging(args.log_dir, args.log_m, args.verbose)
    t0 = time.time()

    import jax

    from .parallel import auto_mesh

    if args.distributed:
        if args.reads and not args.fastpath:
            # The per-species GAF flow has no process sharding: every
            # process would redo the whole alignment and race on the same
            # output files.  Fail fast BEFORE the fleet initializes instead
            # of silently wasting it (the sharded flows are --fastpath).
            log.error("--distributed requires --fastpath (the per-species "
                      "GAF flow is single-process; rerun with --fastpath "
                      "or drop --distributed)")
            return 2
        from .parallel.distributed import init_distributed

        coord, n_proc, proc_id = args.distributed.rsplit(",", 2)
        init_distributed(coord, int(n_proc), int(proc_id))
        log.info("distributed runtime: process %s of %s, %d global devices",
                 proc_id, n_proc, len(jax.devices()))
    log.info("backend %s: %d x %s", jax.default_backend(),
             len(jax.devices()), jax.devices()[0].device_kind)
    mesh = auto_mesh(args.mesh)
    if mesh is not None:
        log.info("device mesh: %d devices, read batches sharded over them",
                 mesh.devices.size)

    from .db.construct import DatabasePaths, build_database, load_database

    db_path = Path(args.db)
    if args.genomes_info:
        genomes_info = args.genomes_info
        if args.fast_query and args.reads:
            # --fast: pre-screen genomes against the read sample
            # (construct.rs:22-63 semantics via containment sketches)
            from .db.sketch import fast_query_filter, sketch_genomes
            from .io.metadata import read_genomes_info, write_genomes_info

            infos = read_genomes_info(genomes_info)
            base = args.base_dir or os.getcwd()
            sketches = sketch_genomes(
                infos, base, cache_dir=args.syldb or str(db_path) + "_sketches"
            )
            kept_ids = set(
                fast_query_filter(args.reads, sketches, min_ani=args.ani)
            )
            kept = [gi for gi in infos if gi.genome_id in kept_ids]
            log.info("--fast: kept %d/%d genomes at ANI >= %.1f",
                     len(kept), len(infos), args.ani)
            if not kept:
                log.error("--fast removed every genome; lower --ani")
                return 1
            db_path = Path(str(db_path) + "_fast")
            db_path.mkdir(parents=True, exist_ok=True)
            genomes_info = db_path / "genomes_info_fast_input.txt"
            write_genomes_info(genomes_info, kept)
            if args.query_and_filter:
                # --qt: screen only, no build (main.rs:208-210,
                # construct.rs:22-63 fast_query_and_filter)
                log.info("--qt: filtered genomes_info at %s", genomes_info)
                return 0
        db = build_database(
            genomes_info, db_path, threads=args.threads,
            force=args.force and not DatabasePaths(db_path).is_complete(),
            base_dir=args.base_dir, gfa_dir=args.gfa_dir,
        )
    else:
        db = load_database(db_path)
    if args.export_gfa:
        db.export_gfa(args.export_gfa)
        log.info("combined GFA written to %s", args.export_gfa)
        return 0
    if args.create:
        log.info("database ready at %s (%.1fs)", db.root, time.time() - t0)
        return 0

    from .align.index import build_align_index

    index = build_align_index(db)
    log.info("alignment index: %d seeds over %d bases", index.num_seeds, index.text_len)
    if args.index:
        if args.warm_kernels:
            # pre-compile the device graphs into the persistent cache so the
            # first query run pays no compile — the compiled executable is
            # part of the index (the giraffe .gbz/.dist/.min role,
            # index.rs:8-159)
            import numpy as np

            from .align.aligner import Aligner
            from .config import AlignConfig
            from .ops.fused import build_fused_tables, fused_alignment_coverage

            aligner = Aligner(index, cfg=AlignConfig.for_read_type(
                "long" if args.long_read else "short"))
            B = args.batch_size
            # an N-heavy batch (all bases = 4 within read lengths) exceeds
            # the 2-bit wire's exception cap, so feeding one warms the 4-bit
            # fallback graph too — otherwise the first quality-masked FASTQ
            # chunk crossing the cap mid-run pays a surprise full compile
            # (the two wires are different arg pytrees -> separate graphs)
            if args.long_read:
                # the long-read chunk graphs are the slowest compiles
                # (~4x the 160bp graph); warm the preset chunk shape plus
                # the rescue extension kernel
                from .align.long_read import LONG_READ_PRESETS

                chunk = LONG_READ_PRESETS[args.long_read_type]
                with stage_timer(f"kernel warmup (long-read {chunk}bp)"):
                    zc = np.full((B, chunk), 4, dtype=np.int8)
                    zl = np.zeros(B, dtype=np.int64)
                    zl_n = np.full(B, chunk, dtype=np.int64)  # 4-bit wire
                    aligner.align_codes(zc, zl)
                    aligner.align_codes(zc, zl_n)
                    Aligner.collect(aligner.dispatch_extend(
                        zc, zl, np.zeros(B, np.int64), np.zeros(B, np.int8)
                    ))
                    Aligner.collect(aligner.dispatch_extend(
                        zc, zl_n, np.zeros(B, np.int64), np.zeros(B, np.int8)
                    ))
                # the production wire is the device-resident group buffer;
                # its ROW COUNT is a jit shape, so warm the two quantized
                # families real runs hit: the upload-pipelined sub-group
                # size and the minimum quantum (small runs)
                from .align.long_read import (
                    _DEFAULT_UPLOAD_ROWS, _UPLOAD_ROWS_ENV,
                )

                sub_rows = int(os.environ.get(_UPLOAD_ROWS_ENV,
                                              _DEFAULT_UPLOAD_ROWS))
                for rows_min in {Aligner._GRP_ROW_QUANTUM, sub_rows}:
                    with stage_timer(
                        f"kernel warmup (group buffer, {rows_min} rows)"
                    ):
                        grp = aligner.put_read_group(
                            [np.zeros(chunk, np.int8)], chunk,
                            rows_min=rows_min,
                        )
                        if grp is None:
                            continue
                        zb = np.zeros(B, dtype=np.int64)
                        Aligner.collect(
                            aligner.dispatch_codes_buf(grp, zb, zl_n))
                        Aligner.collect(aligner.dispatch_extend_buf(
                            grp, zb, zl_n, np.zeros(B, np.int64),
                            np.zeros(B, np.int8),
                        ))
            else:
                with stage_timer("kernel warmup (query + fused graphs)"):
                    zc = np.full((B, 160), 4, dtype=np.int8)
                    zl = np.zeros(B, dtype=np.int64)
                    zl_n = np.full(B, 160, dtype=np.int64)  # 4-bit wire
                    aligner.align_codes(zc, zl)
                    aligner.align_codes(zc, zl_n)
                    tables = build_fused_tables(db, index)
                    fused_alignment_coverage(aligner, zc, zl, tables, B)
                    fused_alignment_coverage(aligner, zc, zl_n, tables, B)
                with stage_timer("kernel warmup (device profile tail)"):
                    # the batched device-PAO graphs are the slowest tail
                    # compiles (~17 min at 102 species in busy windows) and
                    # their shapes are fixed by the DB's species/path
                    # geometry — warm them with a synthetic uniform
                    # coverage that passes every strain through the first
                    # filter so every bucket's solve compiles now
                    import jax.numpy as jnp

                    from .config import ProfilingConfig
                    from .ops.fused import FusedResult, _device_tail_solve

                    fake = FusedResult(
                        jnp.ones(tables.N_pad, jnp.float32),
                        jnp.ones(tables.U_pad, jnp.float32),
                        jnp.ones(tables.N_pad, jnp.int32),
                        {"aligned": np.ones(1, bool)}, 0,
                    )
                    _device_tail_solve(
                        tables, ProfilingConfig.for_read_type("short"),
                        list(tables.species), fake,
                    )
        return 0

    if not args.reads:
        log.error("no reads given (-r) and not --create/--index")
        return 2
    if not (args.short_read or args.long_read):
        log.error("specify read type: -s (short) or -l (long)")
        return 2
    if not (args.species or args.strain):
        args.species = args.strain = True

    tmp = Path(args.tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)
    gaf_file = tmp / "gfa_mapped.gaf"

    if args.fastpath and args.short_read:
        return _run_fastpath(args, db, index, tmp, t0)
    if args.fastpath and args.long_read:
        return _run_fastpath_long(args, db, index, tmp, t0)

    from .io.gaf import filter_best_long_read_alignments, read_gaf, write_gaf

    if gaf_file.exists() and not args.force:
        log.info("- Alignment exists (%s), skipping...", gaf_file)
        gaf = read_gaf(gaf_file)
    else:
        from .align.aligner import Aligner
        from .config import AlignConfig

        aligner = Aligner(index, cfg=AlignConfig.for_read_type(
            "long" if args.long_read else "short"))
        with stage_timer("alignment"), device_trace(args.trace_dir):
            if args.short_read:
                gaf = []
                if args.paired and len(args.reads) == 2:
                    gaf = aligner.align_paired_files(
                        args.reads[0], args.reads[1], batch_size=args.batch_size
                    )
                elif args.paired and len(args.reads) == 1:
                    gaf = aligner.align_paired_files(
                        args.reads[0], None, batch_size=args.batch_size
                    )
                else:
                    for rf in args.reads:
                        gaf.extend(aligner.align_file(rf, batch_size=args.batch_size))
            else:
                from .align.long_read import (
                    LONG_READ_PRESETS, LONG_READ_SEED_STRIDE,
                    align_long_reads, iter_read_groups,
                )

                # streamed in bounded read groups (GraphAligner streams from
                # disk, alignment.rs:144-165); per-group alignment is exact
                # because chunk merging is per read
                chunk = LONG_READ_PRESETS[args.long_read_type]
                gaf = []
                for group in iter_read_groups(args.reads):
                    gaf.extend(align_long_reads(
                        aligner, group, chunk=chunk,
                        batch_size=args.batch_size,
                        seed_stride=LONG_READ_SEED_STRIDE[args.long_read_type],
                    ))
                gaf = filter_best_long_read_alignments(gaf)
        write_gaf(gaf_file, gaf)
        log.info("- Aligned %d reads", len(gaf))

    from .pipeline import profile_from_gaf

    read_type = "short" if args.short_read else "long"
    cfg = _profiling_config(args, db, tmp, read_type,
                            species=args.species, strain=args.strain)
    with stage_timer("profiling"):
        profile_from_gaf(gaf, db, cfg, tmp, force=args.force)

    return _emit_outputs(args, tmp, args.species, args.strain, t0)


def _profiling_config(args, db, tmp: Path, read_type: str, *,
                      species: bool, strain: bool):
    """Shared ProfilingConfig construction for the GAF and fastpath flows.

    Resolves the data-dependent defaults exactly once so both paths agree:
    fr = 0.3 short / 0.5 long when unset (explicit --fr 0.0 is honored), and
    the reference's shift quirk — shift on iff the range file is empty —
    unless --shift overrides (main.rs:107-124 parity).
    """
    from .config import ProfilingConfig

    fr = args.unique_trio_nodes_fraction
    if fr is None:
        fr = 0.3 if read_type == "short" else 0.5
    if args.shift is not None:
        shift = args.shift == "true"
    else:
        shift = not any(True for _ in open(db.range_file))
    return ProfilingConfig(
        db=db.root,
        wd=tmp,
        min_species_abundance=args.min_species_abundance,
        unique_trio_nodes_fraction=fr,
        unique_trio_nodes_mean_count_f=args.unique_trio_nodes_count,
        single_cov_ratio=args.single_cov_ratio,
        single_cov_diff=args.single_cov_diff,
        min_cov=args.min_cov,
        min_depth=args.min_depth,
        species=species,
        strain=strain,
        filtered=not args.no_filter,
        sample_nodes=args.sample_nodes,
        sample_test=args.sample_test,
        designated_species=(
            [s.strip() for s in args.designated_species.split(",") if s.strip()]
            if args.designated_species else None
        ),
        mode=args.smode,
        solver=args.solver,
        coverage=args.coverage,
        tail=args.tail,
        shift=shift,
        read_type=read_type,
    )


def _codes_matrix(codes_flat, offsets, pad):
    import numpy as np

    lens = np.diff(offsets)
    codes = np.full((len(lens), pad), 4, dtype=np.int8)
    # codes_flat is the row-order concatenation, so one boolean-mask
    # assignment replaces the per-read Python loop (~50ms per 65536 reads)
    mask = np.arange(pad)[None, :] < lens[:, None]
    codes[mask] = codes_flat[: int(lens.sum())]
    return codes, lens.astype(np.int64)


def _run_fastpath_long(args, db, index, tmp: Path, t0: float) -> int:
    """Array-native long-read flow: chunked alignment -> merged per-read
    intervals -> FUSED interval profiling (the same global accumulators +
    device tail as short reads; ops/fused.feed_intervals).  Filter
    thresholds from gaf_filter.rs:44-97 are applied inside
    align_long_reads."""
    import jax

    from .align.aligner import Aligner
    from .align.long_read import (
        LONG_READ_PRESETS, LONG_READ_SEED_STRIDE, align_long_reads,
        iter_read_groups,
    )
    from .ops.fused import (
        FusedPipeline, FusedResult, build_fused_tables,
        profile_from_fused_result,
    )
    from .config import AlignConfig
    from .utils.logging import device_trace, stage_timer

    n_proc = jax.process_count()
    dist = n_proc > 1
    aligner = Aligner(index, cfg=AlignConfig.for_read_type("long"))
    tables = build_fused_tables(db, index)
    pipe = FusedPipeline(aligner, tables, batch=args.batch_size)
    n_aligned = 0
    # streamed: each bounded read group is aligned (chunked blockwise DP)
    # and its merged per-read intervals fed straight into the incremental
    # fused accumulators — host RAM never holds the whole input
    # (GraphAligner's streaming role, alignment.rs:144-165).
    # Multi-host (--distributed): read GROUPS round-robin across processes
    # (a byte-range shard would split reads mid-record for multi-line
    # FASTA; the bounded groups are already the work quantum), coverage
    # accumulators psum-merged before finalize, per-read columns gathered
    # in process order, process 0 writes — same pattern as the short-read
    # fused fastpath below.
    from .align.long_read import _GROUP_BASES_ENV, DEFAULT_GROUP_BASES

    env_gb = os.environ.get(_GROUP_BASES_ENV)
    if env_gb is not None:
        group_bases = int(env_gb)  # explicit override wins verbatim
    else:
        # finer quanta so the round-robin split engages even when the whole
        # input fits one default-size group (floor keeps per-group fixed
        # costs amortized)
        group_bases = DEFAULT_GROUP_BASES
        if dist:
            group_bases = max(group_bases // n_proc, 64 << 20)
    with (stage_timer("long-read alignment+coverage (fastpath)"),
          device_trace(args.trace_dir)):
        for gi, group in enumerate(
            iter_read_groups(args.reads, group_bases=group_bases)
        ):
            if dist and gi % n_proc != jax.process_index():
                continue
            merged = align_long_reads(
                aligner, group, chunk=LONG_READ_PRESETS[args.long_read_type],
                batch_size=args.batch_size,
                seed_stride=LONG_READ_SEED_STRIDE[args.long_read_type],
                as_arrays=True,
            )
            pipe.feed_intervals(
                merged.ts, merged.te, merged.mapq, merged.read_len,
                ids=merged.read_ids,
            )
            n_aligned += len(merged.read_ids)

    cfg = _profiling_config(args, db, tmp, "long",
                            species=True,
                            strain=args.strain or not args.species)
    with stage_timer("profiling (fused intervals)"):
        if dist:
            from .parallel.distributed import (
                cross_process_sum, gather_read_rows,
            )

            result = pipe.finish(process_reduce=cross_process_sum)
            with stage_timer("cross-process read-column gather"):
                reads_g = gather_read_rows(result.reads)
            result = FusedResult(result.na_d, result.ta_d, result.bc_d,
                                 reads_g, result.n_overflow)
            if jax.process_index() != 0:
                log.info(
                    "- process %d: %d reads aligned in shard, merged; "
                    "process 0 writes outputs (%.1fs)",
                    jax.process_index(), n_aligned, time.time() - t0,
                )
                return 0
            log.info("- Aligned %d reads", len(reads_g["mapq"]))
            profile_from_fused_result(result, tables, index, db, cfg, tmp)
        else:
            log.info("- Aligned %d reads", n_aligned)
            result = pipe.finish()
            profile_from_fused_result(result, tables, index, db, cfg, tmp)

    return _emit_outputs(args, tmp, True, cfg.strain, t0)


def _run_fastpath(args, db, index, tmp: Path, t0: float) -> int:
    """Array-native short-read flow: parse -> align -> profile, no GAF text.
    Input streams in record-aligned buffers (bounded memory); the alignment
    arrays are checkpointed to <tmp>/alignment_arrays.npz for resume."""
    import numpy as np

    from .align.aligner import Aligner
    from .fastpath import AlignmentArrays, profile_from_alignments
    from .utils.logging import stage_timer
    from .utils.native import load_native

    arrays_file = tmp / "alignment_arrays.npz"
    if arrays_file.exists() and not args.force:
        log.info("- Alignment exists (%s), skipping...", arrays_file)
        with np.load(arrays_file) as z:
            merged = AlignmentArrays(
                read_ids=[str(s) for s in z["read_ids"]],
                ts=z["ts"], te=z["te"], mapq=z["mapq"], read_len=z["read_len"],
            )
    else:
        if load_native() is None:
            log.error("--fastpath requires the native parser; rerun without it")
            return 1
        aligner = Aligner(index)
        # fused flow: align+classify+coverage in one device program per
        # batch (ops/fused.py; paired mode uses the joint fragment-model
        # step); the resume artifact and all outputs are identical to the
        # per-species flow (tests/test_fused.py)
        return _run_fastpath_fused(args, db, index, aligner, tmp, t0,
                                   arrays_file)
    log.info("- Aligned %d reads", len(merged.read_ids))

    cfg = _profiling_config(args, db, tmp, "short",
                            species=True,
                            strain=args.strain or not args.species)
    with stage_timer("profiling"):
        profile_from_alignments(merged, index, db, cfg, tmp)

    return _emit_outputs(args, tmp, True, cfg.strain, t0)


def _run_fastpath_fused(args, db, index, aligner, tmp: Path, t0: float,
                        arrays_file: Path) -> int:
    """Streaming fused flow: parse buffers -> fused align+coverage steps ->
    per-species-slice profiling.  Writes the same alignment_arrays.npz resume
    artifact as the per-species flow.

    Multi-host (--distributed, jax.process_count() > 1): each process feeds
    only its record-aligned byte-range shard of the shared read file
    (io/fastx.shard_fastx_buffers), the coverage accumulators are summed
    across processes on device before finalize, the per-read columns are
    all-gathered in process (= file) order, and process 0 writes the outputs
    — byte-identical to a single-process run (tests/test_distributed.py)."""
    import numpy as np

    import jax

    from .align.aligner import _round_up
    from .io.fastx import shard_fastx_buffers, stream_fastx_buffers
    from .ops.fused import (
        FusedPipeline, FusedResult, build_fused_tables,
        profile_from_fused_result,
    )
    from .utils.logging import device_trace, stage_timer
    from .utils.native import fastx_parse_native

    n_proc = jax.process_count()
    dist = n_proc > 1
    tables = build_fused_tables(db, index)
    # prefetch_spans: the resume artifact below always writes ts/te, so
    # stream them to host during the align loop like the other columns.
    # Distributed runs skip the artifact (per-process shards don't compose
    # a meaningful single resume file) and keep intervals device-resident.
    pipe = FusedPipeline(aligner, tables, batch=args.batch_size,
                         prefetch_spans=not dist)

    def parse(rf, buf):
        parsed = fastx_parse_native(buf)
        if parsed is None:
            raise ValueError(f"{rf}: unparseable FASTA/FASTQ chunk")
        return parsed

    # stream granularity: also the paired round-robin shard granularity
    # (overridable for tests that need several chunks from a small file)
    chunk_bytes = int(os.environ.get("PANTAX_TPU_CHUNK_BYTES", 64 << 20))

    def buffers(rf):
        if dist:
            return shard_fastx_buffers(rf, jax.process_index(), n_proc,
                                       chunk_bytes=chunk_bytes)
        return stream_fastx_buffers(rf, chunk_bytes)

    with (stage_timer("alignment+coverage (fused)"),
          device_trace(args.trace_dir)):
        if args.paired and len(args.reads) in (1, 2):
            from .io.fastx import stream_paired_parsed

            r1 = args.reads[0]
            r2 = args.reads[1] if len(args.reads) == 2 else None
            # paired shards are chunk-round-robin (byte ranges of the two
            # mate files — or of one interleaved file, whose odd-record
            # carry must be tracked across ALL chunks — would desynchronize
            # pairs); classification rows then appear in shard order,
            # species/strain tables unchanged.  r2=None is the reference's
            # interleaved ShortReadPairedInter mode (types.rs:34-48): mates
            # are adjacent records, de-interleaved by the shared streamer
            # and fed through the SAME joint fragment-model step as two-file
            # mode.
            for ci, block in enumerate(
                stream_paired_parsed(r1, r2, parse, chunk_bytes)
            ):
                if dist and ci % n_proc != jax.process_index():
                    continue
                cf1, of1, ids1, cf2, of2, ids2 = block
                if len(ids1) == 0:
                    continue
                pad = _round_up(int(max(np.diff(of1).max(),
                                        np.diff(of2).max())))
                c1, l1 = _codes_matrix(cf1, of1, pad)
                c2, l2 = _codes_matrix(cf2, of2, pad)
                pipe.feed_paired(c1, l1, c2, l2, ids1=ids1, ids2=ids2)
        else:
            for rf in args.reads:
                for buf in buffers(rf):
                    codes_flat, offsets, ids = parse(rf, buf)
                    if len(ids) == 0:
                        continue
                    pad = _round_up(int(np.diff(offsets).max()))
                    codes, lens = _codes_matrix(codes_flat, offsets, pad)
                    pipe.feed(codes, lens, ids=ids)
        if dist:
            from .parallel.distributed import cross_process_sum

            result = pipe.finish(process_reduce=cross_process_sum)
        else:
            result = pipe.finish()

    if dist:
        from .parallel.distributed import gather_read_rows

        with stage_timer("cross-process read-column gather"):
            reads_g = gather_read_rows(result.reads)
        result = FusedResult(result.na_d, result.ta_d, result.bc_d,
                             reads_g, result.n_overflow)
        if jax.process_index() != 0:
            log.info("- process %d: shard aligned, merged; process 0 writes "
                     "outputs (%.1fs)", jax.process_index(), time.time() - t0)
            return 0

    reads = result[3]
    keep_rows = np.flatnonzero(reads["aligned"])
    ids = reads["ids"]
    if not dist:
        read_ids = (np.asarray(ids, dtype=np.str_)[keep_rows]
                    if ids is not None
                    else np.char.add("R", keep_rows.astype(np.str_)))
        np.savez(
            arrays_file,
            read_ids=np.asarray(read_ids, dtype=np.str_),
            ts=reads["ts"][keep_rows].astype(np.int64),
            te=reads["te"][keep_rows].astype(np.int64),
            mapq=reads["mapq"][keep_rows].astype(np.int64),
            read_len=reads["read_len"][keep_rows].astype(np.int64),
        )
    log.info("- Aligned %d reads", len(keep_rows))

    cfg = _profiling_config(args, db, tmp, "short",
                            species=True,
                            strain=args.strain or not args.species)
    with stage_timer("profiling"):
        profile_from_fused_result(result, tables, index, db, cfg, tmp)

    return _emit_outputs(args, tmp, True, cfg.strain, t0)


def _emit_outputs(args, tmp, species: bool, strain: bool, t0: float) -> int:
    """Move result tables out of the tmp dir (handle_res parity,
    main.rs:60-100) and clean up."""
    prefix = f"{args.pantax_output}_" if args.pantax_output else ""
    if species:
        _copy(tmp / "species_abundance.txt",
              Path(f"{prefix}species_abundance.txt"))
    if strain:
        _copy(tmp / "strain_abundance.txt",
              Path(f"{prefix}strains_abundance.txt" if prefix
                   else "strain_abundance.txt"))
    if args.pantax_report:
        _copy(tmp / "reads_classification.tsv", Path(args.pantax_report))
    if not args.next_for_strain and not args.debug:
        shutil.rmtree(tmp, ignore_errors=True)
    log.info("- Done in %.1fs", time.time() - t0)
    return 0


def _copy(src: Path, dst: Path) -> None:
    if src.exists() and src.resolve() != dst.resolve():
        shutil.copy(src, dst)


if __name__ == "__main__":
    sys.exit(main())
