#!/usr/bin/env python
"""Benchmark the dup-graph (windowed-scatter) path at scale-1-like size.

Every benchmark DB so far is dup-free (chunked / anchor-partition graphs), so
all recorded figures ride the range-decomposition fast scatter.  The
reference's primary production case is pggb graphs
(/root/reference/pantax/src/task_scheduling.rs:404-427), whose haplotypes DO
revisit nodes; those route to the windowed classify+scatter + L_cap/overflow
machinery (ops/fused._decide_ranges -> False).  This tool synthesizes a
10-species x 3-strain community whose GFA paths revisit a repeat node every
REPEAT_EVERY segments (well inside the 64-segment dup window), imports it via
the --gfa-dir path, verifies tables.has_dups, and records align steady +
e2e at 1M reads.

Usage: python tools/dup_bench.py [n_reads]
Prints one JSON line.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pantax_tpu.utils import enable_compilation_cache

enable_compilation_cache()

import numpy as np

N_SPECIES = 10
STRAINS = 3
BLOCK = 64                # pangenome node size (graph.pangenome DEFAULT_PAN_CHUNK)
N_BLOCKS = 15625          # ~1MB per haplotype
REPEAT_EVERY = 8          # repeat node recurs every 8 segments (dup window)
SNP_RATE = 0.01           # per-base strain SNPs (scale_db parity)


def synth_species(root, gfa_dir, sp: int, rng) -> list:
    """One species' GFA (+ per-strain FASTAs); returns GenomeInfo rows.

    Mirrors the anchor-partition structure at the same node scale (64bp
    nodes; a strain block with >=1 SNP becomes a private node, SNP-free
    blocks share the ref node) while adding the dup property: one SHARED
    repeat node recurs every REPEAT_EVERY path steps in every haplotype."""
    from pantax_tpu.io.fastx import write_fasta
    from pantax_tpu.io.metadata import GenomeInfo

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    repeat_seq = bases[rng.integers(0, 4, size=BLOCK)].tobytes()
    pos_is_rep = (np.arange(N_BLOCKS) % REPEAT_EVERY) == (REPEAT_EVERY - 1)
    nonrep = np.flatnonzero(~pos_is_rep)
    ref_blocks = {int(i): bases[rng.integers(0, 4, size=BLOCK)]
                  for i in nonrep}

    node_seqs: list[bytes] = [repeat_seq]
    rep_node = 0
    ref_node_of: dict[int, int] = {}
    paths = {}
    infos = []
    for st in range(STRAINS):
        var_node_of = {}
        for i in sorted(ref_blocks):
            m = rng.random(BLOCK) < SNP_RATE
            if not m.any():
                # SNP-free block: share the ref node (created on demand)
                if i not in ref_node_of:
                    ref_node_of[i] = len(node_seqs)
                    node_seqs.append(ref_blocks[i].tobytes())
                continue
            blk = ref_blocks[i].copy()
            blk[m] = bases[rng.integers(0, 4, size=int(m.sum()))]
            var_node_of[i] = len(node_seqs)
            node_seqs.append(blk.tobytes())
        path = [
            rep_node if pos_is_rep[i]
            else var_node_of.get(i, ref_node_of.get(i, rep_node))
            for i in range(N_BLOCKS)
        ]
        hap = f"GCF_{900 + sp}{chr(97 + st)}.1_x"
        paths[hap] = path
        fa = f"{hap}_genomic.fna"
        write_fasta(root / fa,
                    [(f"c{sp}{st}", b"".join(node_seqs[n] for n in path))])
        infos.append(GenomeInfo(hap, f"{900 + sp}.{st + 1}", str(900 + sp),
                                "synthetic-dup", fa))

    with open(os.path.join(gfa_dir, f"{900 + sp}.gfa"), "wb") as f:
        f.write(b"H\tVN:Z:1.1\n")
        for ni, seq in enumerate(node_seqs):
            f.write(b"S\t%d\t%s\n" % (ni + 1, seq))
        for hap, path in paths.items():
            walk = b"".join(b">%d" % (n + 1) for n in path)
            span = len(path) * BLOCK
            f.write(b"W\t%s\t0\tmerged\t0\t%d\t%s\n"
                    % (hap.encode(), span, walk))
    return infos


def dup_db(path: str):
    from pathlib import Path

    from pantax_tpu.db.construct import build_database, load_database
    from pantax_tpu.io.metadata import write_genomes_info

    root = Path(path)
    if (root / "db" / "species_range.txt").exists():
        return load_database(root / "db")
    root.mkdir(parents=True, exist_ok=True)
    gfa_dir = root / "gfa"
    gfa_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(11)
    infos = []
    for sp in range(N_SPECIES):
        infos.extend(synth_species(root, gfa_dir, sp, rng))
    info_file = root / "genomes_info.txt"
    write_genomes_info(info_file, infos)
    return build_database(info_file, root / "db", base_dir=root,
                          gfa_dir=gfa_dir)


def main() -> None:
    from pantax_tpu.align.index import build_align_index
    from pantax_tpu.benchmarks import (
        run_alignment_benchmark, run_e2e_benchmark,
    )
    from pantax_tpu.ops.fused import build_fused_tables
    from pantax_tpu.utils.logging import setup_logging

    setup_logging()
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    db = dup_db(os.environ.get("PANTAX_TPU_DUP_DIR", "/tmp/pantax_tpu_dup"))
    index = build_align_index(db)
    tables = build_fused_tables(db, index)
    batch = int(os.environ.get("PANTAX_TPU_BENCH_BATCH", 65536))
    stats = run_alignment_benchmark(db, n_reads=n_reads, batch=batch)
    e2e = run_e2e_benchmark(db, n_reads=n_reads, batch=batch,
                            out_dir="/tmp/pantax_tpu_dup_e2e")
    print(json.dumps({
        "db": "dup-graph (windowed scatter path)",
        "has_dups": bool(tables.has_dups),
        "n_reads": n_reads,
        "align_steady_reads_per_s": round(stats["reads_per_s"], 1),
        "aligned_frac": round(stats["aligned_frac"], 4),
        "species_acc": round(stats["species_acc"], 4),
        "e2e_wall_s": round(e2e["wall_s"], 2),
        "e2e_reads_per_s": round(e2e["e2e_reads_per_s"], 1),
        "align_s": round(e2e["align_s"], 2),
        "profile_s": round(e2e["profile_s"], 2),
        "strains_detected": e2e["strains_detected"],
    }))


if __name__ == "__main__":
    main()
