#!/usr/bin/env python3
"""End-to-end smoke run of the profiler on NVIDIA GPUs.

    python chip_smoke.py          # phases 1-5 on one card
    python chip_smoke.py --four   # only the four-card mesh phase

Set-up builds the in-repo synthetic community (``benchmarks.scale_db``:
10 species x 3 strains x 1 Mb genomes, 1% SNPs, seed 7) and its alignment
index under ``.smoke/`` in the checkout, and writes seeded FASTQ samples
with the staggered 1:3:9 strain weights of ``benchmarks.accuracy_benchmark``:
1,000,000 x 150 bp short reads (``simulate_read_batch``) and 2,000 x 8 kb
HiFi-like long reads (``simulate_long_reads``).  Every phase then drives the
``pantax-tpu`` command line (``pantax_tpu.cli.main``) in this process:

 1. short fastpath (``--fastpath``): 30/30 strains, species accuracy
    >= 0.99, strain-abundance L1 against the design <= 0.1;
 2. default GAF flow on the first 200,000 reads: the same strain set as the
    fastpath on those reads;
 3. long fastpath (``-l --long-read-type hifi``): aligned fraction >= 0.99;
 4. device profile tail against the host oracles (``--tail host --coverage
    host --solver highs``) on the 200,000-read sample: identical species
    table and strain set, strain abundances within 1e-3 (the ADMM is run to
    a float32 residual and polished; the host LP is exact in float64, and the
    float32 tail reductions differ from it by less than 1e-3 of abundance);
 5. the aligner on the GPU against the same aligner on the CPU backend, on
    65,536 reads: every output column bit-identical (the DP is int32).

``--four`` runs phase 1's sample with ``--mesh 4`` and ``--mesh off`` and
checks that the four output tables are byte-identical and that all four
cards held memory.

Any failed check raises, so the exit code is non-zero and no result line is
printed.  The script stops with a non-zero exit, before any phase, when JAX
finds no GPU.  The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
where ``count`` is the number of GPUs the phases used (1, or 4 with
``--four``).

A cold run (no compiled graph cached, database built from scratch) took 246 s
on one NVIDIA H100 80GB HBM3 at a 400 W power limit: 73 s database build,
8 s index, 20 s compiling phase 1's graphs, 70 s in phase 4's host oracle.
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
_CACHE_HIT_EVENT = "/jax/compilation_cache/cache_hits"


GENOME_LEN = 1_000_000   # bases per strain genome
N_SHORT = 1_000_000      # 150 bp short reads (phases 1, four-card)
N_SUB = 200_000          # first short reads for phases 2 and 4
N_LONG = 2_000           # HiFi-like long reads (phase 3)
LONG_LEN = 8192
N_CMP = 65_536           # reads aligned on GPU and CPU (phase 5)
STRAIN_WEIGHTS = (1.0, 3.0, 9.0)  # per strain within each species


class JaxCompileMeter:
    """Backend compile seconds (persistent-cache loads included) and cache
    hits, from JAX's monitoring events."""

    def __init__(self):
        import jax

        self.compile_s = 0.0
        self.cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)

    def _duration(self, event, secs, **_):
        if event == _COMPILE_EVENT:
            self.compile_s += secs

    def _event(self, event, **_):
        if event == _CACHE_HIT_EVENT:
            self.cache_hits += 1

    def snapshot(self) -> tuple[float, int]:
        return self.compile_s, self.cache_hits


class LogCapture(logging.Handler):
    """Keeps the pantax_tpu log messages of the current phase."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list[str] = []
        logging.getLogger("pantax_tpu").addHandler(self)

    def emit(self, record):
        self.messages.append(record.getMessage())

    def take(self) -> list[str]:
        out, self.messages = self.messages, []
        return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def gpu_gate() -> None:
    """Exit before any device work unless JAX's default backend is a GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: JAX default backend is {backend!r}, not 'gpu'; "
                 "this smoke run needs an NVIDIA GPU")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
_BASES = b"ACGTN"


def _write_fastq(path: Path, ids: list[str], codes, lens) -> None:
    import numpy as np

    lut = np.frombuffer(_BASES, dtype=np.uint8)
    seqs = lut[np.clip(codes, 0, 4)]
    with open(path, "wb") as f:
        for rid, row, n in zip(ids, seqs, lens):
            s = row[:n].tobytes()
            f.write(b"@%s\n%s\n+\n%s\n" % (rid.encode(), s, b"I" * n))


@dataclass
class Sample:
    db: object
    index: object
    short_fq: Path
    sub_fq: Path
    long_fq: Path
    short_truth_species: dict  # read id -> species taxid
    weights: object            # [H] design weight per haplotype
    codes: object              # first n_cmp short reads (phase 5)
    lens: object


def build_sample(work: Path) -> Sample:
    import numpy as np

    from pantax_tpu.align.index import build_align_index
    from pantax_tpu.benchmarks import (
        scale_db, simulate_long_reads, simulate_read_batch,
    )

    t0 = time.time()
    db = scale_db(str(work / f"db_g{GENOME_LEN}"),
                  genome_len=GENOME_LEN, seed=7)
    t_db = time.time() - t0
    t0 = time.time()
    index = build_align_index(db)
    t_index = time.time() - t0
    H = len(index.hap_names)
    weights = np.array([STRAIN_WEIGHTS[h % 3] for h in range(H)])

    codes, lens, hap = simulate_read_batch(
        index, N_SHORT, 150, 0.01, seed=11, hap_weights=weights)
    ids = [f"s{i}" for i in range(N_SHORT)]
    truth = {rid: index.hap_species[h] for rid, h in zip(ids, hap)}
    short_fq = work / f"short_{N_SHORT}.fq"
    sub_fq = work / f"short_{N_SUB}.fq"
    t0 = time.time()
    _write_fastq(short_fq, ids, codes, lens)
    _write_fastq(sub_fq, ids[:N_SUB], codes[:N_SUB],
                 lens[:N_SUB])
    long_reads, _ = simulate_long_reads(
        index, N_LONG, LONG_LEN, seed=13, hap_weights=weights)
    long_fq = work / f"long_{N_LONG}.fq"
    with open(long_fq, "wb") as f:
        for rid, seq in long_reads:
            f.write(b"@%s\n%s\n+\n%s\n" % (rid.encode(), seq, b"I" * len(seq)))
    t_fq = time.time() - t0
    print(f"setup: database {t_db:.1f}s, alignment index {t_index:.1f}s "
          f"({index.num_seeds} seeds over {index.text_len} bases), "
          f"FASTQ {t_fq:.1f}s", flush=True)
    return Sample(db, index, short_fq, sub_fq, long_fq, truth, weights,
                  codes[:N_CMP], lens[:N_CMP])


# ---------------------------------------------------------------------------
# running the CLI and reading its tables
# ---------------------------------------------------------------------------
@dataclass
class Run:
    tables: Path     # directory holding all four output tables
    wall_s: float
    compile_s: float
    cache_hits: int
    log: list


def run_cli(name: str, work: Path, db_root, args: list[str],
            meter: JaxCompileMeter, logs: LogCapture) -> Run:
    from pantax_tpu.cli import main as cli_main

    run_dir = work / "runs" / name
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    argv = ["-d", str(db_root), "-T", str(run_dir / "tmp"), "-n", "--force",
            "-o", str(run_dir / "out"),
            "-R", str(run_dir / "reads_classification.tsv"), *args]
    c0, h0 = meter.snapshot()
    logs.take()
    t0 = time.time()
    rc = cli_main(argv)
    wall = time.time() - t0
    c1, h1 = meter.snapshot()
    check(rc == 0, f"{name}: pantax-tpu {' '.join(args)} exited {rc}")
    return Run(run_dir / "tmp", wall, c1 - c0, h1 - h0, logs.take())


def read_tsv(path: Path, header: bool = True) -> list[dict] | list[list]:
    with open(path, newline="") as f:
        if header:
            return list(csv.DictReader(f, delimiter="\t"))
        return list(csv.reader(f, delimiter="\t"))


def strain_table(run: Run) -> dict[str, float]:
    rows = read_tsv(run.tables / "strain_abundance.txt")
    return {r["genome_ID"]: float(r["predicted_abundance"]) for r in rows}


def tail_mode(run: Run) -> str:
    modes = [m.split(":", 1)[1].strip() for m in run.log
             if m.startswith("- profile tail:")]
    return ",".join(modes) or "host engine (GAF flow)"


def report(phase: str, run: Run, n_reads: int, **figures) -> None:
    steady = n_reads / max(run.wall_s - run.compile_s, 1e-9)
    extra = ", ".join(f"{k} {v}" for k, v in figures.items())
    print(f"{phase}: wall {run.wall_s:.2f}s, compile {run.compile_s:.2f}s "
          f"({run.cache_hits} cache hits), {n_reads / run.wall_s:.0f} reads/s "
          f"({steady:.0f} reads/s without compile), tail {tail_mode(run)}, "
          f"{extra}", flush=True)


def design_l1(sample: Sample, pred: dict[str, float]) -> float:
    """L1 between predicted strain abundances and the design weights (all
    genomes have the same length, so abundance is proportional to weight)."""
    from pantax_tpu.io.metadata import read_genomes_info

    hidx = {n: i for i, n in enumerate(sample.index.hap_names)}
    truth = {gi.genome_id: sample.weights[hidx[gi.hap_id]]
             for gi in read_genomes_info(sample.db.genomes_info_file)}
    tot = sum(truth.values())
    l1 = sum(abs(pred.get(g, 0.0) - w / tot) for g, w in truth.items())
    return l1 + sum(p for g, p in pred.items() if g not in truth)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_short_fastpath(s: Sample, work, meter, logs) -> Run:
    run = run_cli("p1_short_fastpath", work, s.db.root,
                  ["-s", "--fastpath", "--species", "--strain", "--mesh",
                   "off", "-r", str(s.short_fq)], meter, logs)
    strains = strain_table(run)
    rows = read_tsv(run.tables / "reads_classification.tsv", header=False)
    correct = sum(s.short_truth_species[r[0]] == r[2] for r in rows)
    acc = correct / max(len(rows), 1)
    l1 = design_l1(s, strains)
    n_genomes = len(s.index.hap_names)
    report("phase 1 short fastpath", run, N_SHORT,
           strains=f"{len(strains)}/{n_genomes}",
           classified=f"{len(rows) / N_SHORT:.4f}",
           species_accuracy=f"{acc:.5f}", strain_l1=f"{l1:.4f}")
    check(len(strains) == n_genomes, f"{len(strains)}/{n_genomes} strains")
    check(acc >= 0.99, f"species accuracy {acc} >= 0.99")
    check(l1 <= 0.1, f"strain L1 {l1} <= 0.1")
    return run


def phase_gaf_flow(s: Sample, work, meter, logs) -> None:
    gaf = run_cli("p2_gaf_flow", work, s.db.root,
                  ["-s", "--species", "--strain", "--mesh", "off",
                   "-r", str(s.sub_fq)], meter, logs)
    fast = run_cli("p2_fastpath_same_reads", work, s.db.root,
                   ["-s", "--fastpath", "--species", "--strain", "--mesh",
                    "off", "-r", str(s.sub_fq)], meter, logs)
    a, b = strain_table(gaf), strain_table(fast)
    report("phase 2 GAF flow", gaf, N_SUB,
           strains=len(a), fastpath_strains=len(b),
           same_strain_set=set(a) == set(b))
    check(set(a) == set(b), "GAF flow and fastpath report the same strains")


def phase_long_fastpath(s: Sample, work, meter, logs) -> None:
    run = run_cli("p3_long_fastpath", work, s.db.root,
                  ["-l", "--fastpath", "--long-read-type", "hifi",
                   "--species", "--strain", "--mesh", "off",
                   "-r", str(s.long_fq)], meter, logs)
    rows = read_tsv(run.tables / "reads_classification.tsv", header=False)
    aligned = len({r[0] for r in rows}) / N_LONG
    strains = strain_table(run)
    mb = N_LONG * LONG_LEN / 1e6
    report("phase 3 long fastpath", run, N_LONG,
           mb_per_s=f"{mb / run.wall_s:.2f}", aligned=f"{aligned:.4f}",
           strains=f"{len(strains)}/{len(s.index.hap_names)}")
    check(aligned >= 0.99, f"long-read aligned fraction {aligned} >= 0.99")


def phase_tail_oracle(s: Sample, work, meter, logs) -> None:
    base = ["-s", "--fastpath", "--species", "--strain", "--mesh", "off",
            "-r", str(s.sub_fq)]
    dev = run_cli("p4_tail_device", work, s.db.root,
                  base + ["--tail", "device"], meter, logs)
    host = run_cli("p4_tail_host_highs", work, s.db.root,
                   base + ["--tail", "host", "--coverage", "host",
                           "--solver", "highs"], meter, logs)
    check(tail_mode(dev) == "device", f"device tail ran ({tail_mode(dev)})")
    check(tail_mode(host) == "host", f"host tail ran ({tail_mode(host)})")
    same_species = (
        (dev.tables / "species_abundance.txt").read_bytes()
        == (host.tables / "species_abundance.txt").read_bytes())
    a, b = strain_table(dev), strain_table(host)
    diff = max((abs(a[g] - b[g]) for g in a.keys() & b.keys()), default=0.0)
    report("phase 4 device tail", dev, N_SUB)
    report("phase 4 host oracle", host, N_SUB,
           species_identical=same_species, strains=f"{len(a)} vs {len(b)}",
           max_abundance_diff=f"{diff:.3g}")
    check(same_species, "species_abundance.txt identical")
    check(set(a) == set(b), "device and host tails report the same strains")
    check(diff <= 1e-3, f"strain abundance difference {diff} <= 1e-3")


def phase_aligner_cpu(s: Sample) -> None:
    import jax
    import numpy as np

    from pantax_tpu.align.aligner import Aligner

    def align():
        t0 = time.time()
        res = Aligner(s.index).align_codes(s.codes, s.lens)
        return res, time.time() - t0

    gpu, t_gpu = align()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu, t_cpu = align()
    cols = ("text_start", "text_end", "score", "matches", "mapq", "strand",
            "aligned")
    same = {c: bool(np.array_equal(getattr(gpu, c), getattr(cpu, c)))
            for c in cols}
    print(f"phase 5 aligner GPU vs CPU: {N_CMP} reads, GPU {t_gpu:.2f}s "
          f"and CPU {t_cpu:.2f}s (compile included), aligned "
          f"{float(gpu.aligned.mean()):.4f}, identical "
          + ", ".join(f"{c}={v}" for c, v in same.items()), flush=True)
    check(all(same.values()), "GPU aligner output equals the CPU backend's")


def phase_four(s: Sample, work, meter, logs) -> None:
    import jax

    devs = jax.local_devices()
    check(len(devs) >= 4, f"four cards visible ({len(devs)})")
    base = ["-s", "--fastpath", "--species", "--strain",
            "-r", str(s.short_fq)]
    mesh = run_cli("four_mesh4", work, s.db.root, base + ["--mesh", "4"],
                   meter, logs)
    stats = [d.memory_stats() or {} for d in devs[:4]]
    single = run_cli("four_mesh_off", work, s.db.root,
                     base + ["--mesh", "off"], meter, logs)
    wire = ("4-bit" if any("4-bit wire" in m for m in mesh.log)
            else "2-bit")
    names = ("species_abundance.txt", "strain_abundance.txt",
             "ori_strain_abundance.txt", "reads_classification.tsv")
    same = {n: (mesh.tables / n).read_bytes() == (single.tables / n).read_bytes()
            for n in names}
    peak = [st.get("peak_bytes_in_use", 0) for st in stats]
    in_use = [st.get("bytes_in_use", 0) for st in stats]
    report("four-card mesh", mesh, N_SHORT, wire=wire)
    report("one card", single, N_SHORT)
    print(f"four-card check: tables identical {same}; bytes_in_use {in_use}; "
          f"peak_bytes_in_use {peak}", flush=True)
    check(all(same.values()), "mesh and single-card tables byte-identical")
    check(all(p > 0 for p in peak), "all four cards held memory")


def run(work: Path, four: bool = False) -> int:
    """Run the phases; returns the number of GPUs they used."""
    work.mkdir(parents=True, exist_ok=True)
    meter = JaxCompileMeter()
    logs = LogCapture()
    sample = build_sample(work)
    if four:
        phase_four(sample, work, meter, logs)
        return 4
    phase_short_fastpath(sample, work, meter, logs)
    phase_gaf_flow(sample, work, meter, logs)
    phase_long_fastpath(sample, work, meter, logs)
    phase_tail_oracle(sample, work, meter, logs)
    phase_aligner_cpu(sample)
    return 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)
    import jax

    gpu_gate()
    import pantax_tpu

    pkg = Path(pantax_tpu.__file__).resolve().parent
    if pkg.parent != ROOT:
        sys.exit(f"chip_smoke: pantax_tpu imported from {pkg}, not from "
                 f"this checkout ({ROOT})")
    from pantax_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    t0 = time.time()
    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__}, devices {jax.devices()}", flush=True)
    used = run(ROOT / ".smoke", four=args.four)
    dev = jax.devices()[0]
    print(f"total {time.time() - t0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": used}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
