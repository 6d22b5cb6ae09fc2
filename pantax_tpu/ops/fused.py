"""Fused align->classify->coverage pipeline over the global node space.

The per-species profiling flow (fastpath.py) downloads alignment intervals,
re-groups reads by species on host, re-uploads per-species node rows, and
runs one device coverage program per species — the host<->device round trips
dominate the strain stage.  Here the whole per-read pipeline runs in ONE
device program per batch:

    align (aligner._query_batch) -> locate node segments -> classify by
    haplotype -> scatter coverage contributions into GLOBAL accumulators

with the accumulators donated across batches (they never leave the device),
then a single finalize (diff-array cumsum + normalizations) and per-species
SLICES of the global arrays feed the unchanged filters + batched PAO.  The
semantics mirror fastpath.profile_from_alignments exactly (parity test:
tests/test_fused.py); the reference's per-species loop is profile.rs:3291-3323
with coverage get_node_abundances profile.rs:742-1026.

Reads whose node span exceeds the static L_cap window are counted on device
and masked out of the scatter; their contributions are recomputed on host
(profile/coverage.py raw_contributions — the device kernel's oracle) and
scatter-added into the accumulators at finish().  Overflow therefore costs
O(#overflow reads) host work, not a whole-run fallback (it never happens on
chunked / anchor-partition graphs, where 150bp reads cross a handful of
nodes).
"""
from __future__ import annotations

import logging
import os
import time
from collections import deque
from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .coverage_device import (
    _coverage_finalize,
    _coverage_scatter,
    build_padded_tables,
)

log = logging.getLogger("pantax_tpu")


# ---------------------------------------------------------------------------
# text-position -> segment lookup (bucket-accelerated bisection; the same
# serial-gather argument as the aligner's seed lookup: jnp.searchsorted over
# the full segment table costs ~log2(M) serial gathers)
# ---------------------------------------------------------------------------
def _prefetch(arrays) -> None:
    """Start async device->host copies of per-read outputs DURING the align
    loop, so finish() finds them already on host instead of paying one big
    blocking download at the end (22MB of per-read columns at 2M reads)."""
    for a in arrays:
        f = getattr(a, "copy_to_host_async", None)
        if f is not None:
            f()


def build_pos_lookup(tstart: np.ndarray, text_len: int):
    """(pos_lo int32 [nb+1], win_shift, steps) for locate_segment."""
    M = len(tstart)
    b = int(np.clip(int(np.ceil(np.log2(max(M, 2)))) + 2, 8, 22))
    t_bits = int(np.ceil(np.log2(max(text_len, 2))))
    win_shift = max(t_bits - b, 0)
    nb = 1 << max(t_bits - win_shift, 1)
    bounds = (np.arange(nb + 1, dtype=np.int64) << win_shift)
    pos_lo = np.searchsorted(tstart.astype(np.int64), bounds, side="right")
    pos_lo = pos_lo.astype(np.int32)
    occ = int(np.diff(pos_lo).max()) if nb else 0
    steps = int(np.ceil(np.log2(occ + 1))) if occ > 0 else 0
    return pos_lo, win_shift, steps


def locate_segment(tstart, pos_lo, win_shift: int, steps: int, ts):
    """searchsorted(tstart, ts, side='right') - 1, via a static-depth
    in-bucket bisection (first index with tstart[idx] > ts, minus one)."""
    M = tstart.shape[0]
    b = (ts >> win_shift).astype(jnp.int32)
    lo = pos_lo[b]
    hi = pos_lo[b + 1]
    lo_s, hi_s = lo, hi
    for _ in range(steps):
        mid = (lo_s + hi_s) >> 1
        key = tstart[jnp.clip(mid, 0, M - 1)]
        go_right = (key <= ts) & (lo_s < hi_s)
        lo_s = jnp.where(go_right, mid + 1, lo_s)
        hi_s = jnp.where(go_right, hi_s, jnp.maximum(mid, lo_s))
    return jnp.clip(lo_s - 1, 0, M - 1)


def _window_has_dup_nodes(index, W: int = 64) -> bool:
    """True iff some haplotype path visits the SAME node twice within any
    window of W consecutive segments — the only case where per-read
    first-occurrence dedup (profile/coverage.py semantics) can differ from
    counting every window position.  W=64 covers the largest L_cap, so a
    False here lets the fused step skip the dedup sorts entirely."""
    tnode = np.asarray(index.tnode)
    if len(tnode) < 2:
        return False
    hap = np.searchsorted(index.hap_offsets, index.tstart, side="right") - 1
    for k in range(1, min(W, len(tnode))):
        if ((tnode[:-k] == tnode[k:]) & (hap[:-k] == hap[k:])).any():
            return True
    return False


def node_span_bound(index, read_pad: int, band: int = 16) -> int:
    """Exact static bound on how many text segments one alignment can span:
    the worst case is a read of the padded length (+ DP band slack) starting
    at the LAST base of each segment."""
    tstart = np.asarray(index.tstart, dtype=np.int64)
    if len(tstart) < 2:
        return 1
    W = read_pad + band + 2
    i = np.arange(len(tstart) - 1)
    te = tstart[i + 1] - 1 + W  # read ends before this text position
    return int((np.searchsorted(tstart, te, side="left") - i).max()) + 1


def overflow_fraction(index, read_pad: int, K: int, band: int = 16) -> float:
    """Fraction of text start positions whose alignment would span more
    than K segments (the device overflow predicate at L_cap=K): position p
    in segment i overflows iff p + W - 1 >= tstart[i + K]."""
    tstart = np.asarray(index.tstart, dtype=np.int64)
    M = len(tstart)
    if M <= K:
        return 0.0
    W = read_pad + band + 2
    i = np.arange(M - K)
    lo = np.maximum(tstart[i], tstart[i + K] - W + 1)
    hi = np.concatenate([tstart[1:], [index.text_len]])[i]
    return float(np.maximum(hi - lo, 0).sum()) / max(index.text_len, 1)


def auto_node_window(index, read_pad: int, band: int = 16) -> int:
    """Static node window: the smallest power-of-two K whose expected
    overflow rate stays under ~1/256 of reads, else the exact worst-case
    bound clamped to [4, 64].  Overflowing reads are handled EXACTLY by the
    host residual path at O(#overflow) cost, so the threshold is purely an
    engineering budget: 1/256 of a 65536-read dispatch is ~256 expected
    rows, comfortably inside the _OV_CAP=1024 compact table (beyond which
    a dispatch pays a full interval download).  Scatter/window work scales
    linearly with the window, so covering the 99.6th percentile instead of
    the worst case halves the fused step's classify+scatter cost on
    fragmented graphs (segment-span medians sit at 2-5 with a ~2x tail)."""
    exact = max(4, min(1 << int(np.ceil(np.log2(
        node_span_bound(index, read_pad, band)))), 64))
    for K in (4, 8, 16, 32):
        if K >= exact:
            break
        # estimate with the typical interval width (the read length, not
        # read + DP-band slack): the rate only budgets residual work, and
        # the worst-case width inflates boundary spans ~5x (measured 1.5%
        # vs 0.27% actual at K=8 on a 102-strain DB)
        if overflow_fraction(index, read_pad, K, band=0) <= 1.0 / 256:
            return K
    return exact


# ---------------------------------------------------------------------------
# fused device step
# ---------------------------------------------------------------------------
def _classify_scatter(
    ts, te, aligned,
    hap_offsets, hap_range, pos_lo, tstart, tnode, trio_seg,
    nodes_len, base_offset, trio_hash, trio_order, trio_abc, trio_bucket,
    acc,
    *,
    win_shift: int, pos_steps: int, L_cap: int,
    num_nodes: int, total_bases: int, num_trios: int,
    trio_bits: int, trio_steps: int, trio_probes: int, has_dups: bool,
):
    """Classify aligned text intervals by containing haplotype and scatter
    their coverage contributions into ``acc``; shared by the single-end and
    paired fused steps.  Returns (ridx, overflow, new_acc)."""
    M = tstart.shape[0]

    # classification by containing haplotype (fastpath.py:167-181 parity);
    # the haplotype table is tiny (H+1 entries), so a plain searchsorted's
    # log2(H) serial gathers of [B] are negligible next to the segment locate
    h = jnp.clip(
        jnp.searchsorted(hap_offsets, ts, side="right") - 1,
        0, hap_range.shape[0] - 1,
    )
    ridx = jnp.where(aligned, hap_range[h], -1)

    # node segment window
    i0 = locate_segment(tstart, pos_lo, win_shift, pos_steps, ts)
    cols = jnp.arange(1, L_cap + 1, dtype=jnp.int32)
    nxt = i0[:, None] + cols[None, :]
    starts_win = jnp.where(
        nxt < M, tstart[jnp.clip(nxt, 0, M - 1)], jnp.int32(2**31 - 1)
    )
    te1 = jnp.maximum(te - 1, ts)
    n_more = jnp.sum(starts_win <= te1[:, None], axis=1).astype(jnp.int32)
    overflow = aligned & (n_more >= L_cap)
    span = jnp.clip(n_more + 1, 1, L_cap)

    keep = aligned & (ridx >= 0) & ~overflow
    colsL = jnp.arange(L_cap, dtype=jnp.int32)[None, :]
    take = jnp.clip(i0[:, None] + colsL, 0, M - 1)
    nodes = jnp.where(
        (colsL < span[:, None]) & keep[:, None],
        tnode[take].astype(jnp.int32) - 1,
        -1,
    )
    lengths = jnp.where(keep, span, 0)
    read_start = jnp.where(keep, (ts - tstart[i0]).astype(jnp.int32), 0)
    read_end = jnp.where(keep, read_start + (te - ts).astype(jnp.int32), 0)

    # precomputed per-segment trio matches: window j of a read = segments
    # (i0+j .. i0+j+2), all within one haplotype -> one gather replaces the
    # hash+bisect+probe trio lookup (dominant scatter cost)
    trio_match = None
    if num_trios > 0 and L_cap >= 3:
        trio_match = trio_seg[take[:, : L_cap - 2]]

    new_acc = _coverage_scatter(
        nodes, lengths, read_start, read_end,
        nodes_len, base_offset, trio_hash, trio_order, trio_abc,
        num_nodes=num_nodes, total_bases=total_bases, num_trios=num_trios,
        acc=acc,
        trio_bucket=trio_bucket, trio_bits=trio_bits, trio_steps=trio_steps,
        trio_probes=trio_probes, has_dups=has_dups, trio_match=trio_match,
    )
    return ridx, overflow, new_acc


def _classify_scatter_ranges(
    ts, te, aligned,
    hap_offsets, hap_range, pos_lo, tstart, tnode, trio_seg,
    nodes_len, base_offset,
    acc,
    *,
    win_shift: int, pos_steps: int, total_bases: int,
):
    """Range-decomposition classify+scatter: O(1) device updates per read
    for ANY node span, no L_cap window, no overflow path.

    Generalizes _interval_range_step (long-read spans >= 5) to every span:

      span 1:  bases te-ts @ first node, diff [rs, rs + te-ts); no depth.
      span 2:  first/last partial segments direct; the middle-depth diff
               updates (+1 @ i0+1, -1 @ i1) land on the same index and
               cancel; no trio (needs 3 segments).
      span >=3: first/last direct, middle segments [i0+1, i1-1] and trio
               windows [i0, i1-2] as segment-space depth diffs (acc_sn /
               acc_st, folded by _expand_ranges once at finish), plus the
               two end-window partial-node trio corrections.

    Replaces the [B, L_cap] window gathers + per-column scatters of
    _classify_scatter with ~12 scalar scatter updates per read.  Valid only
    on DBs where no haplotype revisits a node within one read's segment span
    (tables.has_dups False, the measured case for chunked and
    anchor-partition graphs): first-occurrence dedup would need the
    windowed formulation.  Semantics parity: profile.rs:742-1026 base
    allocation, same oracle as _classify_scatter (tests/test_fused.py runs
    both formulations against profile/coverage.py)."""
    acc_bases, acc_diff, acc_trio, acc_sn, acc_st = acc

    h = jnp.clip(
        jnp.searchsorted(hap_offsets, ts, side="right") - 1,
        0, hap_range.shape[0] - 1,
    )
    ridx = jnp.where(aligned, hap_range[h], -1)
    live = aligned & (ridx >= 0) & (te > ts)

    i0 = locate_segment(tstart, pos_lo, win_shift, pos_steps, ts)
    i1 = locate_segment(tstart, pos_lo, win_shift, pos_steps,
                        jnp.maximum(te - 1, ts))
    span = i1 - i0 + 1
    multi = live & (span >= 2)
    trio3 = live & (span >= 3)

    n0 = tnode[i0].astype(jnp.int32) - 1
    n1 = tnode[i1].astype(jnp.int32) - 1
    rs = (ts - tstart[i0]).astype(jnp.int32)
    rem = (te - tstart[i1]).astype(jnp.int32)
    nlen0 = nodes_len[n0].astype(jnp.int32)
    nlen1 = nodes_len[n1].astype(jnp.int32)
    tgt = (te - ts).astype(jnp.int32)

    N = acc_bases.shape[0]
    first_val = jnp.where(multi, nlen0 - rs, tgt)
    b_idx = jnp.concatenate([
        jnp.where(live, n0, N), jnp.where(multi, n1, N),
    ])
    b_val = jnp.concatenate([first_val, rem]).astype(jnp.float32)
    acc_bases = acc_bases.at[b_idx].add(b_val, mode="drop")

    # per-base diff: sentinel index total_bases is the [TB+1] array's last
    # element, excluded by the finalize cumsum (diff[:-1])
    bo0 = base_offset[n0]
    bo1 = base_offset[n1]
    first_hi = jnp.where(multi, nlen0, rs + tgt)
    d_lo = jnp.concatenate([
        jnp.where(live, bo0 + rs, total_bases),
        jnp.where(multi, bo1, total_bases),
    ])
    d_hi = jnp.concatenate([
        jnp.where(live, bo0 + first_hi, total_bases),
        jnp.where(multi, bo1 + rem, total_bases),
    ])
    acc_diff = acc_diff.at[d_lo].add(1).at[d_hi].add(-1)

    S = acc_sn.shape[0]
    acc_sn = acc_sn.at[jnp.where(multi, i0 + 1, S)].add(1, mode="drop")
    acc_sn = acc_sn.at[jnp.where(multi, i1, S)].add(-1, mode="drop")
    acc_st = acc_st.at[jnp.where(trio3, i0, S)].add(1, mode="drop")
    acc_st = acc_st.at[jnp.where(trio3, i1 - 1, S)].add(-1, mode="drop")

    U = acc_trio.shape[0]
    m0 = trio_seg[i0]
    m1 = trio_seg[jnp.maximum(i1 - 2, 0)]
    t_idx = jnp.concatenate([
        jnp.where(trio3 & (m0 >= 0), m0, U),
        jnp.where(trio3 & (m1 >= 0), m1, U),
    ])
    t_val = jnp.concatenate([-rs, -(nlen1 - rem)]).astype(jnp.float32)
    acc_trio = acc_trio.at[t_idx].add(t_val, mode="drop")

    return ridx, (acc_bases, acc_diff, acc_trio, acc_sn, acc_st)


def _fused_step_impl(
    # align index (replicated device arrays)
    text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
    # classification tables
    hap_offsets,     # int32 [H + 1] text start of each haplotype
    hap_range,       # int32 [H] species-range index of each haplotype
    pos_lo,          # int32 [nb + 1] segment bucket table
    trio_seg,        # int32 [M] per-segment trio match (-1 = none)
    # coverage tables (global padded node space)
    nodes_len, base_offset, trio_hash, trio_order, trio_abc, trio_bucket,
    # batch
    codes_packed, read_len,
    # donated accumulators
    acc_bases, acc_diff, acc_trio,
    *,
    cfg_static, win_shift: int, pos_steps: int, L_cap: int,
    num_nodes: int, total_bases: int, num_trios: int,
    trio_bits: int, trio_steps: int, trio_probes: int, has_dups: bool,
):
    from ..align.aligner import _query_batch

    ts, te, score, matches, mapq, strand, aligned = _query_batch(
        text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
        codes_packed, read_len, cfg_static,
    )
    ridx, overflow, (n_bases, n_diff, n_trio) = _classify_scatter(
        ts, te, aligned,
        hap_offsets, hap_range, pos_lo, tstart, tnode, trio_seg,
        nodes_len, base_offset, trio_hash, trio_order, trio_abc, trio_bucket,
        (acc_bases, acc_diff, acc_trio),
        win_shift=win_shift, pos_steps=pos_steps, L_cap=L_cap,
        num_nodes=num_nodes, total_bases=total_bases, num_trios=num_trios,
        trio_bits=trio_bits, trio_steps=trio_steps, trio_probes=trio_probes,
        has_dups=has_dups,
    )
    return (n_bases, n_diff, n_trio) + _narrow_per_read(
        ts, te, mapq, aligned, ridx, overflow
    )


_OV_CAP = 1024  # static size of the compact per-dispatch overflow-row table


def _narrow_per_read(ts, te, mapq, aligned, ridx, overflow):
    """Narrow per-read outputs for the device->host transfer: finish()
    downloads every fed read.  Only mapq/aligned/ridx (4B/read) cross per
    batch; ts/span (6B/read) stay device-resident (dropped once the overflow
    count is known), the overflow flags collapse to one per-batch scalar count
    (padded rows are unaligned, so the full-batch sum equals the fed-row
    sum), and the first _OV_CAP overflowing rows travel as a compact
    [3, _OV_CAP] (row, ts, te) table (12KB) so the host residual path needs
    no full-batch interval download — adaptive L_cap makes small overflow
    counts routine, not exceptional."""
    n = ts.shape[0]
    ov_idx = jnp.nonzero(overflow, size=_OV_CAP, fill_value=n)[0]
    take = jnp.clip(ov_idx, 0, n - 1)
    live = ov_idx < n
    ov_rows = jnp.stack([
        jnp.where(live, ov_idx, -1).astype(jnp.int32),
        jnp.where(live, ts[take], 0).astype(jnp.int32),
        jnp.where(live, te[take], 0).astype(jnp.int32),
    ])
    return (
        ts.astype(jnp.int32),
        (te - ts).astype(jnp.int16),
        mapq.astype(jnp.int8),
        aligned,
        ridx.astype(jnp.int16),
        overflow.sum().astype(jnp.int32),
        ov_rows,
    )


_fused_step = partial(
    jax.jit,
    static_argnames=(
        "cfg_static", "win_shift", "pos_steps", "L_cap",
        "num_nodes", "total_bases", "num_trios",
        "trio_bits", "trio_steps", "trio_probes", "has_dups",
    ),
    donate_argnums=(18, 19, 20),  # acc_bases, acc_diff, acc_trio
)(_fused_step_impl)


def _narrow_per_read_nov(ts, te, mapq, aligned, ridx):
    """_narrow_per_read for the range-decomposition step: no overflow
    exists, so the compact row table and its nonzero sort are dropped."""
    return (
        ts.astype(jnp.int32),
        (te - ts).astype(jnp.int16),
        mapq.astype(jnp.int8),
        aligned,
        ridx.astype(jnp.int16),
    )


def _fused_step_ranges_impl(
    text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
    hap_offsets, hap_range, pos_lo, trio_seg,
    nodes_len, base_offset,
    codes_packed, read_len,
    acc_bases, acc_diff, acc_trio, acc_sn, acc_st,
    *,
    cfg_static, win_shift: int, pos_steps: int, total_bases: int,
):
    """Fused align+classify+coverage with the range-decomposition scatter
    (_classify_scatter_ranges): no window gathers, no L_cap, no overflow."""
    from ..align.aligner import _query_batch

    ts, te, score, matches, mapq, strand, aligned = _query_batch(
        text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
        codes_packed, read_len, cfg_static,
    )
    ridx, accs = _classify_scatter_ranges(
        ts, te, aligned,
        hap_offsets, hap_range, pos_lo, tstart, tnode, trio_seg,
        nodes_len, base_offset,
        (acc_bases, acc_diff, acc_trio, acc_sn, acc_st),
        win_shift=win_shift, pos_steps=pos_steps, total_bases=total_bases,
    )
    return accs + _narrow_per_read_nov(ts, te, mapq, aligned, ridx)


_fused_step_ranges = partial(
    jax.jit,
    static_argnames=("cfg_static", "win_shift", "pos_steps", "total_bases"),
    donate_argnums=(14, 15, 16, 17, 18),  # the five accumulators
)(_fused_step_ranges_impl)


def _fused_step_paired_ranges_impl(
    text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
    hap_offsets, hap_range, pos_lo, trio_seg,
    nodes_len, base_offset,
    codes1_packed, len1, codes2_packed, len2,
    acc_bases, acc_diff, acc_trio, acc_sn, acc_st,
    *,
    cfg_static, frag_max: int, pair_bonus: int, rescue_frac: float,
    win_shift: int, pos_steps: int, total_bases: int,
):
    from ..align.aligner import _query_batch_paired

    r1, r2 = _query_batch_paired(
        text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
        codes1_packed, len1, codes2_packed, len2,
        cfg_static, frag_max, pair_bonus, rescue_frac,
    )
    (ts1, te1, _s1, _m1, mq1, _st1, al1) = r1
    (ts2, te2, _s2, _m2, mq2, _st2, al2) = r2
    ts = jnp.concatenate([ts1, ts2])
    te = jnp.concatenate([te1, te2])
    aligned = jnp.concatenate([al1, al2])
    ridx, accs = _classify_scatter_ranges(
        ts, te, aligned,
        hap_offsets, hap_range, pos_lo, tstart, tnode, trio_seg,
        nodes_len, base_offset,
        (acc_bases, acc_diff, acc_trio, acc_sn, acc_st),
        win_shift=win_shift, pos_steps=pos_steps, total_bases=total_bases,
    )
    mapq = jnp.concatenate([mq1, mq2])
    return accs + _narrow_per_read_nov(ts, te, mapq, aligned, ridx)


_fused_step_paired_ranges = partial(
    jax.jit,
    static_argnames=(
        "cfg_static", "frag_max", "pair_bonus", "rescue_frac",
        "win_shift", "pos_steps", "total_bases",
    ),
    donate_argnums=(16, 17, 18, 19, 20),  # the five accumulators
)(_fused_step_paired_ranges_impl)


def _fused_step_paired_impl(
    text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
    hap_offsets, hap_range, pos_lo, trio_seg,
    nodes_len, base_offset, trio_hash, trio_order, trio_abc, trio_bucket,
    codes1_packed, len1, codes2_packed, len2,
    acc_bases, acc_diff, acc_trio,
    *,
    cfg_static, frag_max: int, pair_bonus: int, rescue_frac: float,
    win_shift: int, pos_steps: int, L_cap: int,
    num_nodes: int, total_bases: int, num_trios: int,
    trio_bits: int, trio_steps: int, trio_probes: int, has_dups: bool,
):
    """Paired fragment-model variant: one joint mate query
    (aligner._query_batch_paired — fragment scoring, rescue, pair mapq),
    then classify+scatter on the concatenated [2B] mate intervals.  Per-read
    outputs are returned mate1-block then mate2-block."""
    from ..align.aligner import _query_batch_paired

    r1, r2 = _query_batch_paired(
        text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
        codes1_packed, len1, codes2_packed, len2,
        cfg_static, frag_max, pair_bonus, rescue_frac,
    )
    (ts1, te1, _s1, _m1, mq1, _st1, al1) = r1
    (ts2, te2, _s2, _m2, mq2, _st2, al2) = r2
    ts = jnp.concatenate([ts1, ts2])
    te = jnp.concatenate([te1, te2])
    aligned = jnp.concatenate([al1, al2])
    ridx, overflow, (n_bases, n_diff, n_trio) = _classify_scatter(
        ts, te, aligned,
        hap_offsets, hap_range, pos_lo, tstart, tnode, trio_seg,
        nodes_len, base_offset, trio_hash, trio_order, trio_abc, trio_bucket,
        (acc_bases, acc_diff, acc_trio),
        win_shift=win_shift, pos_steps=pos_steps, L_cap=L_cap,
        num_nodes=num_nodes, total_bases=total_bases, num_trios=num_trios,
        trio_bits=trio_bits, trio_steps=trio_steps, trio_probes=trio_probes,
        has_dups=has_dups,
    )
    mapq = jnp.concatenate([mq1, mq2])
    return (n_bases, n_diff, n_trio) + _narrow_per_read(
        ts, te, mapq, aligned, ridx, overflow
    )


_fused_step_paired = partial(
    jax.jit,
    static_argnames=(
        "cfg_static", "frag_max", "pair_bonus", "rescue_frac",
        "win_shift", "pos_steps", "L_cap",
        "num_nodes", "total_bases", "num_trios",
        "trio_bits", "trio_steps", "trio_probes", "has_dups",
    ),
    donate_argnums=(20, 21, 22),  # acc_bases, acc_diff, acc_trio
)(_fused_step_paired_impl)


@partial(jax.jit, static_argnames=("num_nodes",))
def _fused_finalize(acc_bases, acc_diff, acc_trio, nodes_len, base_offset,
                    trio_len, num_nodes: int):
    return _coverage_finalize(
        acc_bases, acc_diff, acc_trio, nodes_len, base_offset, trio_len,
        num_nodes=num_nodes,
    )


# ---------------------------------------------------------------------------
# interval feeds (long reads): pre-aligned text intervals instead of codes.
# Short spans reuse the windowed classify+scatter; spans beyond the window
# use a RANGE decomposition — per read, only the two partial end segments
# are scattered directly, while the fully-covered middle segments go into
# segment-space difference arrays (depth per segment), expanded into the
# node/base/trio accumulators ONCE at finalize.  A 100kb read thus costs
# O(1) device work per batch instead of an O(#segments) window.
# Parity anchor: profile.rs:742-1026 base allocation; the decomposition is
# exact on haplotypes that never revisit a node (others take the host
# residual path, tables.hap_dup).
# ---------------------------------------------------------------------------
def _interval_window_step_impl(
    tstart, tnode,
    hap_offsets, hap_range, pos_lo, trio_seg,
    nodes_len, base_offset, trio_hash, trio_order, trio_abc, trio_bucket,
    ts, te, aligned,
    acc_bases, acc_diff, acc_trio,
    *,
    win_shift: int, pos_steps: int, L_cap: int,
    num_nodes: int, total_bases: int, num_trios: int,
    trio_bits: int, trio_steps: int, trio_probes: int, has_dups: bool,
):
    _ridx, _overflow, accs = _classify_scatter(
        ts, te, aligned,
        hap_offsets, hap_range, pos_lo, tstart, tnode, trio_seg,
        nodes_len, base_offset, trio_hash, trio_order, trio_abc, trio_bucket,
        (acc_bases, acc_diff, acc_trio),
        win_shift=win_shift, pos_steps=pos_steps, L_cap=L_cap,
        num_nodes=num_nodes, total_bases=total_bases, num_trios=num_trios,
        trio_bits=trio_bits, trio_steps=trio_steps, trio_probes=trio_probes,
        has_dups=has_dups,
    )
    return accs


_interval_window_step = partial(
    jax.jit,
    static_argnames=(
        "win_shift", "pos_steps", "L_cap",
        "num_nodes", "total_bases", "num_trios",
        "trio_bits", "trio_steps", "trio_probes", "has_dups",
    ),
    donate_argnums=(15, 16, 17),
)(_interval_window_step_impl)


def _interval_range_step_impl(
    tstart, tnode, hap_offsets, hap_range, pos_lo, trio_seg,
    nodes_len, base_offset,
    ts, te, live,
    acc_bases, acc_diff, acc_trio, acc_sn, acc_st,
    *,
    win_shift: int, pos_steps: int, total_bases: int,
):
    """Range decomposition for pre-aligned text intervals of ANY span on
    dup-free haplotypes: _classify_scatter_ranges without the query (the
    per-read columns were computed on host by feed_intervals)."""
    _ridx, accs = _classify_scatter_ranges(
        ts, te, live,
        hap_offsets, hap_range, pos_lo, tstart, tnode, trio_seg,
        nodes_len, base_offset,
        (acc_bases, acc_diff, acc_trio, acc_sn, acc_st),
        win_shift=win_shift, pos_steps=pos_steps, total_bases=total_bases,
    )
    return accs


_interval_range_step = partial(
    jax.jit,
    static_argnames=("win_shift", "pos_steps", "total_bases"),
    donate_argnums=(11, 12, 13, 14, 15),
)(_interval_range_step_impl)


def _expand_ranges_impl(
    acc_bases, acc_diff, acc_trio, acc_sn, acc_st,
    tnode, nodes_len, base_offset, trio_seg,
    *, total_bases: int,
):
    """Fold the segment-space depth diffs into the node/base/trio
    accumulators: depth[i] full copies of segment i's node, and depth_t[w]
    full window sums for window w.  One pass over all M segments, once per
    run."""
    M = tnode.shape[0]
    n = tnode.astype(jnp.int32) - 1
    nlen = nodes_len[n].astype(jnp.int32)
    depth_n = jnp.cumsum(acc_sn[:-1])
    acc_bases = acc_bases.at[n].add(
        (depth_n * nlen).astype(jnp.float32), mode="drop"
    )
    bo = base_offset[n]
    live = depth_n != 0
    acc_diff = acc_diff.at[jnp.where(live, bo, total_bases)].add(depth_n)
    acc_diff = acc_diff.at[
        jnp.where(live, bo + nlen, total_bases)
    ].add(-depth_n)
    depth_t = jnp.cumsum(acc_st[:-1])
    i1c = jnp.minimum(jnp.arange(M, dtype=jnp.int32) + 1, M - 1)
    i2c = jnp.minimum(jnp.arange(M, dtype=jnp.int32) + 2, M - 1)
    w3 = (nlen + nodes_len[tnode[i1c].astype(jnp.int32) - 1].astype(jnp.int32)
          + nodes_len[tnode[i2c].astype(jnp.int32) - 1].astype(jnp.int32))
    U = acc_trio.shape[0]
    t_idx = jnp.where((depth_t != 0) & (trio_seg >= 0), trio_seg, U)
    acc_trio = acc_trio.at[t_idx].add(
        (depth_t * w3).astype(jnp.float32), mode="drop"
    )
    return acc_bases, acc_diff, acc_trio


_expand_ranges = partial(
    jax.jit,
    static_argnames=("total_bases",),
    donate_argnums=(0, 1, 2),  # the segment diffs have no same-shape output
)(_expand_ranges_impl)


# ---------------------------------------------------------------------------
# L_cap-overflow residual: reads whose node span exceeds the static window
# are masked out of the device scatter (keep = ... & ~overflow) but their
# classification is still valid, so their coverage contributions can be
# computed on host (profile/coverage.py — the same oracle the device kernel
# is tested against) and scatter-added into the donated accumulators before
# finalize.  O(#overflow reads) host work replaces the old whole-run
# per-species fallback, and ts/span device buffers of overflow-free batches
# can be dropped as soon as their overflow count is known to be 0.
# ---------------------------------------------------------------------------
@partial(jax.jit, donate_argnums=(0, 1, 2))
def _residual_scatter(acc_b, acc_d, acc_t, bidx, bval, dlo, dhi, tidx, tval):
    """Sparse-add host-computed residual contributions into the accumulators
    (index arrays padded with out-of-bounds sentinels -> mode='drop')."""
    acc_b = acc_b.at[bidx].add(bval, mode="drop")
    acc_d = acc_d.at[dlo].add(jnp.int32(1), mode="drop")
    acc_d = acc_d.at[dhi].add(jnp.int32(-1), mode="drop")
    acc_t = acc_t.at[tidx].add(tval, mode="drop")
    return acc_b, acc_d, acc_t


def _pad_pow2(arr, sentinel, dtype):
    n = max(64, 1 << (max(len(arr), 1) - 1).bit_length())
    out = np.full(n, sentinel, dtype=dtype)
    out[: len(arr)] = arr
    return out


def host_residual_updates(index, tables: FusedTables, ts, te, ridx):
    """Global-space sparse coverage updates for overflow reads: per species,
    project text intervals onto node paths (fastpath.py:220-243 semantics)
    and take the host oracle's raw addends (profile/coverage.py
    raw_contributions), shifted by the species' node / base / trio offsets.
    Returns (bidx f32-node, bval, dlo, dhi, tidx, tval) int64/float arrays."""
    from ..profile.coverage import PackedReads, raw_contributions

    tstart = np.asarray(index.tstart, dtype=np.int64)
    tnode = np.asarray(index.tnode, dtype=np.int64)
    # clamp intervals to the classifying (ts) haplotype: a read whose
    # mismatching tail pushed te past the sentinel separator would otherwise
    # project onto ANOTHER species' segments and index its local node arrays
    # out of range (alignments are classified by ts, fastpath.py:165-177)
    hap = np.clip(
        np.searchsorted(index.hap_offsets, ts, side="right") - 1,
        0, len(index.hap_offsets) - 2,
    )
    te = np.minimum(te, index.hap_offsets[hap + 1] - 1)
    te = np.maximum(te, ts + 1)
    base_off_host = getattr(tables, "_base_offset_host", None)
    if base_off_host is None:
        base_off_host = np.asarray(tables.base_offset_d, dtype=np.int64)
        tables._base_offset_host = base_off_host
    bi, bv, dl, dh, tidx, tv = [], [], [], [], [], []
    for rj in np.unique(ridx):
        sp = tables.species[int(rj)]
        sel = ridx == rj
        s_ts, s_te = ts[sel], te[sel]
        i0 = np.searchsorted(tstart, s_ts, side="right") - 1
        i1 = np.searchsorted(tstart, np.maximum(s_te - 1, s_ts),
                             side="right") - 1
        span = i1 - i0 + 1
        R, L = len(i0), int(span.max())
        nodes = np.full((R, L), -1, dtype=np.int64)
        cols = np.arange(L)
        take = np.clip(i0[:, None] + cols[None, :], 0, len(tnode) - 1)
        valid = cols[None, :] < span[:, None]
        nodes[valid] = (tnode[take] - sp.range_.start)[valid]
        rs = (s_ts - tstart[i0]).astype(np.int64)
        packed = PackedReads(
            nodes=nodes, lengths=span.astype(np.int64), read_start=rs,
            read_end=rs + (s_te - s_ts).astype(np.int64),
        )
        n_idx, n_val, lo, hi, t_idx, t_val = raw_contributions(
            packed, np.asarray(sp.nodes_len, dtype=np.int64), sp.trio_index
        )
        B0 = base_off_host[sp.off]
        bi.append(n_idx + sp.off)
        bv.append(n_val)
        dl.append(lo + B0)
        dh.append(hi + B0)
        tidx.append(t_idx + sp.trio_lo)
        tv.append(t_val)

    def cat(parts, dtype=np.int64):
        return (np.concatenate(parts).astype(dtype) if parts
                else np.zeros(0, dtype))

    return cat(bi), cat(bv), cat(dl), cat(dh), cat(tidx), cat(tv)


def apply_residual(acc, tables: FusedTables, updates):
    """Scatter-add host residual updates into the (donated) accumulators.
    Index arrays are padded to power-of-two buckets with out-of-bounds
    sentinels so overflow counts of different sizes share one compiled
    graph."""
    bidx, bval, dlo, dhi, tidx, tval = updates
    acc_b, acc_d, acc_t = acc
    return _residual_scatter(
        acc_b, acc_d, acc_t,
        jnp.asarray(_pad_pow2(bidx, tables.N_pad + 1, np.int32)),
        jnp.asarray(_pad_pow2(bval, 0, np.float32)),
        jnp.asarray(_pad_pow2(dlo, tables.TB_pad + 2, np.int32)),
        jnp.asarray(_pad_pow2(dhi, tables.TB_pad + 2, np.int32)),
        jnp.asarray(_pad_pow2(tidx, tables.U_pad + 1, np.int32)),
        jnp.asarray(_pad_pow2(tval, 0, np.float32)),
    )


# ---------------------------------------------------------------------------
# host-side tables + driver
# ---------------------------------------------------------------------------
@dataclass
class FusedSpecies:
    range_: object          # SpeciesRange
    ridx: int               # index into the species-range table
    off: int                # global 0-based node offset (range.start - 1)
    num_nodes: int
    trio_lo: int            # slice of the global trio table
    trio_hi: int
    paths: dict             # name -> node array (local)
    nodes_len: np.ndarray
    trio_index: object      # TrioIndex (hap_matrix, trio_len, ...)


@dataclass
class FusedTables:
    species: list
    ranges: list
    mesh: object            # jax Mesh the device arrays are replicated over
    hap_dup: np.ndarray     # bool [H] hap path visits some node twice
    # device arrays
    hap_offsets_d: jnp.ndarray
    hap_range_d: jnp.ndarray
    pos_lo_d: jnp.ndarray
    nodes_len_d: jnp.ndarray
    base_offset_d: jnp.ndarray
    trio_hash_d: jnp.ndarray
    trio_order_d: jnp.ndarray
    trio_abc_d: jnp.ndarray
    trio_len_d: jnp.ndarray
    trio_bucket_d: jnp.ndarray
    trio_seg_d: jnp.ndarray  # int32 [M] per-segment trio match (-1 = none)
    trio_bits: int
    trio_steps: int
    trio_probes: int
    has_dups: bool
    win_shift: int
    pos_steps: int
    N_pad: int
    TB_pad: int
    U_pad: int


def _build_trio_seg(index, species, hap_range) -> np.ndarray:
    """Per-SEGMENT unique-trio matches, precomputed on host: trio_seg[i] is
    the global unique-trio index matched by the 3-window of consecutive text
    segments (i, i+1, i+2), or -1.

    The fused path's windows are always consecutive segments of one
    haplotype (nodes[:, j] = tnode[i0 + j]), so the device trio lookup
    reduces to ONE gather from this table — the hash+bisect+probe pipeline
    it replaces was the dominant per-batch scatter cost.  Cross-haplotype
    windows are baked to -1; alignments never span haplotypes, so they
    cannot occur at runtime."""
    tn = np.asarray(index.tnode, dtype=np.int64)
    M = len(tn)
    trio_seg = np.full(M, -1, dtype=np.int32)
    if M < 3:
        return trio_seg
    seg_hap = np.searchsorted(
        index.hap_offsets, index.tstart, side="right"
    ) - 1
    seg_hap = np.clip(seg_hap, 0, len(hap_range) - 1)
    same_hap = seg_hap[:-2] == seg_hap[2:]
    win_range = hap_range[seg_hap[:-2]]
    wa, wb, wc = tn[:-2] - 1, tn[1:-1] - 1, tn[2:] - 1  # global 0-based
    for sp in species:
        sel = np.flatnonzero(same_hap & (win_range == sp.ridx))
        if not len(sel) or sp.trio_index.num_unique == 0:
            continue
        wins = np.stack(
            [wa[sel] - sp.off, wb[sel] - sp.off, wc[sel] - sp.off], axis=1
        )
        m = sp.trio_index.match(wins)
        trio_seg[sel] = np.where(m >= 0, m + sp.trio_lo, -1).astype(np.int32)
    return trio_seg


def _put_repl(arr, mesh):
    """Replicate a table over the mesh (plain device array when mesh-less):
    tables feed every fused dispatch, so they must live on ALL mesh devices
    rather than being re-placed from the default device each call."""
    if mesh is None:
        return jnp.asarray(arr)
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(np.asarray(arr), NamedSharding(mesh, P()))


def build_fused_tables(db, index, mesh=None) -> FusedTables:
    """Global coverage/classification tables + per-species metadata.

    ``mesh`` (default: the process default mesh) replicates every device
    table over the mesh so the fused step can shard its read batch over the
    "reads" axis (coverage scatters psum-merge across devices)."""
    from ..graph.core import load_species_range
    from ..graph.trio import build_trio_index
    from ..parallel import default_mesh

    if mesh is None:
        mesh = default_mesh()

    ranges = load_species_range(db.range_file)
    N = max(r.end for r in ranges)
    nodes_len = np.ones(N, dtype=np.int64)
    trio_nodes, trio_len, species = [], [], []
    t_off = 0
    for rj, r in enumerate(ranges):
        g = db.load_graph(r.species)
        off = r.start - 1
        nodes_len[off:off + g.num_nodes] = g.nodes_len
        paths = g.paths_dict()
        ti = build_trio_index(g.nodes_len, paths)
        u = ti.num_unique
        if u:
            trio_nodes.append(np.asarray(ti.trio_nodes) + off)
            trio_len.append(np.asarray(ti.trio_len))
        species.append(FusedSpecies(
            range_=r, ridx=rj, off=off, num_nodes=g.num_nodes,
            trio_lo=t_off, trio_hi=t_off + u,
            paths=paths, nodes_len=g.nodes_len, trio_index=ti,
        ))
        t_off += u
    tn = np.concatenate(trio_nodes) if trio_nodes else np.zeros((0, 3), np.int64)
    tl = np.concatenate(trio_len) if trio_len else np.zeros(0, np.int64)
    t = build_padded_tables(nodes_len, tn, tl)

    range_of_species = {r.species: j for j, r in enumerate(ranges)}
    hap_range = np.array(
        [range_of_species.get(s, -1) for s in index.hap_species],
        dtype=np.int32,
    )
    pos_lo, win_shift, steps = build_pos_lookup(
        index.tstart.astype(np.int64), index.text_len
    )
    trio_seg = _build_trio_seg(index, species, hap_range)
    # hap visits some node twice -> the long-read range decomposition's
    # "every segment contributes its full node length" would double-count
    # bases/trio values the reference credits only at the first occurrence;
    # reads on such haps take the exact host residual path instead
    hap_dup = np.zeros(len(index.hap_species), dtype=bool)
    seg_hap_all = np.clip(np.searchsorted(
        index.hap_offsets, index.tstart, side="right"
    ) - 1, 0, len(hap_dup) - 1)
    tn_all = np.asarray(index.tnode, dtype=np.int64)
    for h in range(len(hap_dup)):
        nodes_h = tn_all[seg_hap_all == h]
        hap_dup[h] = len(np.unique(nodes_h)) != len(nodes_h)
    put = partial(_put_repl, mesh=mesh)
    return FusedTables(
        species=species,
        ranges=ranges,
        mesh=mesh,
        hap_dup=hap_dup,
        hap_offsets_d=put(index.hap_offsets.astype(np.int32)),
        hap_range_d=put(hap_range),
        pos_lo_d=put(pos_lo),
        nodes_len_d=put(t.nodes_len),
        base_offset_d=put(t.base_offset),
        trio_hash_d=put(t.trio_hash),
        trio_order_d=put(t.trio_order),
        trio_abc_d=put(t.trio_abc),
        trio_len_d=put(t.trio_len),
        trio_bucket_d=put(t.trio_bucket),
        trio_seg_d=put(trio_seg),
        trio_bits=t.trio_bits,
        trio_steps=t.trio_steps,
        trio_probes=t.trio_probes,
        has_dups=_window_has_dup_nodes(index),
        win_shift=win_shift,
        pos_steps=steps,
        N_pad=t.N_pad,
        TB_pad=t.TB_pad,
        U_pad=t.U_pad,
    )


class FusedResult:
    """FusedPipeline.finish() output: per-read host arrays plus the three
    dense coverage arrays as DEVICE handles, downloaded lazily on first
    attribute access.  Tuple-compatible with the old 5-tuple
    (na, ta, bc, reads, n_overflow) so indexing/unpacking keeps working —
    but indexing 0-2 triggers the download; the device tail uses na_d/ta_d/
    bc_d and never pays it."""

    def __init__(self, na_d, ta_d, bc_d, reads, n_overflow):
        self.na_d = na_d
        self.ta_d = ta_d
        self.bc_d = bc_d
        self.reads = reads
        self.n_overflow = n_overflow
        self._host = None

    def _materialize(self):
        if self._host is None:
            self._host = (
                np.asarray(self.na_d, dtype=np.float64),
                np.asarray(self.ta_d, dtype=np.float64),
                np.asarray(self.bc_d),
            )
        return self._host

    @property
    def na(self):
        return self._materialize()[0]

    @property
    def ta(self):
        return self._materialize()[1]

    @property
    def bc(self):
        return self._materialize()[2]

    def __len__(self):
        return 5

    def __getitem__(self, i):
        if isinstance(i, slice):
            return tuple(self)[i]
        return (
            lambda: self.na, lambda: self.ta, lambda: self.bc,
            lambda: self.reads, lambda: self.n_overflow,
        )[i]()

    def __iter__(self):
        yield self.na
        yield self.ta
        yield self.bc
        yield self.reads
        yield self.n_overflow


class FusedPipeline:
    """Incremental fused align+coverage: feed() read-chunks (any size; each
    is cut into fixed ``batch`` dispatches), finish() once.  The coverage
    accumulators never leave the device between feeds; per-read outputs are
    collected lazily (device refs) so feeds pipeline like the plain aligner
    loop."""

    def __init__(self, aligner, tables: FusedTables, batch: int,
                 L_cap: int | None = None, prefetch_spans: bool = False):
        self.aligner = aligner
        self.tables = tables
        self.batch = batch
        self.L_cap = L_cap  # None -> auto_node_window at first feed
        # None -> decided at first feed: dup-free DBs route the codes path
        # through the range-decomposition scatter (no window, no overflow);
        # an explicit L_cap forces the windowed formulation (the overflow
        # tests' knob), PANTAX_TPU_FUSED_RANGES=0/1 overrides for A/B
        self.use_ranges: bool | None = False if L_cap is not None else None
        # prefetch_spans=True streams the per-read text intervals (ts/span,
        # 6B/read) to host during the align loop like the other columns —
        # for callers that always consume them (the CLI's resume artifact).
        # False (default) leaves them as device refs, dropped as soon as a
        # dispatch's overflow count materializes as 0; only the rare
        # overflowing dispatch's intervals are downloaded (the host
        # residual path needs them), impossible on chunked graphs.
        self.prefetch_spans = prefetch_spans
        # accumulators replicated over the tables' mesh: the read batch is
        # sharded over "reads", so GSPMD partitions each batch's scatter and
        # psum-merges the per-shard contributions back into the replicated
        # accumulators (integer-valued addends -> merge order can't change
        # the result; the mesh run is bit-identical to single-device)
        self.acc_b = _put_repl(
            np.zeros(tables.N_pad, np.float32), tables.mesh
        )
        self.acc_d = _put_repl(
            np.zeros(tables.TB_pad + 1, np.int32), tables.mesh
        )
        self.acc_t = _put_repl(
            np.zeros(tables.U_pad, np.float32), tables.mesh
        )
        self._per_read = []   # (n_valid, ids|None, lens, core, spans)
        self._ov = []         # per-dispatch overflow-count scalars
        self._ov_rows = []    # per-dispatch compact [3, _OV_CAP] row tables
        self._ov_entries = []  # per-dispatch list of _per_read entry indices
        self._next_mat = 0    # first _per_read entry still holding device refs
        self._next_ov = 0
        # interval feeds (long reads): host-side per-read rows + the
        # segment-space depth accumulators (created on first use)
        self._int_reads: dict | None = None
        self._int_ids: list | None = None
        self._acc_sn = None
        self._acc_st = None
        self._n_int_residual = 0
        self._prep_ex = None  # lazy batch pack+upload prefetch worker
        # overlap the device profile tail's static table build (TailTables:
        # host concatenations + uploads, ~0.5-1s at 102 strains) with the
        # align loop — only when the auto tail heuristic (_tail_mode) would
        # pick the device tail, so host-tail flows don't pay a wasted build
        if (tables.N_pad * 8 + tables.U_pad * 4 >= 4 << 20
                and getattr(tables, "_tail_tables", None) is None
                and getattr(tables, "_tail_tables_fut", None) is None):
            from concurrent.futures import ThreadPoolExecutor

            ex = ThreadPoolExecutor(1, thread_name_prefix="tail-prewarm")
            from .profile_tail import build_tail_tables as _btt

            tables._tail_tables_fut = ex.submit(_btt, tables)
            ex.shutdown(wait=False)

    _MAT_LAG = 8  # batches kept on device before materializing to host
    _PREP_DEPTH = 2  # batches packed+uploaded ahead of the dispatch loop

    def _prep_pool(self):
        if self._prep_ex is None:
            from concurrent.futures import ThreadPoolExecutor

            self._prep_ex = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="fused-prep"
            )
        return self._prep_ex

    def close(self, wait: bool = False) -> None:
        """Shut the prefetch worker down (idempotent).  finish() calls this
        with wait=True; feed error paths and __del__ call it with wait=False
        so an abandoned pipeline doesn't leak the worker thread + in-flight
        uploaded wire buffers for the life of the process."""
        ex, self._prep_ex = self._prep_ex, None
        if ex is not None:
            ex.shutdown(wait=wait, cancel_futures=not wait)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _pad_slice(self, codes, lens, lo: int, hi: int):
        b_codes = codes[lo:hi]
        b_lens = lens[lo:hi]
        if hi - lo < self.batch:
            b_codes = np.vstack([
                b_codes,
                np.full(
                    (self.batch - (hi - lo), codes.shape[1]), 4, np.int8
                ),
            ])
            b_lens = np.concatenate(
                [b_lens, np.zeros(self.batch - (hi - lo), b_lens.dtype)]
            )
        return b_codes, b_lens

    def _prep_slice(self, codes, lens, lo: int, hi: int):
        b_codes, b_lens = self._pad_slice(codes, lens, lo, hi)
        return (self.aligner._pack_reads(b_codes, b_lens),
                self.aligner._put_lens(b_lens))

    def _prepped_batches(self, prep, n: int):
        """Yield (lo, hi, prep(lo, hi)) for each dispatch batch, with the
        pack + upload for the next _PREP_DEPTH batches running on a single
        worker thread: an upload issued from a second thread overlaps device
        execution and the main thread's blocking result downloads, so the
        dispatch loop is bound by compute rather than pack + upload.
        PANTAX_TPU_PREFETCH=0 restores the inline path for A/B probes."""
        batch = self.batch
        starts = list(range(0, n, batch))
        if (os.environ.get("PANTAX_TPU_PREFETCH", "1") == "0"
                or len(starts) <= 1):
            for lo in starts:
                hi = min(lo + batch, n)
                yield lo, hi, prep(lo, hi)
            return
        ex = self._prep_pool()
        # deque + popleft: consumed futures are dropped so each batch's wire
        # buffers free after dispatch instead of accumulating all run long.
        futs: deque = deque()
        done = False
        try:
            for lo in starts[:self._PREP_DEPTH]:
                hi = min(lo + batch, n)
                futs.append(ex.submit(prep, lo, hi))
            for i, lo in enumerate(starts):
                hi = min(lo + batch, n)
                nxt = i + self._PREP_DEPTH
                if nxt < len(starts):
                    nlo = starts[nxt]
                    futs.append(ex.submit(prep, nlo, min(nlo + batch, n)))
                yield lo, hi, futs.popleft().result()
            done = True
        finally:
            # Consumer raised (or abandoned the generator) mid-loop: drop
            # the worker + queued uploads instead of leaking them.
            if not done:
                self.close()

    def _decide_ranges(self, read_pad: int) -> bool:
        """Range scatter needs dup-free windows over one read's whole
        segment span; tables.has_dups checked a 64-segment window, so wider
        span bounds re-check at the exact width (cached per width)."""
        env = os.environ.get("PANTAX_TPU_FUSED_RANGES")
        if env == "0":
            return False
        tables, index = self.tables, self.aligner.index
        if tables.has_dups and env != "1":
            return False
        bound = node_span_bound(
            index, read_pad, self.aligner.cfg.extension_band
        )
        if bound > 64 and env != "1":
            cached = getattr(tables, "_dupfree_w", {})
            ok = cached.get(bound)
            if ok is None:
                ok = not _window_has_dup_nodes(index, W=bound)
                cached[bound] = ok
                tables._dupfree_w = cached
            if not ok:
                return False
        return True

    def _ensure_seg_accs(self) -> None:
        if self._acc_sn is None:
            M = len(self.aligner.index.tstart)
            mesh = self.tables.mesh
            self._acc_sn = _put_repl(np.zeros(M + 1, np.int32), mesh)
            self._acc_st = _put_repl(np.zeros(M + 1, np.int32), mesh)

    def _materialize_to(self, bound: int, ov_bound: int | None = None) -> None:
        """Convert per-read device refs to host arrays up to ``bound``.

        The async host copies (_prefetch) make np.asarray cheap by the time
        an entry is _MAT_LAG batches old, and dropping the device refs HERE
        spreads their deletions across the align loop instead of a burst of
        ~180 buffer deletes after finish() while the profile tail runs.

        ``ov_bound`` defaults to its own _MAT_LAG behind the newest dispatch:
        the overflow scalars grow one per DISPATCH while _per_read grows one
        per MATE BLOCK (two per dispatch in paired mode), so reusing
        ``bound`` would block the host on the just-dispatched fused step."""
        while self._next_mat < bound:
            m, ids, lens, core, spans = self._per_read[self._next_mat]
            if self.prefetch_spans and spans is not None:
                spans = tuple(np.asarray(a) for a in spans)
            self._per_read[self._next_mat] = (
                m, ids, lens, tuple(np.asarray(a) for a in core), spans
            )
            self._next_mat += 1
        if ov_bound is None:
            ov_bound = len(self._ov) - self._MAT_LAG
        while self._next_ov < min(ov_bound, len(self._ov)):
            j = self._next_ov
            v = int(np.asarray(self._ov[j]))
            self._ov[j] = v
            if v:
                # the compact (row, ts, te) table feeds the residual path
                self._ov_rows[j] = np.asarray(self._ov_rows[j])
            else:
                self._ov_rows[j] = None
            if not self.prefetch_spans:
                # overflow count known: <= _OV_CAP (incl. 0) -> the
                # dispatch's ts/span device buffers can never be needed
                # (the compact table carries the overflow intervals), drop
                # the refs now — spreads the deletion RPCs and caps the HBM
                # held by span buffers; > _OV_CAP (truncated table) -> pull
                # the full spans to host for the residual
                for ei in self._ov_entries[j]:
                    m, ids, lens, core, spans = self._per_read[ei]
                    if spans is None:
                        continue
                    if v > _OV_CAP:
                        _prefetch(spans)
                        spans = tuple(np.asarray(a) for a in spans)
                    else:
                        spans = None
                    self._per_read[ei] = (m, ids, lens, core, spans)
            self._next_ov += 1

    def _push_batch(self, m, ids, lens, per_read, ov) -> None:
        """Record one dispatched batch's per-read outputs and start their
        async host copies (spans only when prefetch_spans).  ``ov`` is a
        (count scalar, compact [3, _OV_CAP] row table) pair, or None for the
        second mate block of a paired dispatch (attaches the entry to the
        previous dispatch's overflow record)."""
        ts_d, span_d, mapq_d, al_d, ridx_d = per_read
        core = (mapq_d, al_d, ridx_d)
        spans = (ts_d, span_d)
        self._per_read.append((m, ids, lens, core, spans))
        if ov is not None:
            ov_scalar, ov_rows = ov
            self._ov.append(ov_scalar)
            self._ov_rows.append(ov_rows)
            self._ov_entries.append([len(self._per_read) - 1])
            _prefetch((ov_scalar, ov_rows))
        else:
            self._ov_entries[-1].append(len(self._per_read) - 1)
        _prefetch(core)
        if self.prefetch_spans:
            _prefetch(spans)

    def feed(self, codes, lens, ids=None) -> None:
        aligner, tables, batch = self.aligner, self.tables, self.batch
        if self.use_ranges is None:
            self.use_ranges = self._decide_ranges(codes.shape[1])
        if self.use_ranges:
            self._ensure_seg_accs()
        elif self.L_cap is None:
            self.L_cap = auto_node_window(
                aligner.index, codes.shape[1], aligner.cfg.extension_band
            )
        n = len(lens)

        def prep(lo, hi):
            return self._prep_slice(codes, lens, lo, hi)

        for lo, hi, (reads_dev, lens_dev) in self._prepped_batches(prep, n):
            if self.use_ranges:
                out = _fused_step_ranges(
                    aligner.text_d, aligner.run_table_d, aligner.seed_pos_d,
                    aligner.bucket_lo_d, aligner.tstart_d, aligner.tnode_d,
                    tables.hap_offsets_d, tables.hap_range_d,
                    tables.pos_lo_d, tables.trio_seg_d,
                    tables.nodes_len_d, tables.base_offset_d,
                    reads_dev, lens_dev,
                    self.acc_b, self.acc_d, self.acc_t,
                    self._acc_sn, self._acc_st,
                    cfg_static=aligner._static(),
                    win_shift=tables.win_shift,
                    pos_steps=tables.pos_steps, total_bases=tables.TB_pad,
                )
                (self.acc_b, self.acc_d, self.acc_t,
                 self._acc_sn, self._acc_st) = out[:5]
                per_read, ov = out[5:10], (0, None)
            else:
                out = _fused_step(
                    aligner.text_d, aligner.run_table_d, aligner.seed_pos_d,
                    aligner.bucket_lo_d, aligner.tstart_d, aligner.tnode_d,
                    tables.hap_offsets_d, tables.hap_range_d,
                    tables.pos_lo_d, tables.trio_seg_d,
                    tables.nodes_len_d, tables.base_offset_d,
                    tables.trio_hash_d, tables.trio_order_d,
                    tables.trio_abc_d, tables.trio_bucket_d,
                    reads_dev, lens_dev,
                    self.acc_b, self.acc_d, self.acc_t,
                    cfg_static=aligner._static(), win_shift=tables.win_shift,
                    pos_steps=tables.pos_steps, L_cap=self.L_cap,
                    num_nodes=tables.N_pad, total_bases=tables.TB_pad,
                    num_trios=tables.U_pad,
                    trio_bits=tables.trio_bits, trio_steps=tables.trio_steps,
                    trio_probes=tables.trio_probes, has_dups=tables.has_dups,
                )
                self.acc_b, self.acc_d, self.acc_t = out[:3]
                per_read, ov = out[3:8], (out[8], out[9])
            self._push_batch(
                hi - lo, ids[lo:hi] if ids is not None else None,
                np.asarray(lens[lo:hi]), per_read, ov,
            )
            self._materialize_to(len(self._per_read) - self._MAT_LAG)

    def feed_paired(self, codes1, lens1, codes2, lens2,
                    ids1=None, ids2=None) -> None:
        """Joint fragment-model feed: both mates of each pair go through
        aligner._query_batch_paired (pair scoring + rescue + pair mapq) and
        one coverage scatter.  Per-read rows appear mate1-block then
        mate2-block per dispatched batch."""
        aligner, tables, batch = self.aligner, self.tables, self.batch
        c = aligner.cfg
        if self.use_ranges is None:
            self.use_ranges = self._decide_ranges(
                max(codes1.shape[1], codes2.shape[1])
            )
        if self.use_ranges:
            self._ensure_seg_accs()
        elif self.L_cap is None:
            self.L_cap = auto_node_window(
                aligner.index, max(codes1.shape[1], codes2.shape[1]),
                c.extension_band,
            )
        n = len(lens1)
        if len(lens2) != n:
            raise ValueError("paired feed requires equal mate counts")

        def prep(lo, hi):
            return (self._prep_slice(codes1, lens1, lo, hi),
                    self._prep_slice(codes2, lens2, lo, hi))

        for lo, hi, (mate1, mate2) in self._prepped_batches(prep, n):
            (reads1_dev, lens1_dev) = mate1
            (reads2_dev, lens2_dev) = mate2
            if self.use_ranges:
                out = _fused_step_paired_ranges(
                    aligner.text_d, aligner.run_table_d, aligner.seed_pos_d,
                    aligner.bucket_lo_d, aligner.tstart_d, aligner.tnode_d,
                    tables.hap_offsets_d, tables.hap_range_d,
                    tables.pos_lo_d, tables.trio_seg_d,
                    tables.nodes_len_d, tables.base_offset_d,
                    reads1_dev, lens1_dev, reads2_dev, lens2_dev,
                    self.acc_b, self.acc_d, self.acc_t,
                    self._acc_sn, self._acc_st,
                    cfg_static=aligner._static(), frag_max=c.frag_max,
                    pair_bonus=c.pair_bonus, rescue_frac=c.rescue_frac,
                    win_shift=tables.win_shift,
                    pos_steps=tables.pos_steps, total_bases=tables.TB_pad,
                )
                (self.acc_b, self.acc_d, self.acc_t,
                 self._acc_sn, self._acc_st) = out[:5]
                rows, ov = out[5:10], (0, None)
            else:
                out = _fused_step_paired(
                    aligner.text_d, aligner.run_table_d, aligner.seed_pos_d,
                    aligner.bucket_lo_d, aligner.tstart_d, aligner.tnode_d,
                    tables.hap_offsets_d, tables.hap_range_d,
                    tables.pos_lo_d, tables.trio_seg_d,
                    tables.nodes_len_d, tables.base_offset_d,
                    tables.trio_hash_d, tables.trio_order_d,
                    tables.trio_abc_d, tables.trio_bucket_d,
                    reads1_dev, lens1_dev, reads2_dev, lens2_dev,
                    self.acc_b, self.acc_d, self.acc_t,
                    cfg_static=aligner._static(), frag_max=c.frag_max,
                    pair_bonus=c.pair_bonus, rescue_frac=c.rescue_frac,
                    win_shift=tables.win_shift,
                    pos_steps=tables.pos_steps, L_cap=self.L_cap,
                    num_nodes=tables.N_pad, total_bases=tables.TB_pad,
                    num_trios=tables.U_pad,
                    trio_bits=tables.trio_bits, trio_steps=tables.trio_steps,
                    trio_probes=tables.trio_probes, has_dups=tables.has_dups,
                )
                self.acc_b, self.acc_d, self.acc_t = out[:3]
                rows, ov = out[3:8], (out[8], out[9])
            B = batch
            m = hi - lo
            self._push_batch(
                m, ids1[lo:hi] if ids1 is not None else None,
                np.asarray(lens1[lo:hi]), tuple(a[:B] for a in rows),
                ov,
            )
            self._push_batch(
                m, ids2[lo:hi] if ids2 is not None else None,
                np.asarray(lens2[lo:hi]), tuple(a[B:] for a in rows),
                None,  # one overflow record covers both mates
            )
            self._materialize_to(len(self._per_read) - 2 * self._MAT_LAG)

    _L_INT = 8  # windowed sub-path cap for interval feeds (spans <= this)

    def feed_intervals(self, ts, te, mapq, read_len, ids=None,
                       aligned=None) -> None:
        """Feed pre-aligned text intervals (the long-read flow's merged
        per-read alignments) instead of read codes.  Rows are partitioned on
        host: span <= _L_INT segments -> the windowed classify+scatter;
        longer spans on dup-free haplotypes -> the O(1)-per-read range
        decomposition (_interval_range_step); spans on haplotypes that
        revisit a node -> the exact host residual.  Per-read columns
        (mapq/ridx/read_len) are computed on host — nothing per-read crosses
        the device boundary."""
        aligner, tables, batch = self.aligner, self.tables, self.batch
        index = aligner.index
        ts = np.asarray(ts, dtype=np.int64)
        te = np.asarray(te, dtype=np.int64)
        mapq = np.asarray(mapq, dtype=np.int64)
        read_len = np.asarray(read_len, dtype=np.int64)
        al = (np.ones(len(ts), dtype=bool) if aligned is None
              else np.asarray(aligned, dtype=bool))

        tstart = np.asarray(index.tstart, dtype=np.int64)
        hap_range_h = getattr(tables, "_hap_range_host", None)
        if hap_range_h is None:
            hap_range_h = np.asarray(tables.hap_range_d)
            tables._hap_range_host = hap_range_h
        hap = np.clip(
            np.searchsorted(index.hap_offsets, ts, side="right") - 1,
            0, len(hap_range_h) - 1,
        )
        ridx = np.where(al, hap_range_h[hap], -1).astype(np.int64)
        i0 = np.searchsorted(tstart, ts, side="right") - 1
        i1 = np.searchsorted(tstart, np.maximum(te - 1, ts),
                             side="right") - 1
        span = i1 - i0 + 1
        ok = al & (ridx >= 0) & (te > ts)
        dup = tables.hap_dup[hap]
        # dup-free haplotypes: the generalized range decomposition covers
        # EVERY span (O(1) device updates/read); dup haplotypes keep the
        # windowed step (in-window first-occurrence dedup) for short spans
        # and the exact host residual beyond it
        long_ok = ok & ~dup
        short = ok & dup & (span <= self._L_INT)
        resid = ok & dup & (span > self._L_INT)

        # host per-read rows (identical content to the codes path's
        # device-narrowed columns)
        if self._int_reads is None:
            self._int_reads = {"mapq": [], "aligned": [], "ridx": [],
                               "read_len": [], "ts": [], "te": []}
            self._int_ids = [] if ids is not None else None
        self._int_reads["mapq"].append(mapq)
        self._int_reads["aligned"].append(al)
        self._int_reads["ridx"].append(ridx)
        self._int_reads["read_len"].append(read_len)
        self._int_reads["ts"].append(ts)
        self._int_reads["te"].append(te)
        if ids is not None and self._int_ids is not None:
            self._int_ids.extend(ids)

        if resid.any():
            upd = host_residual_updates(
                index, tables, ts[resid], te[resid], ridx[resid]
            )
            self.acc_b, self.acc_d, self.acc_t = apply_residual(
                (self.acc_b, self.acc_d, self.acc_t), tables, upd
            )
            self._n_int_residual += int(resid.sum())

        from ..utils import prefetched

        def prep_rows(r):
            c_ts = np.zeros(batch, np.int32)
            c_te = np.zeros(batch, np.int32)
            c_live = np.zeros(batch, bool)
            c_ts[: len(r)] = ts[r]
            c_te[: len(r)] = te[r]
            c_live[: len(r)] = True
            return (aligner._shard_reads(c_ts),
                    aligner._shard_reads(c_te),
                    aligner._shard_reads(c_live))

        def chunks(sel):
            # wire uploads (3 small RPCs/batch) run ahead on the prefetch
            # worker so they overlap the interval-step dispatches
            rows = np.flatnonzero(sel)
            slices = [rows[lo:lo + batch]
                      for lo in range(0, len(rows), batch)]
            for _, wire in prefetched(prep_rows, slices):
                yield wire

        for c_ts, c_te, c_live in chunks(short):
            out = _interval_window_step(
                aligner.tstart_d, aligner.tnode_d,
                tables.hap_offsets_d, tables.hap_range_d, tables.pos_lo_d,
                tables.trio_seg_d,
                tables.nodes_len_d, tables.base_offset_d,
                tables.trio_hash_d, tables.trio_order_d, tables.trio_abc_d,
                tables.trio_bucket_d,
                c_ts, c_te, c_live,
                self.acc_b, self.acc_d, self.acc_t,
                win_shift=tables.win_shift, pos_steps=tables.pos_steps,
                L_cap=self._L_INT,
                num_nodes=tables.N_pad, total_bases=tables.TB_pad,
                num_trios=tables.U_pad,
                trio_bits=tables.trio_bits, trio_steps=tables.trio_steps,
                trio_probes=tables.trio_probes, has_dups=tables.has_dups,
            )
            self.acc_b, self.acc_d, self.acc_t = out

        if long_ok.any():
            self._ensure_seg_accs()
        for c_ts, c_te, c_live in chunks(long_ok):
            out = _interval_range_step(
                aligner.tstart_d, aligner.tnode_d,
                tables.hap_offsets_d, tables.hap_range_d, tables.pos_lo_d,
                tables.trio_seg_d,
                tables.nodes_len_d, tables.base_offset_d,
                c_ts, c_te, c_live,
                self.acc_b, self.acc_d, self.acc_t,
                self._acc_sn, self._acc_st,
                win_shift=tables.win_shift, pos_steps=tables.pos_steps,
                total_bases=tables.TB_pad,
            )
            (self.acc_b, self.acc_d, self.acc_t,
             self._acc_sn, self._acc_st) = out

    def _apply_overflow_residual(self) -> int:
        """Host-compute the coverage contributions of reads that overflowed
        the L_cap node window and scatter-add them into the accumulators.
        Intervals come from the dispatch's compact overflow-row table (12KB)
        — the full ts/span buffers are downloaded only for dispatches whose
        overflow count exceeded the table size.  Returns the number of
        residual reads."""
        tstart = np.asarray(self.aligner.index.tstart, dtype=np.int64)
        B = self.batch
        ts_p, te_p, rx_p = [], [], []
        for j, v in enumerate(self._ov):
            if not v:
                continue
            if v <= _OV_CAP:
                idx, ts_a, te_a = np.asarray(self._ov_rows[j]).astype(np.int64)
                live = idx >= 0
                idx, ts_a, te_a = idx[live], ts_a[live], te_a[live]
                rx = np.empty(len(idx), dtype=np.int64)
                for blk, ei in enumerate(self._ov_entries[j]):
                    core_r = np.asarray(self._per_read[ei][3][2])
                    sel = (idx >= blk * B) & (idx < (blk + 1) * B)
                    rx[sel] = core_r[(idx[sel] - blk * B)]
                keep = rx >= 0
                ts_p.append(ts_a[keep])
                te_p.append(te_a[keep])
                rx_p.append(rx[keep])
                continue
            for blk, ei in enumerate(self._ov_entries[j]):
                m, _ids, _lens, core, spans = self._per_read[ei]
                _mapq, al_a, ridx_a = core
                al = np.asarray(al_a)[:m].astype(bool)
                rx = np.asarray(ridx_a)[:m].astype(np.int64)
                ts_m = np.asarray(spans[0])[:m].astype(np.int64)
                te_m = ts_m + np.asarray(spans[1])[:m].astype(np.int64)
                # the device overflow predicate recomputed on host:
                # node span (segment count) >= L_cap + 1
                i0 = np.searchsorted(tstart, ts_m, side="right") - 1
                i1 = np.searchsorted(tstart, np.maximum(te_m - 1, ts_m),
                                     side="right") - 1
                ovf = al & (rx >= 0) & ((i1 - i0) >= self.L_cap)
                ts_p.append(ts_m[ovf])
                te_p.append(te_m[ovf])
                rx_p.append(rx[ovf])
        if not ts_p:
            return 0
        ts_all = np.concatenate(ts_p)
        if not len(ts_all):
            return 0
        upd = host_residual_updates(
            self.aligner.index, self.tables, ts_all,
            np.concatenate(te_p), np.concatenate(rx_p),
        )
        self.acc_b, self.acc_d, self.acc_t = apply_residual(
            (self.acc_b, self.acc_d, self.acc_t), self.tables, upd
        )
        return len(ts_all)

    def finish(self, process_reduce=None):
        """-> FusedResult (tuple-compatible: node_abund [N_pad], trio_abund
        [U_pad], node_base_cov [N_pad], reads dict, n_overflow).  reads holds
        one row per FED read: mapq/aligned/ridx/read_len (+ids list when
        feed() got ids); ts/te are included only when prefetch_spans was set
        — otherwise the interval buffers are dropped (or, for the rare
        batches where a read overflowed L_cap, pulled to host and folded in
        via the host residual path) without a full download.  The three
        dense arrays stay ON DEVICE until first host access — the
        device-resident tail (ops/profile_tail.py) never downloads them.

        ``process_reduce`` (multi-host runs): callable summing the three raw
        accumulators across processes (parallel.distributed.cross_process_sum)
        — applied AFTER this process's overflow residual, BEFORE finalize, so
        every process finalizes the globally merged coverage."""
        tables = self.tables
        self.close(wait=True)
        self._materialize_to(len(self._per_read), len(self._ov))
        ov = int(sum(self._ov))
        if ov:
            n_res = self._apply_overflow_residual()
            log.info(
                "fused: %d reads span more nodes than the L_cap=%d window; "
                "host residual coverage applied", n_res, self.L_cap,
            )
        if self._n_int_residual:
            log.info(
                "fused intervals: %d reads on node-revisiting haplotypes "
                "took the host residual path", self._n_int_residual,
            )
        if self._acc_sn is not None:
            # fold the long-read segment-depth diffs into the accumulators
            self.acc_b, self.acc_d, self.acc_t = _expand_ranges(
                self.acc_b, self.acc_d, self.acc_t,
                self._acc_sn, self._acc_st,
                self.aligner.tnode_d, tables.nodes_len_d,
                tables.base_offset_d, tables.trio_seg_d,
                total_bases=tables.TB_pad,
            )
            self._acc_sn = self._acc_st = None
        if process_reduce is not None:
            merged = process_reduce((self.acc_b, self.acc_d, self.acc_t))
            self.acc_b, self.acc_d, self.acc_t = (
                _put_repl(m, tables.mesh) for m in merged
            )
        na, ta, bc = _fused_finalize(
            self.acc_b, self.acc_d, self.acc_t, tables.nodes_len_d,
            tables.base_offset_d, tables.trio_len_d, num_nodes=tables.N_pad,
        )
        reads = {k: np.zeros(0, np.int64) for k in ("mapq", "aligned",
                                                    "ridx", "read_len")}
        if self.prefetch_spans:
            reads["ts"] = np.zeros(0, np.int64)
            reads["te"] = np.zeros(0, np.int64)
        ids_all: list | None = None
        if self._per_read:
            if self._per_read[0][1] is not None:
                ids_all = []
                for _, ids, _, _, _ in self._per_read:
                    ids_all.extend(ids)
            # per-batch outputs were prefetched to host during the feed loop
            # (_prefetch), so np.asarray here is a cheap local read — the
            # old device-side concatenate paid one big blocking download at
            # the very end instead of streaming it behind the align compute
            B = self.batch
            ms = [m for m, _, _, _, _ in self._per_read]
            valid = np.zeros(len(ms) * B, dtype=bool)
            for i, m in enumerate(ms):
                valid[i * B : i * B + m] = True
            per_col = list(zip(*(core for _, _, _, core, _ in
                                 self._per_read)))
            for name, arrs in zip(("mapq", "aligned", "ridx"), per_col):
                reads[name] = np.concatenate(
                    [np.asarray(a) for a in arrs]
                )[valid] if len(arrs) > 1 else np.asarray(arrs[0])[valid]
            if self.prefetch_spans:
                span_col = list(zip(*(sp for _, _, _, _, sp in
                                      self._per_read)))
                ts = np.concatenate(
                    [np.asarray(a) for a in span_col[0]]
                )[valid]
                span = np.concatenate(
                    [np.asarray(a) for a in span_col[1]]
                )[valid]
                reads["ts"] = ts
                reads["te"] = ts + span
            reads["read_len"] = np.concatenate(
                [lens for _, _, lens, _, _ in self._per_read]
            )
            self._per_read = []  # drop any remaining device interval refs
        if self._int_reads is not None:
            # interval-fed rows (host-computed columns) follow codes rows
            for k in ("mapq", "aligned", "ridx", "read_len"):
                reads[k] = np.concatenate(
                    [reads[k]] + self._int_reads[k]
                ) if len(reads[k]) else np.concatenate(self._int_reads[k])
            if self.prefetch_spans:
                for k in ("ts", "te"):
                    reads[k] = np.concatenate(
                        [reads[k]] + self._int_reads[k]
                    ) if len(reads[k]) else np.concatenate(
                        self._int_reads[k]
                    )
            if self._int_ids is not None:
                ids_all = (ids_all or []) + self._int_ids
        reads["ids"] = ids_all
        # start the accumulators' host copies now (consumer side — the
        # fused programs are done): the HOST tail's _materialize then finds
        # the bytes local instead of paying a blocking download.  Only on
        # small tables where _tail_mode picks the host tail — the device
        # tail never reads these to host.
        if self.tables.N_pad * 8 + self.tables.U_pad * 4 < (4 << 20):
            for a in (na, ta, bc):
                f = getattr(a, "copy_to_host_async", None)
                if f is not None:
                    f()
        return FusedResult(na, ta, bc, reads, ov)


def fused_alignment_coverage(
    aligner, codes, lens, tables: FusedTables, batch: int,
    L_cap: int | None = None,
):
    """One-shot convenience wrapper over FusedPipeline."""
    pipe = FusedPipeline(aligner, tables, batch, L_cap)
    pipe.feed(codes, lens)
    return pipe.finish()


def profile_fused(
    aligner, codes, lens, index, db, cfg, out_dir, batch: int,
    tables: FusedTables | None = None, L_cap: int | None = None,
    stage_out: dict | None = None,
) -> bool:
    """One-shot fused species+strain profiling over a codes matrix.

    Always uses the fused coverage (L_cap-overflow reads are folded in by
    the host residual path inside finish()); returns True."""
    if tables is None:
        tables = build_fused_tables(db, index)
    t0 = time.time()
    pipe = FusedPipeline(aligner, tables, batch, L_cap)
    pipe.feed(codes, lens)
    result = pipe.finish()
    if stage_out is not None:
        stage_out["align_cover_s"] = time.time() - t0
        stage_out["n_aligned"] = int(result[3]["aligned"].sum())
    return profile_from_fused_result(result, tables, index, db, cfg, out_dir)


def _write_classification_tsv(out_path, keep_rows, ids, ridx, mapq, read_len,
                              sp_names) -> None:
    """reads_classification.tsv (id, mapq, species, read_len — no header).

    Arrow assembles + writes the table in C++ with the GIL released (a
    pandas DataFrame of 2M object-dtype ids costs ~7s to even construct and
    holds the GIL, defeating the overlap thread); pandas fallback when
    pyarrow is unavailable.  Output is byte-identical between the two for
    ids without separators/quotes (both quote only when needed)."""
    u_col = np.where(ridx >= 0, ridx, len(sp_names) - 1)

    def _pandas_write():
        import pandas as pd

        species = sp_names[u_col]
        if ids is not None:
            read_ids = np.asarray(ids, dtype=object)[keep_rows]
        else:
            read_ids = np.char.add(
                "R", keep_rows.astype(np.str_)
            ).astype(object)
        pd.DataFrame(
            {"id": read_ids, "mapq": mapq, "species": species,
             "len": read_len}
        ).to_csv(out_path, sep="\t", header=False, index=False)

    try:
        import pyarrow as pa
        import pyarrow.compute as pac
        import pyarrow.csv as pacsv
    except Exception:
        _pandas_write()
        return
    if ids is not None:
        id_col = pac.take(pa.array(ids, pa.string()), pa.array(keep_rows))
    else:
        id_col = pac.binary_join_element_wise(
            "R", pac.cast(pa.array(keep_rows), pa.string()), ""
        )
    sp_col = pac.take(
        pa.array([str(s) for s in sp_names], pa.string()), pa.array(u_col)
    )
    tbl = pa.table({
        "id": id_col, "mapq": pa.array(mapq),
        "species": sp_col, "len": pa.array(read_len),
    })
    try:
        # quoting "none" = raw values (arrow's "needed" still quotes every
        # string); errors if an id embeds the delimiter/quote -> pandas then
        pacsv.write_csv(
            tbl, out_path,
            pacsv.WriteOptions(include_header=False, delimiter="\t",
                               quoting_style="none"),
        )
    except pa.ArrowInvalid:
        _pandas_write()


def profile_from_fused_result(
    result, tables: FusedTables, index, db, cfg, out_dir,
) -> bool:
    """Write species+strain tables from a FusedPipeline.finish() result.

    Reads that overflowed the L_cap node window were already folded into the
    coverage accumulators by finish()'s host residual path, so the fused
    coverage is always complete here.  Returns True (kept for callers that
    branched on the old per-species delegation)."""
    from ..utils.logging import stage_timer

    reads = result[3]
    aligned = reads["aligned"]
    keep_rows = np.flatnonzero(aligned)
    ids = reads["ids"]

    out = os.fspath(out_dir)
    os.makedirs(out, exist_ok=True)
    ridx = reads["ridx"][keep_rows]
    mapq = reads["mapq"][keep_rows]
    read_len = reads["read_len"][keep_rows]
    sp_names = np.array([r.species for r in tables.ranges] + ["U"],
                        dtype=object)
    prof = None
    if os.environ.get("PANTAX_TPU_PROFILE_TAIL"):
        import cProfile

        prof = cProfile.Profile()
        prof.enable()
    ok = _profile_fused_tail(
        tables, db, cfg, out,
        profile_input=(ridx, mapq, read_len, sp_names, result),
    )
    # main-thread write AFTER the profile stages: running the arrow writer
    # on an overlap thread intermittently segfaulted inside libarrow while
    # racing the jax runtime's device callbacks
    with stage_timer("classification table (fused)"):
        _write_classification_tsv(
            os.path.join(out, "reads_classification.tsv"),
            keep_rows, ids, ridx, mapq, read_len, sp_names,
        )
    if prof is not None:
        import pstats

        prof.disable()
        pstats.Stats(prof).sort_stats("cumulative").dump_stats(
            os.environ["PANTAX_TPU_PROFILE_TAIL"]
        )
    return ok


def _ensure_tail_tables(tables):
    """TailTables for the device tail: the prewarm future started at
    pipeline construction (overlapping the align loop), or a synchronous
    build as fallback."""
    from .profile_tail import build_tail_tables

    from ..utils.logging import stage_timer

    tt = getattr(tables, "_tail_tables", None)
    if tt is None:
        fut = getattr(tables, "_tail_tables_fut", None)
        with stage_timer("  tail tables (device)"):
            tt = fut.result() if fut is not None else build_tail_tables(
                tables)
        tables._tail_tables = tt
        tables._tail_tables_fut = None
    return tt


def _device_tail_solve(tables, cfg, active, result, stats_pre=None):
    """Strain filters + two-stage PAO over the DEVICE-resident na/ta/bc
    (ops/profile_tail.py): one tiny stats download, batched on-device solves,
    per-species host fallback only where the node-subsampling cap applies
    (exact RNG semantics need host rows).  Returns the per-species OtuStates
    in ``active`` order, metrics complete.  ``stats_pre``: a
    dispatch_tail_stats handle launched earlier (overlapping the species
    stage); collected here."""
    from ..profile.engine import finish_two_stage, prepare_two_stage
    from ..profile.filters import HapMetrics, OtuState
    from .profile_tail import (
        collect_tail_stats, compute_tail_stats, first_filter_from_stats,
        solve_two_stage_device,
    )

    from ..utils.logging import stage_timer

    if not active:
        return []
    tt = _ensure_tail_tables(tables)
    with stage_timer("  tail stats (device)"):
        if stats_pre is not None:
            stats = collect_tail_stats(stats_pre)
        else:
            stats = compute_tail_stats(
                tt, result.na_d, result.ta_d, result.bc_d, cfg.min_depth
            )
    cap = 500 if cfg.sample_test else cfg.sample_nodes
    out_states: list = []
    jobs, states, host_jobs = [], [], []
    for sp in active:
        si = sp.ridx
        names = sorted(sp.paths)
        state = OtuState(
            otu=sp.range_.species,
            hap_metrics=[HapMetrics() for _ in names],
        )
        first_filter_from_stats(state, si, tt, stats, names, cfg)
        out_states.append(state)
        if not state.possible_paths_idx:
            continue
        g_lo = int(tt.sp_hap_lo[si])
        for h in state.possible_paths_idx:
            g = g_lo + h
            pl = np.float32(tt.path_len[g])
            pc = np.float32(stats.path_cov[g])
            # f32 division mirrors the host matvec path exactly (both sums
            # are integer-valued and exactly representable)
            state.hap_metrics[h].path_cov_ratio = (
                float(pc / pl) if pl > 0 else 0.0
            )
        if cap and stats.sp_valid[si] > cap:
            host_jobs.append((sp, state))
        else:
            ub = 1.05 * float(stats.sp_max[si])
            jobs.append((si, list(state.possible_paths_idx), ub))
            states.append(state)
    if jobs:
        with stage_timer(f"  PAO solves (device, {len(jobs)} species)"):
            solve_two_stage_device(
                tt, result.na_d, jobs, states, cfg, stats.sp_max
            )
    if host_jobs:
        hj = []
        for sp, state in host_jobs:
            na = np.asarray(
                result.na_d[sp.off:sp.off + sp.num_nodes], dtype=np.float64
            )
            bc = np.asarray(result.bc_d[sp.off:sp.off + sp.num_nodes])
            hj.append(prepare_two_stage(
                state, sp.num_nodes, sp.paths, na, bc, sp.nodes_len, cfg
            ))
        finish_two_stage(hj, cfg)
    return out_states


def _tail_mode(tables, cfg) -> str:
    """'device' keeps na/ta/bc on device (ops/profile_tail.py); 'host'
    downloads them and runs the NumPy filters.  'auto' picks device when the
    avoided download is big enough to matter (below the threshold the host
    tail's exact float64 math is cheap)."""
    mode = getattr(cfg, "tail", "auto")
    if mode in ("host", "device"):
        return mode
    dl_bytes = tables.N_pad * 8 + tables.U_pad * 4
    return "device" if dl_bytes >= 4 << 20 else "host"


def _profile_fused_tail(tables, db, cfg, out, profile_input) -> bool:
    from ..io.metadata import read_genomes_info
    from ..profile.engine import finish_two_stage, prepare_two_stage
    from ..profile.filters import HapMetrics, OtuState, first_filter_paths
    from ..profile.report import abundance_constraint, abundance_est
    from ..profile.species import read_species_mean_len, species_profiling_codes
    from ..utils.logging import stage_timer

    (ridx, mapq, read_len, sp_names, result) = profile_input
    keep = ridx >= 0
    # dispatch the device stats reduction BEFORE the host species stage so
    # the two overlap (the stats program only needs the final accumulators;
    # species selection only gates which stats rows are consumed later)
    stats_pre = None
    if cfg.strain and _tail_mode(tables, cfg) == "device":
        from .profile_tail import dispatch_tail_stats

        tt_pre = _ensure_tail_tables(tables)
        stats_pre = dispatch_tail_stats(
            tt_pre, result.na_d, result.ta_d, result.bc_d, cfg.min_depth
        )
    with stage_timer("species profiling (fused)"):
        with stage_timer("  species: gather kept rows"):
            k_ridx, k_len, k_mapq = ridx[keep], read_len[keep], mapq[keep]
        with stage_timer("  species: group+filter"):
            profile = species_profiling_codes(
                k_ridx, sp_names[:-1], k_len, k_mapq,
                read_species_mean_len(db.stats_file), filtered=cfg.filtered,
            )
        profile.save(os.path.join(out, "species_abundance.txt"))
    if not cfg.strain:
        return True

    abundant = {
        str(row["species_taxid"]): float(row["predicted_abundance"])
        for _, row in profile.df.iterrows()
    }
    selected = []
    for sp in tables.species:
        r = sp.range_
        if cfg.mode == 0 and r.is_pan != 0:
            continue
        if cfg.mode == 1 and r.is_pan != 1:
            continue
        if cfg.designated_species and r.species not in cfg.designated_species:
            continue
        if abundant.get(r.species, 0.0) <= cfg.min_species_abundance:
            continue
        selected.append(sp)

    # species with zero classified reads are skipped entirely (fastpath._work
    # returns None on an empty selection — no metrics rows, no constraint)
    counts = np.bincount(
        ridx[keep].astype(np.int64), minlength=len(tables.ranges)
    )

    metrics = []
    active = [sp for sp in selected if counts[sp.ridx]]
    mode = _tail_mode(tables, cfg)
    log.info("- profile tail: %s", mode)
    if mode == "device":
        with stage_timer(
            f"strain profiling ({len(selected)} species, device tail)"
        ):
            states = _device_tail_solve(tables, cfg, active, result,
                                        stats_pre=stats_pre)
    else:
      with stage_timer(f"strain profiling ({len(selected)} species, fused)"):
        node_abund, trio_abund, node_base_cov = result[0], result[1], result[2]

        def _prep(sp):
            na = node_abund[sp.off:sp.off + sp.num_nodes]
            ta = trio_abund[sp.trio_lo:sp.trio_hi]
            bc = node_base_cov[sp.off:sp.off + sp.num_nodes]
            state = OtuState(
                otu=sp.range_.species,
                hap_metrics=[HapMetrics() for _ in sp.paths],
            )
            na_opt = np.where(na > cfg.min_depth, na, 0.0)
            first_filter_paths(
                state, sp.paths, sp.trio_index.hap_matrix, ta, na_opt, cfg
            )
            job = None
            if state.possible_paths_idx:
                job = prepare_two_stage(
                    state, sp.num_nodes, sp.paths, na, bc, sp.nodes_len, cfg
                )
            return state, job

        if len(active) > 1:
            # per-species filters/coeff prep is independent numpy (the
            # reference's rayon axis, profile.rs:3297) — thread it like
            # engine.strain_profiling does
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(8, len(active))) as ex:
                prepared = list(ex.map(_prep, active))
        else:
            prepared = [_prep(sp) for sp in active]
        with stage_timer("PAO solves (fused)"):
            finish_two_stage([j for _, j in prepared if j is not None], cfg)
        states = [state for state, _ in prepared]
    for state in states:
        abundance_constraint(profile, state.hap_metrics)
        metrics.extend(state.hap_metrics)

    with stage_timer("abundance report (fused)"):
        genomes_info = read_genomes_info(db.genomes_info_file)
        abundance_est(cfg, metrics, genomes_info, out)
    return True
