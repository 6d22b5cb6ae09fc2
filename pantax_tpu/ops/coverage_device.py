"""Full-parity device coverage: node bases, exact per-base counts, and
trio-node coverage as one jitted JAX computation.

This is the device port of profile/coverage.py (itself the oracle for the
reference's get_node_abundances, /root/reference/pantax/src/profile.rs:742-1026):

  - per-(read, position) base allocation with first-occurrence dedup (sorting
    node ids within each read row — rows are independent, so axis-1 sorts
    replace the host lexsort);
  - exact per-base coverage via a scatter-add diff array over the flat base
    space and a segment-sum back to nodes;
  - trio windows matched against a sorted hash table of the unique trios
    (canonical orientation, linear probe with equality verification).

Padded shapes are static: bucket reads by max path length L before calling.
When the read batch is sharded over a mesh axis, the three dense outputs are
cross-shard reductions XLA lowers to psums.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


def _mix3(a, b, c):
    """32-bit hash of a canonical (a, b, c) node triple."""
    h = a.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
    h = (h ^ b.astype(jnp.uint32)) * jnp.uint32(0x85EBCA6B)
    h = (h ^ c.astype(jnp.uint32)) * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)


def build_hash_lookup(hash_sorted: np.ndarray, n_real: int):
    """(bucket_lo int32 [nb+1], bits, steps, probes) for _hash_bisect_left.

    jnp.searchsorted over a U-entry sorted table costs log2(U) SERIAL gather
    rounds; bucketing by the top
    ``bits`` of the uniform hash cuts that to ~2-3 in-bucket bisection steps.
    ``probes`` is the longest run of equal hashes among the n_real live
    entries (the sentinel pad run is excluded — sentinels never match a
    probe's abc verification), so the linear probe depth is exact, not a
    heuristic."""
    hs = np.asarray(hash_sorted, dtype=np.uint64)[:n_real]  # exclude sentinel
    bits = int(np.clip(int(np.ceil(np.log2(max(n_real, 2)))) + 2, 8, 22))
    nb = 1 << bits
    bounds = np.arange(nb + 1, dtype=np.uint64) << np.uint64(32 - bits)
    lo = np.searchsorted(hs, bounds, side="left").astype(np.int32)
    occ = int(np.diff(lo).max()) if nb else 0
    steps = int(np.ceil(np.log2(occ + 1))) + 1 if occ > 0 else 0
    if n_real > 1:
        brk = np.flatnonzero(np.diff(hs[:n_real]) != 0)  # longest equal run
        edges = np.concatenate([[-1], brk, [n_real - 1]])
        best = int(np.diff(edges).max())
    else:
        best = 1
    return lo, bits, steps, max(best, 1)


def _hash_bisect_left(table, bucket_lo, bits: int, steps: int, h):
    """searchsorted(table, h, side='left') via static-depth in-bucket
    bisection (table uint32 ascending, h uint32)."""
    U = table.shape[0]
    b = (h >> jnp.uint32(32 - bits)).astype(jnp.int32)
    lo = bucket_lo[b]
    hi = bucket_lo[b + 1]
    for _ in range(steps):
        mid = (lo + hi) >> 1
        key = table[jnp.clip(mid, 0, U - 1)]
        go = key < h
        open_ = lo < hi
        lo = jnp.where(open_ & go, mid + 1, lo)
        hi = jnp.where(open_ & ~go, mid, hi)
    return lo


@dataclass
class DeviceGraphCoverageTables:
    """Static per-species device arrays for coverage computation."""

    nodes_len: jnp.ndarray      # int32 [N]
    base_offset: jnp.ndarray    # int32 [N + 1]
    trio_hash_sorted: jnp.ndarray  # uint32 [U]
    trio_order: jnp.ndarray        # int32 [U] -> original trio index
    trio_abc_sorted: jnp.ndarray   # int32 [U, 3] canonical triples, hash order

    @classmethod
    def build(cls, nodes_len: np.ndarray, trio_nodes: np.ndarray):
        nodes_len = np.asarray(nodes_len, dtype=np.int32)
        base_offset = np.zeros(len(nodes_len) + 1, dtype=np.int32)
        np.cumsum(nodes_len, out=base_offset[1:])
        tn = np.asarray(trio_nodes, dtype=np.int64).reshape(-1, 3)
        h = np.asarray(
            _mix3(jnp.asarray(tn[:, 0]), jnp.asarray(tn[:, 1]), jnp.asarray(tn[:, 2]))
        ) if len(tn) else np.zeros(0, np.uint32)
        order = np.argsort(h, kind="stable").astype(np.int32)
        return cls(
            nodes_len=jnp.asarray(nodes_len),
            base_offset=jnp.asarray(base_offset),
            trio_hash_sorted=jnp.asarray(h[order]),
            trio_order=jnp.asarray(order),
            trio_abc_sorted=jnp.asarray(tn[order].astype(np.int32)),
        )


def _coverage_scatter(
    nodes,          # int32 [R, L] local node ids, -1 pad
    lengths,        # int32 [R]
    read_start,     # int32 [R]
    read_end,       # int32 [R]
    nodes_len,      # int32 [N]
    base_offset,    # int32 [N + 1]
    trio_hash_sorted,   # uint32 [U]
    trio_order,         # int32 [U]
    trio_abc_sorted,    # int32 [U, 3]
    *,
    num_nodes: int,
    total_bases: int,
    num_trios: int,
    acc=None,
    trio_bucket=None,
    trio_bits: int = 0,
    trio_steps: int = 0,
    trio_probes: int = 4,
    has_dups: bool = True,
    trio_match=None,
):
    """Per-batch additive coverage contributions: every output is a plain sum
    over reads, so batches can be accumulated (the fused align+cover pipeline
    carries these as donated device accumulators) and _coverage_finalize
    applied once at the end — bit-identical to a single whole-batch call.

    Returns (bases_per_node f32 [N], diff i32 [TB+1] — the per-base coverage
    DIFFERENCE array, cumsummed only in finalize because "covered bases"
    itself is not additive — and trio_bases f32 [U]).

    ``acc`` (optional) is a prior (bases, diff, trio) triple to scatter INTO:
    when the caller donates these buffers the updates are in place, so the
    big [TB+1] diff array is touched once per batch instead of being
    materialized fresh and then added.

    ``trio_bucket``/``trio_bits``/``trio_steps`` (from build_hash_lookup)
    replace the trio-table searchsorted's log2(U) serial gather rounds with a
    bucketed bisection; ``trio_probes`` is the exact max equal-hash run.
    ``has_dups=False`` skips the first-occurrence dedup sorts when the caller
    proves no node repeats within any read window (fused path, host-checked):
    then every occurrence IS a first occurrence.

    ``trio_match`` (int32 [R, L-2], -1 = no match) bypasses the hash lookup
    entirely with precomputed unique-trio indices per window — the fused
    path's windows are consecutive text segments, so their matches are baked
    into a per-segment table at build time (build_fused_tables.trio_seg) and
    the whole hash+bisect+probe pipeline (the dominant scatter cost)
    collapses to one gather done by the caller."""
    if acc is None:
        acc_b = jnp.zeros(num_nodes, dtype=jnp.float32)
        acc_d = jnp.zeros(total_bases + 1, dtype=jnp.int32)
        acc_t = jnp.zeros(num_trios, dtype=jnp.float32)
    else:
        acc_b, acc_d, acc_t = acc
    R, L = nodes.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    valid = pos < lengths[:, None]
    node_ids = jnp.where(valid, nodes, 0)
    nlen = nodes_len[node_ids].astype(jnp.int32)

    is_first = pos == 0
    is_last = pos == (lengths - 1)[:, None]
    target = (read_end - read_start)[:, None]
    single = lengths[:, None] == 1

    first_alloc = nlen - read_start[:, None]
    alloc_nolast = jnp.where(is_first, first_alloc, nlen)
    alloc_tmp = jnp.where(valid, alloc_nolast, 0)
    seen_before = jnp.cumsum(alloc_tmp, axis=1) - alloc_tmp
    last_alloc = jnp.maximum(target - seen_before, 0)
    alloc = jnp.where(is_last, last_alloc, alloc_nolast)
    alloc = jnp.where(single, target, alloc)
    start_idx = jnp.where(is_first | single, read_start[:, None], 0)
    dropped = single[:, 0] & (target[:, 0] < 0)
    valid = valid & ~dropped[:, None]
    alloc = jnp.where(valid, alloc, 0)

    # first occurrence + broadcast of the first-occurrence allocation.
    # Small windows (the fused path's L_cap) use an O(L^2) equality mask +
    # one-hot matmul: fully parallel elementwise work and one batched
    # product, replacing two row
    # argsorts and an L-step serial scan.  Wide windows (GAF node paths,
    # L up to 1024) keep the sort formulation, whose L^2 mask would not fit.
    if has_dups and L <= 64:
        nid = jnp.where(valid, node_ids, -1)
        both = valid[:, None, :] & valid[:, :, None]
        eq = (nid[:, None, :] == nid[:, :, None]) & both  # [R, k, j]
        cum = jnp.cumsum(eq.astype(jnp.int32), axis=1)
        firstmask = eq & (cum == 1)         # k = first occurrence of node[j]
        first_occ = jnp.diagonal(firstmask, axis1=1, axis2=2)  # j is its own first
        # value at j = alloc at j's first occurrence (exactly one k matches)
        # HIGHEST: alloc can exceed 2^11, beyond what TF32 holds exactly
        per_pos_val = jnp.einsum(
            "rkj,rk->rj", firstmask.astype(jnp.float32),
            alloc.astype(jnp.float32), precision=jax.lax.Precision.HIGHEST,
        ).astype(alloc.dtype)
        per_pos_val = jnp.where(valid, per_pos_val, 0)
    elif has_dups:
        sort_node = jnp.where(valid, node_ids, num_nodes)  # pads group last
        # jnp.argsort is stable and positions are already ascending within
        # each row, so sorting on the node id alone yields (node, pos) order —
        # a composite node*L+pos key would overflow int32 on large graphs.
        order = jnp.argsort(sort_node, axis=1)
        node_sorted = jnp.take_along_axis(sort_node, order, axis=1)
        alloc_sorted = jnp.take_along_axis(alloc, order, axis=1)
        is_start = jnp.concatenate(
            [jnp.ones((R, 1), bool), node_sorted[:, 1:] != node_sorted[:, :-1]],
            axis=1,
        )
        first_val_sorted = jnp.where(is_start, alloc_sorted, 0)
        # propagate via segment-max style scan: since only group starts are
        # nonzero, a prefix "carry" works: carry[i] = latest start's value
        def carry_scan(c, x):
            v, s = x
            c = jnp.where(s, v, c)
            return c, c
        _, bcast_sorted = jax.lax.scan(
            carry_scan,
            jnp.zeros(R, dtype=alloc.dtype),
            (first_val_sorted.T, is_start.T),
        )
        bcast_sorted = bcast_sorted.T
        inv = jnp.argsort(order, axis=1)
        first_occ = jnp.take_along_axis(is_start, inv, axis=1) & valid
        per_pos_val = jnp.take_along_axis(bcast_sorted, inv, axis=1)
        per_pos_val = jnp.where(valid, per_pos_val, 0)
    else:
        first_occ = valid
        per_pos_val = alloc

    # bases per node (first occurrences only)
    contrib = jnp.where(first_occ, alloc, 0).astype(jnp.float32)
    bases_per_node = acc_b.at[node_ids.reshape(-1)].add(
        contrib.reshape(-1), mode="drop"
    )

    # exact per-base coverage: scatter the interval difference array only
    # (cumsum + >0 count happen in _coverage_finalize)
    lo_in = jnp.clip(start_idx, 0, nlen)
    hi_in = jnp.clip(start_idx + alloc, lo_in, nlen)
    iv_lo = base_offset[node_ids] + lo_in
    iv_hi = base_offset[node_ids] + hi_in
    in_bounds = (read_start < read_end)[:, None] & (read_end[:, None] <= nlen)
    keep = valid & (~single | in_bounds)
    lo = jnp.where(keep, iv_lo, total_bases).reshape(-1)
    hi = jnp.where(keep, iv_hi, total_bases).reshape(-1)
    diff = acc_d.at[lo].add(1).at[hi].add(-1)

    # trio windows
    if num_trios > 0 and L >= 3:
        w_valid = ((pos[:, : L - 2] + 2) < lengths[:, None]) & (
            lengths >= 3
        )[:, None]
        win_sum = (
            per_pos_val[:, :-2] + per_pos_val[:, 1:-1] + per_pos_val[:, 2:]
        ).astype(jnp.float32)
        if trio_match is not None:
            match = trio_match.reshape(-1)
        else:
            wa, wb, wc = node_ids[:, :-2], node_ids[:, 1:-1], node_ids[:, 2:]
            flip = wa > wc
            ca = jnp.where(flip, wc, wa)
            cc = jnp.where(flip, wa, wc)
            h = _mix3(ca, wb, cc)
            if trio_bucket is not None:
                idx0 = _hash_bisect_left(
                    trio_hash_sorted, trio_bucket, trio_bits, trio_steps,
                    h.reshape(-1),
                )
            else:
                idx0 = jnp.searchsorted(trio_hash_sorted, h.reshape(-1))
            # linear probe (hash collisions): check the equal-hash run
            match = jnp.full(idx0.shape, -1, dtype=jnp.int32)
            caf, wbf, ccf = ca.reshape(-1), wb.reshape(-1), cc.reshape(-1)
            for probe in range(trio_probes):
                cand = jnp.clip(idx0 + probe, 0, num_trios - 1)
                abc = trio_abc_sorted[cand]
                hit = (
                    (abc[:, 0] == caf) & (abc[:, 1] == wbf)
                    & (abc[:, 2] == ccf) & (match < 0)
                )
                match = jnp.where(hit, trio_order[cand], match)
        wvf = w_valid.reshape(-1)
        # sentinel index num_trios is out of bounds -> dropped by the scatter
        seg = jnp.where(wvf & (match >= 0), match, num_trios)
        trio_bases = acc_t.at[seg].add(
            jnp.where(wvf, win_sum.reshape(-1), 0.0), mode="drop"
        )
    else:
        trio_bases = acc_t

    return bases_per_node, diff, trio_bases


def _coverage_finalize(
    bases_per_node, diff, trio_bases, nodes_len, base_offset, trio_len,
    num_nodes: int,
):
    """Accumulated scatter sums -> (node_abundance, trio_abundance,
    node_base_cov): one diff-array cumsum, covered-base counts per node via
    a SECOND prefix sum gathered at the node base offsets (a segment_sum
    over the TB-length base->node table costs a TB-element scatter — ~1s at
    33M bases — where two scans + an [N+1] gather are bandwidth-cheap), and
    the length normalizations."""
    covered = (jnp.cumsum(diff[:-1]) > 0).astype(jnp.int32)
    prefix = jnp.concatenate(
        [jnp.zeros(1, dtype=jnp.int32), jnp.cumsum(covered)]
    )
    node_base_cov = prefix[base_offset[1:]] - prefix[base_offset[:-1]]
    node_abundance = bases_per_node / jnp.maximum(nodes_len, 1)
    trio_abundance = trio_bases / jnp.maximum(trio_len.astype(jnp.float32), 1.0)
    return node_abundance, trio_abundance, node_base_cov


def _node_abundances_impl(
    nodes,          # int32 [R, L] local node ids, -1 pad
    lengths,        # int32 [R]
    read_start,     # int32 [R]
    read_end,       # int32 [R]
    nodes_len,      # int32 [N]
    base_offset,    # int32 [N + 1]
    trio_hash_sorted,   # uint32 [U]
    trio_order,         # int32 [U]
    trio_abc_sorted,    # int32 [U, 3]
    trio_len,           # int32 [U] (original order)
    trio_bucket=None,   # int32 [nb + 1] (build_hash_lookup), optional
    *,
    num_nodes: int,
    total_bases: int,
    num_trios: int,
    trio_bits: int = 0,
    trio_steps: int = 0,
    trio_probes: int = 4,
    has_dups: bool = True,
):
    bases_per_node, diff, trio_bases = _coverage_scatter(
        nodes, lengths, read_start, read_end, nodes_len, base_offset,
        trio_hash_sorted, trio_order, trio_abc_sorted,
        num_nodes=num_nodes, total_bases=total_bases, num_trios=num_trios,
        trio_bucket=trio_bucket, trio_bits=trio_bits, trio_steps=trio_steps,
        trio_probes=trio_probes, has_dups=has_dups,
    )
    return _coverage_finalize(
        bases_per_node, diff, trio_bases, nodes_len, base_offset, trio_len,
        num_nodes=num_nodes,
    )


device_node_abundances = partial(
    jax.jit,
    static_argnames=(
        "num_nodes", "total_bases", "num_trios",
        "trio_bits", "trio_steps", "trio_probes", "has_dups",
    ),
)(_node_abundances_impl)


_SHARDED_CACHE: dict = {}


def sharded_node_abundances(
    mesh, num_nodes: int, total_bases: int, num_trios: int,
    trio_bits: int = 0, trio_steps: int = 0, trio_probes: int = 4,
):
    """device_node_abundances jitted over ``mesh`` with the read batch sharded
    along the "reads" axis; graph tables replicated; the three dense outputs
    replicated (XLA merges the per-shard segment-sums with psums across devices).

    Every per-read contribution is an integer-valued float32 / int32, so the
    cross-shard reduction is exact and the outputs are bit-identical to the
    single-device computation (guarded by tests/test_parallel.py).
    """
    key = (id(mesh), num_nodes, total_bases, num_trios,
           trio_bits, trio_steps, trio_probes)
    fn = _SHARDED_CACHE.get(key)
    if fn is None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        reads = NamedSharding(mesh, P("reads"))
        repl = NamedSharding(mesh, P())
        fn = jax.jit(
            partial(
                _node_abundances_impl,
                num_nodes=num_nodes,
                total_bases=total_bases,
                num_trios=num_trios,
                trio_bits=trio_bits,
                trio_steps=trio_steps,
                trio_probes=trio_probes,
            ),
            in_shardings=(
                reads, reads, reads, reads,          # nodes, lengths, rs, re
                repl, repl,                          # nodes_len, base_offset
                repl, repl, repl, repl,              # trio tables
                repl,                                # trio_bucket
            ),
            out_shardings=(repl, repl, repl),
        )
        _SHARDED_CACHE[key] = fn
    return fn


def _pow2(n: int, lo: int = 256) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


@dataclass
class PaddedCoverageTables:
    """Power-of-two padded graph tables for the jitted coverage kernel.

    Padding is inert: pad nodes have length 1 and are never referenced by
    reads; pad bases map to the last pad node; pad trios carry sentinel
    hashes and length 1."""

    nodes_len: jnp.ndarray      # int32 [N_pad]
    base_offset: jnp.ndarray    # int32 [N_pad + 1]
    trio_hash: jnp.ndarray      # uint32 [U_pad]
    trio_order: jnp.ndarray     # int32 [U_pad]
    trio_abc: jnp.ndarray      # int32 [U_pad, 3]
    trio_len: jnp.ndarray       # int32 [U_pad]
    trio_bucket: jnp.ndarray    # int32 [nb + 1] hash-bucket table
    trio_bits: int
    trio_steps: int
    trio_probes: int
    N: int
    U: int
    N_pad: int
    TB_pad: int
    U_pad: int


def build_padded_tables(nodes_len, trio_nodes, trio_len) -> PaddedCoverageTables:
    """Pad graph coverage tables to power-of-two bucket shapes so graphs of
    different sizes share compiled kernels."""
    nodes_len = np.asarray(nodes_len)
    N = len(nodes_len)
    U = len(trio_len)
    N_pad = _pow2(N + 1)
    nodes_len_p = np.ones(N_pad, dtype=np.int64)
    nodes_len_p[:N] = nodes_len
    tables = DeviceGraphCoverageTables.build(nodes_len_p, trio_nodes)
    TB = int(np.asarray(tables.base_offset)[-1])
    TB_pad = _pow2(TB)
    U_pad = _pow2(U, lo=64)
    trio_hash = np.full(U_pad, np.iinfo(np.uint32).max, dtype=np.uint32)
    trio_hash[:U] = np.asarray(tables.trio_hash_sorted)
    trio_order = np.zeros(U_pad, dtype=np.int32)
    trio_order[:U] = np.asarray(tables.trio_order)
    trio_abc = np.full((U_pad, 3), -1, dtype=np.int32)
    trio_abc[:U] = np.asarray(tables.trio_abc_sorted)
    trio_len_p = np.ones(U_pad, dtype=np.int32)
    trio_len_p[:U] = trio_len
    bucket_lo, bits, steps, probes = build_hash_lookup(trio_hash, U)
    return PaddedCoverageTables(
        trio_bucket=jnp.asarray(bucket_lo),
        trio_bits=bits,
        trio_steps=steps,
        trio_probes=probes,
        nodes_len=tables.nodes_len,
        base_offset=tables.base_offset,
        trio_hash=jnp.asarray(trio_hash),
        trio_order=jnp.asarray(trio_order),
        trio_abc=jnp.asarray(trio_abc),
        trio_len=jnp.asarray(trio_len_p),
        N=N, U=U, N_pad=N_pad, TB_pad=TB_pad, U_pad=U_pad,
    )


def node_abundances_device(packed, nodes_len, trio_index, mesh=None):
    """Convenience wrapper over numpy inputs (PackedReads + TrioIndex).

    All static dimensions (reads, path length, nodes, bases, trios) are padded
    to power-of-two buckets so different species share compiled shapes.

    ``mesh`` (or the process default mesh, parallel.default_mesh()) shards the
    read batch over the mesh's "reads" axis; outputs are psum-merged and
    bit-identical to the single-device result.
    """
    if mesh is None:
        from ..parallel import default_mesh

        mesh = default_mesh()
    t = build_padded_tables(nodes_len, trio_index.trio_nodes, trio_index.trio_len)
    N, U, N_pad, TB_pad, U_pad = t.N, t.U, t.N_pad, t.TB_pad, t.U_pad

    R, L = packed.nodes.shape
    R_pad = _pow2(R)
    if mesh is not None:
        n_dev = int(mesh.devices.size)
        if R_pad % n_dev:  # non-power-of-two meshes
            R_pad = ((R_pad + n_dev - 1) // n_dev) * n_dev
    L_pad = _pow2(max(L, 4), lo=4)
    nodes_p = np.full((R_pad, L_pad), -1, dtype=np.int32)
    nodes_p[:R, :L] = packed.nodes
    lengths_p = np.zeros(R_pad, dtype=np.int32)
    lengths_p[:R] = packed.lengths
    rs_p = np.zeros(R_pad, dtype=np.int32)
    rs_p[:R] = packed.read_start
    re_p = np.zeros(R_pad, dtype=np.int32)
    re_p[:R] = packed.read_end

    dyn_args = (
        jnp.asarray(nodes_p), jnp.asarray(lengths_p),
        jnp.asarray(rs_p), jnp.asarray(re_p),
        t.nodes_len, t.base_offset,
        t.trio_hash, t.trio_order, t.trio_abc, t.trio_len, t.trio_bucket,
    )
    if mesh is None:
        na, ta, bc = device_node_abundances(
            *dyn_args, num_nodes=N_pad, total_bases=TB_pad, num_trios=U_pad,
            trio_bits=t.trio_bits, trio_steps=t.trio_steps,
            trio_probes=t.trio_probes,
        )
    else:
        na, ta, bc = sharded_node_abundances(
            mesh, N_pad, TB_pad, U_pad,
            trio_bits=t.trio_bits, trio_steps=t.trio_steps,
            trio_probes=t.trio_probes,
        )(*dyn_args)
    return (
        np.asarray(na, dtype=np.float64)[:N],
        np.asarray(ta, dtype=np.float64)[:U],
        np.asarray(bc)[:N],
    )
