"""Device-resident strain-profiling tail for the fused pipeline.

The fused align+coverage pipeline finishes with three dense device arrays
(node abundance, trio abundance, per-node covered bases).  The host tail
(ops/fused._profile_fused_tail) downloads all three (~50MB at the 102-strain
scale), runs the strain filters in NumPy, and
re-uploads every species' PAO coefficient matrix and b vector.  This module
keeps those arrays ON the device:

  1. one jitted stats program reduces them to a few hundred per-strain /
     per-species scalars (trio fraction, zscore-filtered trio-coverage mean,
     path base-coverage, species max/nonzero-mean) — the only download;
  2. the first-filter BRANCH LOGIC runs on host over those scalars,
     mirroring profile/filters.first_filter_paths line for line
     (profile.rs:1080-1227 parity; guarded by an exact-stats unit test);
  3. the PAO solves build their coefficient matrices on device from static
     path tables (uploaded once per database), reuse the batched ADMM from
     profile/pao.py, and replace the host polish with a device coordinate-
     median polish — only the [S, p] solution vectors come back.

Semantics match the host tail up to float32-reduction rounding (the host
reduces in float64); the strict bit-level tests therefore keep the host
tail, and ProfilingConfig.tail gates this path ('auto' enables it when the
download it avoids is large enough to matter).

Reference parity anchors: get_node_abundances consumers profile.rs:1080-1511
(first filter, gurobi_opt first/second solve), rayon species axis
profile.rs:3297 (here: the batch axis of the stacked device solves).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import ProfilingConfig
from ..profile.filters import OtuState, _round2
from ..profile.pao import _admm_chunk_batch, _bucket


# ---------------------------------------------------------------------------
# static tables
# ---------------------------------------------------------------------------
_ROW = 256                      # elements per row of a SegmentLayout
_FILL = np.iinfo(np.int32).max  # layout padding: an index that reads as 0


class SegmentLayout(NamedTuple):
    """Static gather plan for a deterministic segment sum (segment_sum).

    ``rows[r]`` indexes up to _ROW values of ONE segment; ``segs[k]`` lists
    the rows of segment k.  Both are padded with _FILL, which gathers as 0.
    Summing rows then segments is a fixed reduction tree: a scatter-add
    would sum floats in a run-dependent order on a GPU (atomics)."""

    rows: jnp.ndarray  # int32 [R, _ROW] value index
    segs: jnp.ndarray  # int32 [K, M] row index


def segment_layout(seg, num_segments: int, src=None) -> SegmentLayout:
    """Layout for summing ``vals[src[i]]`` (``vals[i]`` without ``src``)
    into segment ``seg[i]``; ids >= num_segments are dropped."""
    seg = np.asarray(seg, dtype=np.int64)
    keep = np.flatnonzero(seg < num_segments)
    order = keep[np.argsort(seg[keep], kind="stable")]
    sid = seg[order]
    counts = np.bincount(sid, minlength=num_segments)
    nrows = -(-counts // _ROW)
    row_off = np.concatenate([[0], np.cumsum(nrows)])
    seg_start = np.concatenate([[0], np.cumsum(counts)])
    rows = np.full((max(int(row_off[-1]), 1), _ROW), _FILL, dtype=np.int32)
    slot = row_off[sid] * _ROW + np.arange(len(order)) - seg_start[sid]
    idx = order if src is None else np.asarray(src)[order]
    rows.reshape(-1)[slot] = idx
    j = np.arange(max(int(nrows.max(initial=0)), 1))
    segs = np.where(j < nrows[:, None], row_off[:-1, None] + j, _FILL)
    return SegmentLayout(jnp.asarray(rows), jnp.asarray(segs.astype(np.int32)))


def _segment_sum(vals, lay: SegmentLayout):
    part = vals.at[lay.rows].get(mode="fill", fill_value=0).sum(axis=1)
    return part.at[lay.segs].get(mode="fill", fill_value=0).sum(axis=1)


@dataclass
class TailTables:
    """Static device tables for the tail stats + device PAO (built once per
    database, alongside FusedTables)."""

    # device arrays
    trio_hap_d: jnp.ndarray      # int32 [U_pad] owning global hap, G = pad
    path_node_d: jnp.ndarray     # int32 [Pn] global node ids grouped by hap
    node_species_d: jnp.ndarray  # int32 [N_pad] species index, S = pad
    trio_lay: SegmentLayout      # trio -> owning hap
    path_lay: SegmentLayout      # path node -> hap (gathers node ids)
    node_lay: SegmentLayout      # node -> species
    # host metadata
    hap_node_off: np.ndarray     # int64 [G + 1] slice of path_node_d per hap
    trio_count: np.ndarray       # int64 [G] unique trios owned per hap
    path_len: np.ndarray         # float64 [G] sum of node lengths over path
    hap_species: np.ndarray      # int32 [G] species index of each hap
    hap_local: np.ndarray        # int32 [G] hap index within its species
    sp_hap_lo: np.ndarray        # int64 [S + 1] hap slice per species
    sp_all_same: np.ndarray      # bool [S] all paths identical
    sp_m_size: np.ndarray        # int64 [S] hap_matrix.size per species
    sp_nvert: np.ndarray         # int64 [S]
    sp_off: np.ndarray           # int64 [S] global node offset
    G: int
    S: int


def build_tail_tables(tables) -> TailTables:
    """Build from an ops.fused.FusedTables (its species list carries paths,
    trio indices and global offsets)."""
    species = tables.species
    S = len(species)
    trio_hap = np.full(tables.U_pad, 0, dtype=np.int32)
    # pad trios point at hap G (dropped by segment_layout(.., G))
    path_node_parts: list[np.ndarray] = []
    trio_count: list[int] = []
    path_len: list[float] = []
    hap_species: list[int] = []
    hap_local: list[int] = []
    sp_hap_lo = np.zeros(S + 1, dtype=np.int64)
    sp_all_same = np.zeros(S, dtype=bool)
    sp_m_size = np.zeros(S, dtype=np.int64)
    sp_nvert = np.zeros(S, dtype=np.int64)
    sp_off = np.zeros(S, dtype=np.int64)
    g = 0
    for si, sp in enumerate(species):
        names = sorted(sp.paths)
        ti = sp.trio_index
        hm = np.asarray(ti.hap_matrix)
        # each unique trio is owned by exactly one hap (counts == 1 across
        # paths, graph/trio.py:100-109) -> owner = argmax of its 0/1 row
        if hm.size:
            owner = np.argmax(hm, axis=1).astype(np.int64)
            trio_hap[sp.trio_lo:sp.trio_hi] = (g + owner).astype(np.int32)
        for h, name in enumerate(names):
            p = np.asarray(sp.paths[name], dtype=np.int64)
            path_node_parts.append((p + sp.off).astype(np.int32))
            trio_count.append(int((hm[:, h] > 0).sum()) if hm.size else 0)
            # float32 accumulation parity with the host matvec
            # (engine.prepare_two_stage: node_len.astype(f32) @ coeff)
            path_len.append(
                float(np.asarray(sp.nodes_len, dtype=np.float32)[p].sum(
                    dtype=np.float32))
            )
            hap_species.append(si)
            hap_local.append(h)
        path_list = [np.asarray(sp.paths[n]) for n in names]
        sp_all_same[si] = all(
            np.array_equal(path_list[0], q) for q in path_list[1:]
        )
        sp_m_size[si] = hm.size
        sp_nvert[si] = sp.num_nodes
        sp_off[si] = sp.off
        g += len(names)
        sp_hap_lo[si + 1] = g
    G = g
    # pad-trio rows must not leak into real haps: point them at G (dropped)
    pad_mask = np.ones(tables.U_pad, dtype=bool)
    for sp in species:
        pad_mask[sp.trio_lo:sp.trio_hi] = False
    trio_hap[pad_mask] = G

    path_node = (
        np.concatenate(path_node_parts)
        if path_node_parts else np.zeros(0, np.int32)
    )
    hap_node_off = np.zeros(G + 1, dtype=np.int64)
    np.cumsum([len(p) for p in path_node_parts], out=hap_node_off[1:])
    path_hap = np.repeat(
        np.arange(G, dtype=np.int32),
        [len(p) for p in path_node_parts],
    ) if G else np.zeros(0, np.int32)

    node_species = np.full(tables.N_pad, S, dtype=np.int32)
    for si, sp in enumerate(species):
        node_species[sp.off:sp.off + sp.num_nodes] = si

    return TailTables(
        trio_hap_d=jnp.asarray(trio_hap),
        path_node_d=jnp.asarray(path_node),
        node_species_d=jnp.asarray(node_species),
        trio_lay=segment_layout(trio_hap, G),
        path_lay=segment_layout(path_hap, G, src=path_node),
        node_lay=segment_layout(node_species, S),
        hap_node_off=hap_node_off,
        trio_count=np.asarray(trio_count, dtype=np.int64),
        path_len=np.asarray(path_len, dtype=np.float64),
        hap_species=np.asarray(hap_species, dtype=np.int32),
        hap_local=np.asarray(hap_local, dtype=np.int32),
        sp_hap_lo=sp_hap_lo,
        sp_all_same=sp_all_same,
        sp_m_size=sp_m_size,
        sp_nvert=sp_nvert,
        sp_off=sp_off,
        G=G,
        S=S,
    )


# ---------------------------------------------------------------------------
# stats program
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("G", "S"))
def _tail_stats(
    na, ta, bc, trio_hap, node_species, trio_lay, path_lay, node_lay,
    min_depth, *, G: int, S: int,
):
    """All host-filter inputs as [G]/[S] reductions (one tiny download).

    Mirrors, in float32: per-hap nonzero trio count / zscore(3)-filtered
    nonzero mean (filters.py:85-113), per-hap path base coverage
    (engine.prepare_two_stage path_cov), per-species nonzero mean of the
    min_depth-clamped node abundance (degenerate branches filters.py:115-132),
    species max abundance (ub) and valid-node count (sampling-cap check).
    Every sum goes through a static SegmentLayout, so the stats are the
    same bit for bit on every run and mesh size."""
    seg = partial(_segment_sum, lay=trio_lay)
    nz = (ta > 0.0).astype(jnp.float32)
    c1 = seg(nz)
    s1 = seg(ta * nz)
    mu = s1 / jnp.maximum(c1, 1.0)
    dev = (ta - mu[jnp.clip(trio_hap, 0, G - 1)]) * nz
    s2 = seg(dev * dev)
    sigma = jnp.sqrt(s2 / jnp.maximum(c1, 1.0))
    # zscore_filter keeps |x - mu| / sigma < 3 strictly (filters.py:55);
    # sigma == 0 -> empty kept set -> mean 0 (filters.py:53-54)
    kept = (nz > 0) & (
        jnp.abs(ta - mu[jnp.clip(trio_hap, 0, G - 1)])
        < 3.0 * sigma[jnp.clip(trio_hap, 0, G - 1)]
    )
    k_cnt = seg(kept.astype(jnp.float32))
    k_sum = seg(ta * kept)
    freq_mean = jnp.where(
        (sigma > 0.0) & (k_cnt > 0.0), k_sum / jnp.maximum(k_cnt, 1.0), 0.0
    )

    path_cov = _segment_sum(bc.astype(jnp.float32), path_lay)

    segS = partial(_segment_sum, lay=node_lay)
    na_opt = jnp.where(na > min_depth, na, 0.0)
    nz_n = (na_opt > 0.0).astype(jnp.float32)
    sp_nz_cnt = segS(nz_n)
    sp_nz_sum = segS(na_opt * nz_n)
    # max is order-free, so the scatter-max is deterministic as it stands
    sp_max = jax.ops.segment_max(
        na, node_species, num_segments=S + 1, indices_are_sorted=True
    )[:S]
    sp_valid = segS((na > 0.0).astype(jnp.float32))
    return (c1, freq_mean, path_cov, sp_nz_cnt, sp_nz_sum, sp_max, sp_valid)


@dataclass
class TailStats:
    c1: np.ndarray          # [G] nonzero unique-trio count
    freq_mean: np.ndarray   # [G] zscore-filtered nonzero trio-abundance mean
    path_cov: np.ndarray    # [G] covered bases summed over the hap's path
    sp_nz_mean: np.ndarray  # [S] mean of nonzero min_depth-clamped abundance
    sp_max: np.ndarray      # [S] max node abundance (-> ub)
    sp_valid: np.ndarray    # [S] count of nodes with abundance > 0


def dispatch_tail_stats(tt: TailTables, na, ta, bc, min_depth: float):
    """Launch the stats program and start its async host copies WITHOUT
    blocking — callers overlap the device reduction with host work (the
    species profiling stage) and collect via collect_tail_stats."""
    out = _tail_stats(
        na, ta, bc, tt.trio_hap_d, tt.node_species_d, tt.trio_lay,
        tt.path_lay, tt.node_lay, jnp.float32(min_depth), G=tt.G, S=tt.S,
    )
    for a in out:
        f = getattr(a, "copy_to_host_async", None)
        if f is not None:
            f()
    return out


def collect_tail_stats(out) -> TailStats:
    c1, freq_mean, path_cov, nz_cnt, nz_sum, sp_max, sp_valid = (
        np.asarray(a, dtype=np.float64) for a in out
    )
    return TailStats(
        c1=c1,
        freq_mean=freq_mean,
        path_cov=path_cov,
        sp_nz_mean=np.where(nz_cnt > 0, nz_sum / np.maximum(nz_cnt, 1), 0.0),
        sp_max=sp_max,
        sp_valid=sp_valid,
    )


def compute_tail_stats(tt: TailTables, na, ta, bc, min_depth: float) -> TailStats:
    return collect_tail_stats(dispatch_tail_stats(tt, na, ta, bc, min_depth))


# ---------------------------------------------------------------------------
# first filter over precomputed stats (host branch logic)
# ---------------------------------------------------------------------------
def first_filter_from_stats(
    state: OtuState,
    si: int,
    tt: TailTables,
    stats: TailStats,
    names: list[str],
    cfg: ProfilingConfig,
) -> None:
    """filters.first_filter_paths (profile.rs:1080-1227) evaluated from the
    reduced stats: identical branch structure, identical rounding.  A unit
    test feeds EXACT (float64 host-computed) stats through this and asserts
    bit-equality with first_filter_paths; float32 device stats differ only in
    reduction rounding."""
    g_lo = int(tt.sp_hap_lo[si])
    orign_n_haps = len(names)
    m_size = int(tt.sp_m_size[si])
    for i, hap_id in enumerate(names):
        state.hap_metrics[i].otu = state.otu
        state.hap_metrics[i].hap_id = hap_id
    state.orign_n_haps = orign_n_haps
    state.hap2trio_nodes_m_size = m_size

    if orign_n_haps != 1 and m_size != 0:
        for h in range(orign_n_haps):
            g = g_lo + h
            trio_count = int(tt.trio_count[g])
            if trio_count == 0:
                continue
            fraction = float(stats.c1[g]) / trio_count
            state.hap_metrics[h].unique_trio_nodes_fraction = _round2(fraction)
            freq_mean = float(stats.freq_mean[g])
            if cfg.shift:
                if freq_mean >= 1.0:
                    shift_frac = cfg.unique_trio_nodes_fraction + (
                        0.8 - cfg.unique_trio_nodes_fraction
                    ) * freq_mean / 100.0
                    shift_frac = min(shift_frac, 0.8)
                else:
                    shift_frac = cfg.unique_trio_nodes_fraction * freq_mean
                if fraction < shift_frac:
                    continue
                state.hap_metrics[h].frequencies_mean = freq_mean
            else:
                if fraction < cfg.unique_trio_nodes_fraction:
                    continue
                state.hap_metrics[h].frequencies_mean = freq_mean
            state.possible_paths_idx.append(h)
    elif orign_n_haps != 1 and m_size == 0:
        if bool(tt.sp_all_same[si]):
            state.same_path_flag = True
            state.hap_metrics[0].frequencies_mean = _round2(
                float(stats.sp_nz_mean[si])
            )
            state.possible_paths_idx.append(0)
        else:
            state.possible_paths_idx = list(range(orign_n_haps))
    else:
        state.hap_metrics[0].frequencies_mean = _round2(
            float(stats.sp_nz_mean[si])
        )
        state.possible_paths_idx.append(0)


# ---------------------------------------------------------------------------
# device PAO: A built on device, batched ADMM, device polish
# ---------------------------------------------------------------------------
def _build_A_b(na, path_node, node_off, nvert, g_off, g_len,
               *, n_pad: int, p_pad: int, Lp: int):
    """[S, n_pad, p_pad] row-masked coefficient matrices + [S, n_pad] b.

    Rows are the species' full node slice; rows with abundance 0 are zeroed
    in BOTH A and b, which is equivalent to the host's row selection
    A=coeff[valid], b=na[valid] (a zero row contributes |0-0|=0 to the L1
    objective for any x, engine.prepare_two_stage / profile.rs:1297-1343)."""
    S = node_off.shape[0]
    N = na.shape[0]
    rows = node_off[:, None] + jnp.arange(n_pad, dtype=jnp.int32)[None, :]
    in_range = jnp.arange(n_pad, dtype=jnp.int32)[None, :] < nvert[:, None]
    b_raw = na[jnp.clip(rows, 0, N - 1)] * in_range
    valid = b_raw > 0.0

    Pn = path_node.shape[0]
    l = jnp.arange(Lp, dtype=jnp.int32)
    idx = g_off[:, :, None] + l[None, None, :]            # [S, p_pad, Lp]
    live = l[None, None, :] < g_len[:, :, None]
    node_g = path_node[jnp.clip(idx, 0, max(Pn - 1, 0))]
    row_local = node_g - node_off[:, None, None]
    in_slice = live & (row_local >= 0) & (row_local < n_pad)
    row_local = jnp.where(in_slice, row_local, n_pad)     # parked row: dropped
    A = jnp.zeros((S, n_pad + 1, p_pad), dtype=jnp.float32)
    s_idx = jnp.arange(S, dtype=jnp.int32)[:, None, None]
    j_idx = jnp.arange(p_pad, dtype=jnp.int32)[None, :, None]
    # duplicate path visits still set 1 (host uses assignment, engine.py:37)
    A = A.at[s_idx, row_local, j_idx].set(1.0, mode="drop")
    A = A[:, :n_pad, :] * valid[:, :, None].astype(jnp.float32)
    b = jnp.where(valid, b_raw, 0.0)
    return A, b, valid


@partial(jax.jit, static_argnames=("n_pad", "p_pad", "Lp"))
def _prepare_batch(na, path_node, node_off, nvert, g_off, g_len, scale,
                   *, n_pad: int, p_pad: int, Lp: int):
    A, b, valid = _build_A_b(
        na, path_node, node_off, nvert, g_off, g_len,
        n_pad=n_pad, p_pad=p_pad, Lp=Lp,
    )
    L = jax.vmap(
        lambda a: jnp.linalg.cholesky(
            jnp.dot(a.T, a, precision=jax.lax.Precision.HIGHEST)
            + jnp.eye(p_pad, dtype=a.dtype)
        )
    )(A)
    return A, b / scale[:, None], L


def _exact_residual(A, x):
    """A @ x as an unrolled elementwise sum: A is 0/1 and x is small, so the
    f32 multiply-adds are exact per element.  The polish must not go through
    a matmul unit, whose default f32 product may round its inputs (TF32 on
    a GPU keeps 10 mantissa bits)."""
    p = A.shape[-1]
    r = A[..., 0] * x[..., 0:1]
    for j in range(1, p):
        r = r + A[..., j] * x[..., j:j + 1]
    return r


@partial(jax.jit, static_argnames=("sweeps",))
def _polish_batch(A, b, x, ub, sweeps: int = 8):
    """Batched coordinate-median polish (exact L1 coordinate descent within
    the box, pao._polish semantics: binary columns -> k-th order statistic of
    the negated residuals at the column's live rows, profile.rs has no analog
    — this is the LP-vertex exactness step).  All math elementwise f32."""
    S, n, p = A.shape
    r = _exact_residual(A, x) - b
    BIG = jnp.float32(3.4e38)

    def sweep(carry, _):
        x, r = carry
        for j in range(p):
            col = A[:, :, j]
            m = col > 0.0
            cnt = jnp.sum(m, axis=1)
            breaks = jnp.where(m, -r, BIG)
            srt = jnp.sort(breaks, axis=1)
            k = jnp.maximum((cnt - 1) // 2, 0)
            tstar = jnp.take_along_axis(srt, k[:, None], axis=1)[:, 0]
            lo = -x[:, j]
            hi = ub[:, j] - x[:, j]
            t = jnp.clip(tstar, lo, hi)
            t = jnp.where(cnt > 0, t, 0.0)
            x = x.at[:, j].add(t)
            r = r + col * t[:, None]
        return (x, r), None

    (x, r), _ = jax.lax.scan(sweep, (x, r), None, length=sweeps)
    return x


class DeviceTailSolver:
    """Two-stage PAO over device-resident abundances.

    Instances are grouped into (n_pad, p_pad, Lp) buckets; each bucket keeps
    its A / b / Cholesky factors on device between the first and second
    solve (the host path re-uploads A for the second solve).  Solutions are
    clipped, polished on device, and downloaded as [S, p] blocks."""

    def __init__(self, tt: TailTables, na, jobs, sp_max: np.ndarray):
        """jobs: list of (si, possible_local_idx list, ub float); ``sp_max``
        is TailStats.sp_max (host parity: the ADMM's normalization scale is
        max(b) = the species' max node abundance, pao.py:324)."""
        self.tt = tt
        self.jobs = jobs
        self.sp_max = sp_max
        self.buckets: dict[tuple, list] = {}
        for ji, (si, possible, ub) in enumerate(jobs):
            nvert = int(tt.sp_nvert[si])
            g_lo = int(tt.sp_hap_lo[si])
            gs = [g_lo + h for h in possible]
            lens = [int(tt.hap_node_off[g + 1] - tt.hap_node_off[g]) for g in gs]
            n_pad = _bucket(max(nvert, 1))
            p_pad = max(4, -(-len(gs) // 4) * 4)
            Lp = _pow2(max(max(lens, default=1), 1))
            key = (n_pad, p_pad, Lp)
            self.buckets.setdefault(key, []).append((ji, si, gs, lens, ub))
        self._na = na
        self._prepared: dict[tuple, dict] = {}

    def _prepare(self):
        tt = self.tt
        for key, rows in self.buckets.items():
            n_pad, p_pad, Lp = key
            S = len(rows)
            node_off = np.zeros(S, dtype=np.int32)
            nvert = np.zeros(S, dtype=np.int32)
            g_off = np.zeros((S, p_pad), dtype=np.int32)
            g_len = np.zeros((S, p_pad), dtype=np.int32)
            scale = np.ones(S, dtype=np.float32)
            ub_nrm = np.zeros((S, p_pad), dtype=np.float32)
            for s, (ji, si, gs, lens, ub) in enumerate(rows):
                node_off[s] = int(tt.sp_off[si])
                nvert[s] = int(tt.sp_nvert[si])
                for j, (g, ln) in enumerate(zip(gs, lens)):
                    g_off[s, j] = int(tt.hap_node_off[g])
                    g_len[s, j] = ln
                sc = float(self.sp_max[si])
                scale[s] = sc if sc > 0 else 1.0
                ub_nrm[s, :len(gs)] = ub / scale[s]
            A, b, L = _prepare_batch(
                self._na, tt.path_node_d,
                jnp.asarray(node_off), jnp.asarray(nvert),
                jnp.asarray(g_off), jnp.asarray(g_len), jnp.asarray(scale),
                n_pad=n_pad, p_pad=p_pad, Lp=Lp,
            )
            self._prepared[key] = {
                "A": A, "b": b, "L": L,
                "scale": scale, "ub": ub_nrm, "rows": rows,
            }

    def solve(self, ub_vec_of=None, iters: int = 1500, chunk: int | None = None,
              tol: float = 1e-5, only_jobs: set | None = None
              ) -> list[np.ndarray]:
        """One batched solve pass; ``ub_vec_of(ji, p) -> [p] ub vector or
        None`` customizes per-path bounds (the second solve pins paths with
        ub 0, profile.rs:1482-1510).  ``only_jobs`` skips buckets containing
        none of the listed job indices (second pass: most species need no
        re-solve, so whole buckets drop out).  Returns per-job x arrays [p].
        PANTAX_TPU_ADMM_CHUNK overrides the per-dispatch iteration count
        (A/B: smaller chunks stop converged buckets earlier but dispatch
        more often)."""
        import os as _os

        if chunk is None:
            chunk = int(_os.environ.get("PANTAX_TPU_ADMM_CHUNK", "250"))
        if not self._prepared:
            self._prepare()
        results: list[np.ndarray | None] = [None] * len(self.jobs)
        runs = []
        for key, prep in self._prepared.items():
            n_pad, p_pad, Lp = key
            rows = prep["rows"]
            if only_jobs is not None and not any(
                ji in only_jobs for ji, *_ in rows
            ):
                continue
            S = len(rows)
            ub = prep["ub"]
            if ub_vec_of is not None:
                ub = prep["ub"].copy()
                for s, (ji, si, gs, lens, _raw_ub) in enumerate(rows):
                    v = ub_vec_of(ji, len(gs))
                    if v is not None:
                        ub[s, :len(gs)] = v / prep["scale"][s]
            ub_d = jnp.asarray(ub)
            x0 = jnp.zeros((S, p_pad), dtype=jnp.float32)
            z0 = jnp.zeros((S, n_pad), dtype=jnp.float32)
            runs.append({
                "prep": prep, "ub_d": ub_d, "state": (x0, z0, x0, z0, x0),
                "left": max(iters // chunk, 1), "res": None,
            })
        rho = jnp.float32(1.0)

        def step(r):
            r["state"], res = _admm_chunk_batch(
                r["prep"]["A"], r["prep"]["b"], r["ub_d"], rho, r["state"],
                r["prep"]["L"], chunk,
            )
            r["left"] -= 1
            r["res"] = res
            f = getattr(res, "copy_to_host_async", None)
            if f is not None:
                f()

        # round-robin across buckets: every bucket keeps one chunk in
        # flight, so one bucket's residual download overlaps the others'
        # compute instead of a dispatch + blocking scalar read per chunk in
        # sequence; the per-bucket chunk sequence and early-stop decisions
        # are unchanged, so results stay bit-identical.
        from collections import deque

        import logging
        import time as _time

        _log = logging.getLogger("pantax_tpu")
        t_loop = _time.time()
        n_chunks = len(runs)
        q = deque()
        for r in runs:
            step(r)
            q.append(r)
        dbg = _os.environ.get("PANTAX_TPU_ADMM_DEBUG")
        while q:
            r = q.popleft()
            res = float(np.max(np.asarray(r["res"])))
            if dbg:
                _log.info("      ADMM chunk res=%.3g (left %d)",
                          res, r["left"])
            # stop on tol OR on a low plateau: the f32 residual floors
            # around 2-3e-4 at benchmark scales (tol=1e-5 is unreachable
            # in f32) and chunks past the floor don't move the iterate.
            # The plateau stop only fires with res already < 100*tol —
            # hard instances that slow down at HIGH residual (seen in the
            # random parity trials at ~3e-2) keep iterating to the cap, so
            # the polished objective stays within 1e-4 of the host LP.
            prev = r.get("prev_res")
            r["prev_res"] = res
            plateau = (prev is not None and res > 0.9 * prev
                       and res < 100 * tol)
            if res >= tol and not plateau and r["left"] > 0:
                step(r)
                q.append(r)
                n_chunks += 1
        t_loop = _time.time() - t_loop
        t_pol = _time.time()
        for r in runs:
            x = jnp.clip(r["state"][2], 0.0, r["ub_d"])
            r["x"] = _polish_batch(r["prep"]["A"], r["prep"]["b"], x,
                                   r["ub_d"])
        for r in runs:
            X = np.asarray(r["x"], dtype=np.float64)
            prep = r["prep"]
            for s, (ji, si, gs, lens, _raw_ub) in enumerate(prep["rows"]):
                results[ji] = X[s, :len(gs)] * float(prep["scale"][s])
        _log.info("      ADMM loop %.2fs (%d buckets, %d chunk dispatches);"
                  " polish+download %.2fs",
                  t_loop, len(runs), n_chunks, _time.time() - t_pol)
        return results


def _pow2(n: int, lo: int = 64) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


def solve_two_stage_device(
    tt: TailTables, na, jobs, states: list[OtuState], cfg: ProfilingConfig,
    sp_max: np.ndarray,
) -> None:
    """Device-resident analog of engine.finish_two_stage: batched first
    solves, host second filter, batched second solves with ub-0 pins.
    ``jobs[i] = (si, possible_local_idx, ub)`` paired with ``states[i]``."""
    from ..profile.filters import second_filter_paths

    from ..utils.logging import stage_timer

    solver = DeviceTailSolver(tt, na, jobs, sp_max)
    with stage_timer("    PAO prepare (device A/b/L)"):
        solver._prepare()
    with stage_timer("    PAO first solve"):
        firsts = solver.solve()
    for (si, possible, ub), state, x in zip(jobs, states, firsts):
        for j, h in enumerate(possible):
            state.hap_metrics[h].first_sol = float(x[j])
        second_filter_paths(state, cfg)

    second_idx = [i for i, st in enumerate(states) if st.second_opt]
    if not second_idx:
        return
    second_set = set(second_idx)

    def ub_vec_of(ji: int, p: int):
        if ji not in second_set:
            return None  # unchanged bounds; result discarded below
        si, possible, ub = jobs[ji]
        st = states[ji]
        v = np.full(p, ub, dtype=np.float64)
        for j, h in enumerate(possible):
            if h not in st.second_possible_paths_idx:
                v[j] = 0.0
        return v

    with stage_timer("    PAO second solve"):
        seconds = solver.solve(ub_vec_of=ub_vec_of, only_jobs=second_set)
    for ji in second_idx:
        si, possible, ub = jobs[ji]
        st = states[ji]
        x = seconds[ji]
        for j, h in enumerate(possible):
            if h in st.second_possible_paths_idx:
                st.hap_metrics[h].second_sol = float(x[j])
