"""Read-to-graph aligner: sampled-seed lookup + diagonal voting + banded
glocal DP over linearized haplotypes, with projection onto graph node paths.

Replaces vg giraffe / GraphAligner (/root/reference/pantax/src/alignment.rs) with
an accelerator-native design: the whole query path — k-mer hashing, seed lookup
(searchsorted over the sorted seed table), diagonal voting, banded DP
extension, candidate dedup by graph location, and mapq — is one jitted JAX
function over a padded read batch.  Reads are data-parallel (shard the batch
axis over the mesh); the index arrays are replicated.

mapq calibration: 60 for a unique best location; otherwise
clip(mapq_scale * (best - second_best), 0, 60) where "location" identity is
the projected (graph node, offset) of the alignment start — equal-scoring hits
on different haplotypes that project to the same node interval collapse into
one location, matching giraffe's graph-native multiplicity semantics.  The
species credibility filter keys on the mapq-60 and 3..60 bands
(/root/reference/pantax/src/profile.rs:208-252).
"""
from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..config import AlignConfig
from ..io.gaf import GafRecord
from .encode import encode_seq
from .index import AlignIndex

log = logging.getLogger("pantax_tpu")

NEG = -(10**6)


@dataclass
class BatchResult:
    """Per-read best alignment in text coordinates (host numpy)."""

    text_start: np.ndarray   # int32 [B]
    text_end: np.ndarray     # int32 [B] (exclusive)
    score: np.ndarray        # int32 [B]
    matches: np.ndarray      # int32 [B]
    mapq: np.ndarray         # int32 [B]
    strand: np.ndarray       # int8 [B] 0=+ 1=-
    aligned: np.ndarray      # bool [B]


# ---------------------------------------------------------------------------
# device-side pieces
# ---------------------------------------------------------------------------
def _mix32_j(h):
    h = h.astype(jnp.uint32)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Host-side nibble pack: int8 codes (0..4) [B, L] -> uint8 [B, ceil(L/4)*2].
    Read batches cross the host->device link every dispatch; 4 bits per base
    halves the upload (the reverse strand is derived on device, halving it
    again — see _query_batch).  Width is padded to a multiple of FOUR (not
    two) so the unpacked shape matches pack_codes2's exactly: an exception-
    overflow fallback mid-run then reuses the same downstream graph shapes
    instead of compiling a second read-width family."""
    if codes.shape[1] % 4:
        codes = np.pad(
            codes, ((0, 0), (0, 4 - codes.shape[1] % 4)), constant_values=4
        )
    c = codes.astype(np.uint8)
    return c[:, 0::2] | (c[:, 1::2] << 4)


def _unpack_codes_j(packed):
    """Device-side inverse of pack_codes: uint8 [B, L/2] -> int8 [B, L]."""
    b = packed.astype(jnp.int32)
    c0 = b & 15
    c1 = (b >> 4) & 15
    return jnp.stack([c0, c1], axis=-1).reshape(b.shape[0], -1).astype(jnp.int8)


# 2-bit read pack: the read batch crosses the host->device link every
# dispatch, and 2 bits/base halves that transfer vs the nibble pack (5.2MB ->
# 2.6MB at batch 65536 x 160bp).  Ambiguity bases (code 4) don't fit 2 bits; they travel as
# a sparse exception list of flat [B*L] positions (real N rates are <<0.1%),
# scattered back on device.  Batches with more than _EXC_CAP exceptions fall
# back to the 4-bit pack (a different arg pytree -> its own compiled graph).
_EXC_CAP = 8192


def pack_codes2(
    codes: np.ndarray, lens: np.ndarray, cap: int = _EXC_CAP
) -> tuple[np.ndarray, np.ndarray] | None:
    """Host-side 2-bit pack: int8 codes (0..4) [B, L] -> (uint8 [B, ceil(L/4)],
    exceptions int32 [cap]).  Exceptions are flat positions (in the padded
    [B, 4*ceil(L/4)] coordinate system) of code-4 bases BEFORE each read's
    length; tail padding is restored on device from read_len.  Returns None
    when the batch has more than ``cap`` exceptions (caller falls back to
    pack_codes).

    The single-pass C++ implementation (native/pantax_native.cpp) does this
    in ~7ms per 65536x160 batch vs ~53ms in NumPy — the pack sits on the
    fused align loop's critical host path; the NumPy path below is the
    oracle and the no-compiler fallback."""
    from ..utils.native import pack_codes2_native

    nat = pack_codes2_native(codes, lens, cap)
    if nat is False:
        return None
    if nat is not None:
        return nat
    B, L = codes.shape
    cols = np.arange(L, dtype=np.int64)[None, :]
    rows_m, cols_m = np.nonzero(
        (codes >= 4) & (cols < np.asarray(lens).reshape(B, 1))
    )
    if len(rows_m) > cap:
        return None
    if L % 4:
        codes = np.pad(codes, ((0, 0), (0, 4 - L % 4)), constant_values=0)
    Lp = codes.shape[1]
    c = codes.astype(np.uint8) & 3
    packed = (
        c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6)
    )
    exc = np.full(cap, B * Lp, dtype=np.int32)  # sentinel: OOB -> dropped
    exc[: len(rows_m)] = rows_m * Lp + cols_m
    return packed, exc


def _unpack_codes2_j(packed):
    """Device-side inverse of pack_codes2's bit pack (exceptions/tail apart):
    uint8 [B, L/4] -> int8 [B, L]."""
    b = packed.astype(jnp.int32)
    cs = [(b >> (2 * i)) & 3 for i in range(4)]
    return jnp.stack(cs, axis=-1).reshape(b.shape[0], -1).astype(jnp.int8)


def _unpack_reads_j(codes_packed, read_len):
    """Unpack a read batch in any wire format — output is bit-identical
    between all three:

      plain array                   4-bit nibble pack (pad bases already 4)
      (packed2, exc)                2-bit pack + sparse N-exception scatter
      (buf, byte_off, exc, wm)      device-resident GROUP buffer: rows are
                                    gathered from a 2-bit packed buffer
                                    uploaded ONCE per read group (the
                                    long-read chunk flow — each chunk's
                                    bases would otherwise be uploaded
                                    twice, seeded pass + rescue).  byte_off
                                    int32 [B] ascending row byte offsets,
                                    exc int32 sorted N positions in buffer
                                    BASE coords, wm an empty [0, W_bytes]
                                    static-width carrier."""
    if not isinstance(codes_packed, tuple):
        return _unpack_codes_j(codes_packed)
    if len(codes_packed) == 4:
        # reads are padded to CHUNK boundaries in the buffer, so a chunk is
        # exactly one row of the 2-D packed buffer: ONE gather index pulls
        # a whole Wb-byte row instead of Wb byte indices
        buf, row_idx, exc, wm = codes_packed
        Wb = wm.shape[1]
        B = row_idx.shape[0]
        L = Wb * 4
        rows = buf[row_idx]
        codes = _unpack_codes2_j(rows)
        base = row_idx * L
        idx = jnp.clip(jnp.searchsorted(base, exc, side="right") - 1,
                       0, B - 1)
        col = exc - base[idx]
        flat = jnp.where((col >= 0) & (col < L), idx * L + col, B * L)
        codes = codes.reshape(-1).at[flat].set(
            jnp.int8(4), mode="drop"
        ).reshape(B, L)
        cols = jnp.arange(L, dtype=jnp.int32)[None, :]
        codes = jnp.where(cols < read_len[:, None], codes, jnp.int8(4))
        # materialize ONCE: without the barrier XLA fuses the row gather +
        # unpack into every downstream consumer (fwd hash, revcomp, DP
        # windows), re-gathering per use
        return jax.lax.optimization_barrier(codes)
    packed2, exc = codes_packed
    codes = _unpack_codes2_j(packed2)
    B, L = codes.shape
    codes = (
        codes.reshape(-1).at[exc].set(jnp.int8(4), mode="drop").reshape(B, L)
    )
    cols = jnp.arange(L, dtype=jnp.int32)[None, :]
    return jnp.where(cols < read_len[:, None], codes, jnp.int8(4))


def _rev_codes_j(codes, lens):
    """Device-side left-aligned reverse complement of right-padded codes.

    Gather-free: static flip puts row content at [Lr-len, Lr), then a
    variable left-roll by (Lr - len) realigns it via binary decomposition
    (static rolls + per-row selects): ~log2(Lr) whole-array passes instead
    of a per-row [B, Lr] gather of 10.5M indices at 65536x160."""
    B, Lr = codes.shape
    cols = jnp.arange(Lr, dtype=jnp.int32)[None, :]
    rev = codes[:, ::-1]
    sh = jnp.int32(Lr) - lens.astype(jnp.int32)
    t = 0
    while (1 << t) < Lr:
        rolled = jnp.roll(rev, -(1 << t), axis=1)
        rev = jnp.where((((sh >> t) & 1) == 1)[:, None], rolled, rev)
        t += 1
    return jnp.where(
        (cols < lens[:, None]) & (rev < 4), jnp.int8(3) - rev, jnp.int8(4)
    )


def _kmer_hashes_j(codes, k: int):
    """codes int8 [B, L] -> (mixed canonical hash uint32 [B, n], valid [B, n])."""
    B, L = codes.shape
    n = L - k + 1
    c = codes.astype(jnp.uint32)
    base = jnp.uint32(0x9E3779B1)
    pows = [jnp.uint32(1)]
    for _ in range(1, k):
        pows.append(pows[-1] * base)
    hf = jnp.zeros((B, n), dtype=jnp.uint32)
    hr = jnp.zeros((B, n), dtype=jnp.uint32)
    invalid = jnp.zeros((B, n), dtype=bool)
    for i in range(k):
        ci = jax.lax.dynamic_slice_in_dim(c, i, n, axis=1)
        hf = hf + ci * pows[k - 1 - i]
        hr = hr + (jnp.uint32(3) - ci) * pows[i]
        invalid = invalid | (ci == 4)
    return _mix32_j(jnp.minimum(hf, hr)), ~invalid


def _select_seeds(hashes, valid, density_bits: int, s_max: int):
    """Up to s_max sampled seed positions per read (padded with -1).

    Sort-free: the r-th selected seed is the position whose running count of
    sampled positions equals r+1 — a one-hot reduction over the rank, which is
    dense VPU work instead of a lane argsort."""
    mask = valid & ((hashes & jnp.uint32((1 << density_bits) - 1)) == 0)
    B, n = mask.shape
    pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (B, n))
    rank = jnp.cumsum(mask.astype(jnp.int32), axis=1)  # 1-based at sampled pos
    slots = jnp.arange(1, s_max + 1, dtype=jnp.int32)
    hit = mask[:, :, None] & (rank[:, :, None] == slots[None, None, :])
    sel_pos = jnp.max(jnp.where(hit, pos[:, :, None], -1), axis=1)
    sel_hash = jnp.max(
        jnp.where(hit, hashes[:, :, None], jnp.uint32(0)), axis=1
    )
    sel_valid = sel_pos >= 0
    return sel_pos, sel_hash, sel_valid


_CHD_GOLD = 0x9E3779B9  # displacement salt (build/device must agree)


def _lookup_hits(
    run_table, seed_pos, bucket_lo, bucket_bits: int, steps: int,
    sel_hash, sel_valid, hits_per_seed: int,
):
    """Text positions for each read seed: [B, S, C] (+validity).

    Each dependent [B*S]-index gather round is a serial step whose cost
    barely depends on row width (<= 4 int32), and slice-style gathers
    (vmapped dynamic_slice) are far slower, so the lookup is engineered to a
    minimum count of elementwise gather rounds.  Two modes, keyed by the sign of ``steps``
    (chosen at build, build_seed_lookup):

    ``steps < 0`` — CHD displacement hash (the fast path, 2 rounds):
    run_table is a [T, 2+C] open slot table (key, run length, then the
    first C = hits_per_seed hit positions INLINE) at perfect-hash
    positions, and bucket_lo is the per-bucket displacement array disp[m]
    (seed_pos is unused).  Chain: d = disp[hash >> (32-bucket_bits)];
    slot = mix32(hash ^ d * GOLD) & (T-1); one row gather; key equality
    confirms membership (keys are globally unique; empty slots carry
    len = 0 so they can never validate).  Inlining the positions trades
    ~2.5x table bytes for removing the third dependent gather round.

    ``steps >= 0`` — bucketed bisection (fallback when the CHD build does
    not converge): bucket_lo[b] pre-resolves the hash's top bucket_bits to
    a run range [lo, hi) of the key-sorted run table; a ``steps``-deep
    bisection finds the exact run, then positions gather elementwise from
    the flat [S] seed_pos: 7-ish rounds (lo, hi, ``steps`` key probes, row,
    positions)."""
    D = run_table.shape[0]
    shift = jnp.uint32(32 - bucket_bits)
    b = (sel_hash >> shift).astype(jnp.int32)
    c = jnp.arange(hits_per_seed, dtype=jnp.int32)
    if steps < 0:
        assert run_table.shape[-1] == 2 + hits_per_seed
        d = jax.lax.bitcast_convert_type(bucket_lo[b], jnp.uint32)
        slot = (
            _mix32_j(sel_hash ^ (d * jnp.uint32(_CHD_GOLD)))
            & jnp.uint32(D - 1)
        ).astype(jnp.int32)
        row = run_table[slot]
        key = jax.lax.bitcast_convert_type(row[..., 0], jnp.uint32)
        ok = (key == sel_hash) & sel_valid
        rlen = jnp.where(ok, row[..., 1], 0)
        pos = row[..., 2:]
        hit_valid = ok[..., None] & (c < rlen[..., None])
        return pos, hit_valid
    S_len = seed_pos.shape[0]
    lo = bucket_lo[b]
    hi = bucket_lo[b + 1]
    # first run index in [lo, hi) whose key >= sel_hash (uint32 order; keys
    # are stored as bitcast int32)
    lo_s, hi_s = lo, hi
    keys_col = run_table[:, 0]
    for _ in range(steps):
        mid = (lo_s + hi_s) >> 1
        key_mid = jax.lax.bitcast_convert_type(
            keys_col[jnp.clip(mid, 0, D - 1)], jnp.uint32
        )
        go_right = (key_mid < sel_hash) & (lo_s < hi_s)
        lo_s = jnp.where(go_right, mid + 1, lo_s)
        hi_s = jnp.where(go_right, hi_s, jnp.maximum(mid, lo_s))
    row = run_table[jnp.clip(lo_s, 0, D - 1)]  # [B, S, 3]
    key_j = jax.lax.bitcast_convert_type(row[..., 0], jnp.uint32)
    found = (key_j == sel_hash) & (lo_s < hi) & sel_valid
    idx = row[..., 1][..., None] + c
    pos = seed_pos[jnp.clip(idx, 0, S_len - 1)]
    hit_valid = found[..., None] & (c < row[..., 2][..., None])
    return pos, hit_valid


def _vote_diagonals(diags, valid, band: int, top_k: int):
    """Top-k candidate diagonals per read by vote count within +-band.

    Dense O(n^2) pairwise counting (n = seeds*hits per read is small) — plain
    elementwise compares, no sort/searchsorted."""
    BIG = jnp.int32(2**30)
    d = jnp.where(valid, diags, BIG)
    diff = d[:, :, None] - d[:, None, :]
    close = (jnp.abs(diff) <= band) & valid[:, None, :] & valid[:, :, None]
    counts = close.sum(axis=2).astype(jnp.int32)

    cand_d = []
    cand_v = []
    for _ in range(top_k):
        best = jnp.argmax(counts, axis=1)
        bd = jnp.take_along_axis(d, best[:, None], axis=1)[:, 0]
        bv = jnp.take_along_axis(counts, best[:, None], axis=1)[:, 0]
        cand_d.append(bd)
        cand_v.append(bv)
        kill = jnp.abs(d - bd[:, None]) <= band
        counts = jnp.where(kill, 0, counts)
    return jnp.stack(cand_d, axis=1), jnp.stack(cand_v, axis=1)


# Packed DP cell: ((score + bias) << sh_score) | (matches << 5) | start_band.
# max() over packed cells = lexicographic (score, matches, start) — one int32
# array of state instead of three, which keeps the scan HLO small and every
# update a plain vector max on the VPU.  Field widths depend on the padded
# read length (matches can reach Lr; scores span roughly +-2*Lr).
_SH_MATCH = 5
_DP_UNROLL = 4  # scan-body unroll of the banded DP (module-level for tuning)


def packed_layout(Lr: int) -> tuple[int, int]:
    """(sh_score, bias) for reads of padded length Lr (Lr <= 8192)."""
    if Lr > 8192:
        raise ValueError(f"read length {Lr} exceeds the packed-cell DP limit")
    m_bits = int(Lr + 1).bit_length()
    sh_score = _SH_MATCH + m_bits
    bias_bits = int(2 * Lr + 64).bit_length()
    if sh_score + bias_bits + 1 > 31:
        raise ValueError(f"packed DP cell overflow for Lr={Lr}")
    return sh_score, 1 << bias_bits


def _banded_extend(window, read, read_len, pad: int, match: int, mismatch: int, gap: int):
    """Banded glocal DP: full read aligned, free start/end in the window.

    window: int8 [N, W] with W = Lr + 2*pad;  read: int8 [N, Lr].
    Returns (score, start_off, end_off, matches) per row, window coordinates.
    Layout: band on the leading axis, reads on the trailing (contiguous) axis.
    """
    N, Lr = read.shape
    if 2 * pad >= 1 << _SH_MATCH:
        # start_off spans [0, 2*pad]; wider bands would overflow the 5-bit
        # start field into the matches bits and silently corrupt the DP.
        raise ValueError(
            f"extension band {pad} too wide for the packed cell layout "
            f"(needs 2*band < {1 << _SH_MATCH})"
        )
    sh_score, bias = packed_layout(Lr)
    # band rows [-pad, pad-1] around the voted diagonal: 2*pad rows, a power
    # of two for the prefix-max shifts; the dropped +pad edge only matters for
    # a net >= pad-base deletion ahead of the seed, beyond the DP's indel
    # design point anyway
    Wb = 2 * pad
    # Materialize the gathered window before the scan: without the barrier XLA
    # fuses the text gather into the scan body and re-executes it every step.
    winT = jax.lax.optimization_barrier(window.T)  # [W, N]
    readT = jax.lax.optimization_barrier(read.T)  # [Lr, N]
    neg = jnp.int32(NEG)

    d_score = jnp.int32(1 << sh_score)
    gap_p = jnp.int32(gap) * d_score
    band = jnp.arange(Wb, dtype=jnp.int32)[:, None]  # [Wb, 1]
    decay = band * gap_p  # for prefix-max with gap penalty per left step

    def sub_packed(i):
        row = jax.lax.dynamic_slice_in_dim(winT, i, Wb, axis=0)  # [Wb, N]
        x = readT[i][None, :]
        ok = (row == x) & (x < 4) & (row < 4)
        delta = jnp.where(ok, match, mismatch).astype(jnp.int32) * d_score
        return delta + (ok.astype(jnp.int32) << _SH_MATCH)

    init_cell = (jnp.int32(bias) << sh_score) + band  # score 0, start = b
    state = init_cell + sub_packed(0)  # [Wb, N] after consuming read[0]

    # No separate "answer" carry: updates freeze once i >= read_len, so the
    # final state IS the state at step read_len-1 for every live row.  The
    # single carry keeps the scan body, and its compile time, small.
    def step(state, i):
        # diagonal move keeps band idx; up move (read char vs ref gap) shifts
        up = jnp.concatenate([state[1:], jnp.full((1, N), neg, jnp.int32)], axis=0)
        v = jnp.maximum(state + sub_packed(i), up + gap_p)
        # left moves (consume ref only): m[b] = max_{j<=b} v[j] + (b-j)*gap
        u = v - decay
        for sh in (1, 2, 4, 8, 16):
            if sh >= Wb:
                break
            shifted = jnp.concatenate([jnp.full((sh, N), neg, jnp.int32), u[:-sh]], axis=0)
            u = jnp.maximum(u, shifted)
        v = u + decay
        live = (i < read_len)[None, :]
        state = jnp.where(live, v, state)
        return state, None

    with jax.named_scope("banded_dp"):
        state, _ = jax.lax.scan(
            step, state, jnp.arange(1, Lr, dtype=jnp.int32), unroll=_DP_UNROLL
        )
    # empty (padding) rows never capture a step; keep their old NEG sentinel
    out = jnp.where((read_len >= 1)[None, :], state, neg)
    b_best = jnp.argmax(out, axis=0)  # [N]
    cell = jnp.max(out, axis=0)
    best = (cell >> sh_score) - bias
    mcnt = (cell >> _SH_MATCH) & ((1 << (sh_score - _SH_MATCH)) - 1)
    start_off = cell & ((1 << _SH_MATCH) - 1)
    end_off = (read_len - 1) + b_best.astype(jnp.int32) + 1
    return best, start_off, end_off, mcnt


def pack_text2d(text: np.ndarray) -> np.ndarray:
    """Nibble-pack the 256-padded index text into [T/256, 128] uint8 rows
    (2 bases/byte, 256 bases per row).  _extract_windows gathers whole rows,
    so halving the row bytes halves that gather's HBM traffic AND the
    text's device footprint (locality matters once 100M+ base DBs exceed
    any cache) for the price of a cheap VPU nibble unpack.  Code 4
    (N/separator) fits a nibble, so no exception list is needed (unlike the
    2-bit read wire)."""
    c = np.ascontiguousarray(text).reshape(-1, 256).astype(np.uint8)
    return c[:, 0::2] | (c[:, 1::2] << 4)


def _extract_windows(text2d, w0, W: int):
    """window[i] = text[w0[i] : w0[i] + W] without an elementwise gather:
    gather whole nibble-packed 128-byte rows (256 bases each, pack_text2d),
    shift into place with a binary decomposition of the in-row offset
    (static rolls + arithmetic selects instead of W elementwise gathers per
    window), unpack, and fix up the odd-base offset bit.
    Rolling the PACKED bytes halves both the gathered traffic and the
    roll-loop bandwidth vs rolling unpacked codes."""
    n_extra = (W + 255) // 256
    r = w0 >> 8
    seg_p = jnp.concatenate(
        [text2d[r + j] for j in range(n_extra + 1)], axis=1
    )
    offb = ((w0 & 255) >> 1)[:, None]  # byte offset within the row
    for t in range(7):
        rolled = jnp.roll(seg_p, -(1 << t), axis=1)
        bit = ((offb >> t) & 1).astype(seg_p.dtype)
        seg_p = rolled * bit + seg_p * (1 - bit)
    seg = _unpack_codes_j(seg_p)
    odd = (w0 & 1)[:, None]
    seg = jnp.where(odd == 1, jnp.roll(seg, -1, axis=1), seg)
    return seg[:, :W]


def _all_candidates(
    text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
    codes_fwd, codes_rev, read_len, cfg_static
):
    """Scored candidate locations per read, both strands folded: arrays
    (scores, ts, te, matches, strand, node, off), all [B, K].

    Seeds are hashed and looked up ONCE per read, on the forward strand only:
    canonical k-mer hashing is orientation-invariant, so the reverse-
    complement read's k-mer at the mirrored position l-k-p has the SAME
    canonical hash (hence the same index hits) as the forward k-mer at p.
    The reverse-strand diagonal of a text hit t is then derived
    arithmetically as t - (l-k-p), instead of re-hashing and re-gathering
    the [2B] strand-doubled batch — which halves the seed-lookup stage, the
    kernel's dominant cost (serial HBM gathers).  Only the cheap banded
    extension runs on both strands."""
    (k, density_bits, bucket_bits, steps, s_max, hits, top_k, pad, match,
     mismatch, gap) = cfg_static[:11]
    B, Lr = codes_fwd.shape
    W = Lr + 2 * pad
    n_extra = (W + 255) // 256
    T = (text2d.shape[0] - n_extra) * 256

    hashes, valid = _kmer_hashes_j(codes_fwd, k)
    sel_pos, sel_hash, sel_valid = _select_seeds(hashes, valid, density_bits, s_max)
    hit_pos, hit_valid = _lookup_hits(
        run_table, seed_pos, bucket_lo, bucket_bits, steps, sel_hash, sel_valid, hits
    )
    p = sel_pos[..., None]
    d_fwd = (hit_pos - p).reshape(B, -1)
    d_rev = (hit_pos - (read_len[:, None, None] - k - p)).reshape(B, -1)
    hv = hit_valid.reshape(B, -1)
    cd_f, cv_f = _vote_diagonals(d_fwd, hv, band=pad, top_k=top_k)
    cd_r, cv_r = _vote_diagonals(d_rev, hv, band=pad, top_k=top_k)

    # strand union: extend only the top_k best-voted candidates across BOTH
    # strands.  The true strand's diagonal collects nearly all seed votes
    # (wrong-strand diagonals only get chance collisions), so folding the
    # strands before extension halves the [2B*K] DP + window batch — the
    # kernel's dominant cost — without losing the best location.  Ties favor
    # the forward slots (same preference as the old stacked order).
    K = top_k
    diag_u = jnp.concatenate([cd_f, cd_r], axis=1)          # [B, 2K]
    vote_u = jnp.concatenate([cv_f, cv_r], axis=1)
    cols2k = jnp.arange(2 * K, dtype=jnp.int32)[None, :]
    sel_cols = []
    v = vote_u
    for _ in range(K):
        b = jnp.argmax(v, axis=1).astype(jnp.int32)
        sel_cols.append(b)
        v = jnp.where(cols2k == b[:, None], -1, v)
    sel = jnp.stack(sel_cols, axis=1)                       # [B, K]
    cand_diag = jnp.take_along_axis(diag_u, sel, axis=1)
    cand_votes = jnp.take_along_axis(vote_u, sel, axis=1)
    strand = (sel >= K).astype(jnp.int8)                    # [B, K]

    # per-candidate strand pick as a broadcast select (a take_along_axis
    # over a stacked [B, 2, Lr] would be a gather for what is a mask)
    read_rep = jnp.where(
        (strand == 1)[:, :, None], codes_rev[:, None, :], codes_fwd[:, None, :]
    ).reshape(B * K, -1)
    len_rep = jnp.repeat(read_len, K)
    w0 = jnp.clip(cand_diag - pad, 0, T - W)
    flat_w0 = w0.reshape(-1)
    window = _extract_windows(text2d, flat_w0, W)
    score, start_off, end_off, matches = _banded_extend(
        window, read_rep, len_rep, pad, match, mismatch, gap
    )
    scores = jnp.where(cand_votes > 0, score.reshape(B, K), NEG)
    ts = (flat_w0 + start_off).reshape(B, K)
    te = (flat_w0 + end_off).reshape(B, K)
    matches = matches.reshape(B, K)

    # graph location of each candidate: (node id, offset within node)
    i0 = jnp.searchsorted(tstart, ts, side="right") - 1
    i0 = jnp.clip(i0, 0, tnode.shape[0] - 1)
    node = tnode[i0]
    off = ts - tstart[i0]
    return scores, ts, te, matches, strand, node, off


@partial(jax.jit, static_argnames=("cfg_static",))
def _query_batch(
    text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
    codes_packed, read_len, cfg_static
):
    mapq_scale, min_score_frac = cfg_static[11], cfg_static[12]
    codes_fwd = _unpack_reads_j(codes_packed, read_len)
    codes_rev = _rev_codes_j(codes_fwd, read_len)
    scores, ts, te, matches, strand, node, off = _all_candidates(
        text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
        codes_fwd, codes_rev, read_len, cfg_static,
    )

    best = jnp.argmax(scores, axis=1)
    take = lambda a: jnp.take_along_axis(a, best[:, None], axis=1)[:, 0]
    s1 = take(scores)
    bnode, boff = take(node), take(off)
    same_loc = (node == bnode[:, None]) & (off == boff[:, None])
    s2 = jnp.max(jnp.where(same_loc, NEG, scores), axis=1)

    min_score = (min_score_frac * read_len).astype(jnp.int32)
    aligned = s1 >= min_score
    mapq = jnp.where(
        s2 <= NEG // 2,
        60,
        jnp.clip((mapq_scale * (s1 - s2)).astype(jnp.int32), 0, 60),
    )
    return (
        take(ts), take(te), s1, take(matches),
        jnp.where(aligned, mapq, 0), take(strand), aligned,
    )


@partial(jax.jit, static_argnames=("cfg_static",))
def _extend_batch(
    text2d, codes_packed, read_len, w0, strand, cfg_static
):
    """Seed-free banded extension at HOST-PREDICTED windows.

    The blockwise long-read DP (SURVEY §2.4/§5: carried-band sequence
    parallelism) re-uses this: chunk c+1's window is predicted from chunk
    c's alignment (neighbor-carried band state), so only a stride of chunks
    pays the seed-lookup stage, and seed-failed chunks are rescued at
    positions interpolated from their aligned neighbors.  `strand` picks the
    forward or reverse-complement chunk per row; mapq is 0 (a predicted
    placement carries no independent location evidence — the merge sums
    evidence from seeded chunks only).
    """
    pad, match, mismatch, gap = cfg_static[7:11]
    min_score_frac = cfg_static[12]
    codes_fwd = _unpack_reads_j(codes_packed, read_len)
    codes_rev = _rev_codes_j(codes_fwd, read_len)
    read = jnp.where((strand == 1)[:, None], codes_rev, codes_fwd)
    Lr = read.shape[1]
    W = Lr + 2 * pad
    n_extra = (W + 255) // 256
    T = (text2d.shape[0] - n_extra) * 256  # same bound as _all_candidates
    w0c = jnp.clip(w0.astype(jnp.int32), 0, T - W)
    window = _extract_windows(text2d, w0c, W)
    score, start_off, end_off, matches = _banded_extend(
        window, read, read_len, pad, match, mismatch, gap
    )
    ts = w0c + start_off
    te = w0c + end_off
    aligned = score >= (min_score_frac * read_len).astype(jnp.int32)
    mapq = jnp.zeros_like(score)
    return _pack_result_rows((ts, te, score, matches, mapq, strand, aligned))


def _pack_result_rows(res7):
    """Pack a 7-tuple query result into one int32 [4, B] array so the host
    boundary pays ONE device->host transfer per batch instead of seven.
    Rows: text_start, text_end, (score<<16 | matches), (mapq<<2|strand<<1|
    aligned).  Scores are clipped to int16 (reads are <= 8192bp, so real
    scores fit; only the NEG sentinel clips, and `aligned` carries validity).
    """
    ts, te, score, matches, mapq, strand, aligned = res7
    hi = (jnp.clip(score, -32768, 32767).astype(jnp.int32) << 16) | (
        matches.astype(jnp.int32) & 0xFFFF
    )
    flags = (
        (mapq.astype(jnp.int32) << 2)
        | (strand.astype(jnp.int32) << 1)
        | aligned.astype(jnp.int32)
    )
    return jnp.stack([ts.astype(jnp.int32), te.astype(jnp.int32), hi, flags])


@partial(jax.jit, static_argnames=("cfg_static",))
def _query_batch_packed(
    text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
    codes_packed, read_len, cfg_static
):
    return _pack_result_rows(_query_batch(
        text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
        codes_packed, read_len, cfg_static,
    ))


@partial(jax.jit, static_argnames=("cfg_static", "frag_max", "pair_bonus",
                                   "rescue_frac"))
def _query_batch_paired(
    text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
    codes1_packed, len1, codes2_packed, len2,
    cfg_static, frag_max: int, pair_bonus: int, rescue_frac: float,
):
    """Joint fragment-model alignment of mate pairs.

    The reference runs vg giraffe in paired mode with fragment-based rescue
    (/root/reference/pantax/src/alignment.rs:14-119, types.rs:34-48).  Here
    both mates' candidate sets are scored jointly: a candidate pair on
    opposite strands within ``frag_max`` text distance (same linearized
    haplotype by construction) earns ``pair_bonus``, so a mate that is
    ambiguous on its own is placed by its partner, and a weak mate within a
    consistent fragment is rescued at the relaxed ``rescue_frac`` threshold.
    Pair mapq is the joint score gap to the best alternative joint location.
    """
    mapq_scale, min_score_frac = cfg_static[11], cfg_static[12]
    B = len1.shape[0]
    # candidates for both mates in one device pass
    lens = jnp.concatenate([len1, len2], axis=0)
    codes_fwd = jnp.concatenate(
        [_unpack_reads_j(codes1_packed, len1),
         _unpack_reads_j(codes2_packed, len2)], axis=0
    )
    codes_rev = _rev_codes_j(codes_fwd, lens)
    scores, ts, te, matches, strand, node, off = _all_candidates(
        text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
        codes_fwd, codes_rev, lens, cfg_static,
    )
    K2 = scores.shape[1]
    s1, s2 = scores[:B], scores[B:]
    ts1, ts2 = ts[:B], ts[B:]
    st1, st2 = strand[:B], strand[B:]
    n1, n2 = node[:B], node[B:]
    o1, o2 = off[:B], off[B:]

    valid1 = s1 > NEG // 2
    valid2 = s2 > NEG // 2
    ok = (
        (st1[:, :, None] != st2[:, None, :])
        & (jnp.abs(ts1[:, :, None] - ts2[:, None, :]) <= frag_max)
        & valid1[:, :, None] & valid2[:, None, :]
    )
    pair = s1[:, :, None] + s2[:, None, :] + jnp.where(ok, pair_bonus, 0)
    pairf = pair.reshape(B, K2 * K2)
    best = jnp.argmax(pairf, axis=1)
    bi, bj = best // K2, best % K2
    t1 = lambda a: jnp.take_along_axis(a, bi[:, None], axis=1)[:, 0]
    t2 = lambda a: jnp.take_along_axis(a, bj[:, None], axis=1)[:, 0]
    p_best = jnp.take_along_axis(pairf, best[:, None], axis=1)[:, 0]
    ok_best = jnp.take_along_axis(
        ok.reshape(B, K2 * K2), best[:, None], axis=1
    )[:, 0]

    # joint second-best: best pair whose mates are NOT both at the chosen
    # graph locations (location dedup as in the single-end picker)
    same1 = (n1 == t1(n1)[:, None]) & (o1 == t1(o1)[:, None])
    same2 = (n2 == t2(n2)[:, None]) & (o2 == t2(o2)[:, None])
    same_pair = (same1[:, :, None] & same2[:, None, :]).reshape(B, K2 * K2)
    p_second = jnp.max(jnp.where(same_pair, NEG, pairf), axis=1)
    pair_mapq = jnp.where(
        p_second <= NEG // 2,
        60,
        jnp.clip((mapq_scale * (p_best - p_second)).astype(jnp.int32), 0, 60),
    )

    s1b, s2b = t1(s1), t2(s2)
    min1 = (min_score_frac * len1).astype(jnp.int32)
    min2 = (min_score_frac * len2).astype(jnp.int32)
    al1 = s1b >= min1
    al2 = s2b >= min2
    # fragment rescue: a consistent weak mate is kept when its partner
    # independently clears the normal threshold
    r1 = (rescue_frac * len1).astype(jnp.int32)
    r2 = (rescue_frac * len2).astype(jnp.int32)
    aligned1 = al1 | (ok_best & al2 & (s1b >= r1))
    aligned2 = al2 | (ok_best & al1 & (s2b >= r2))

    # per-mate mapq: the joint gap when the fragment is consistent,
    # otherwise the mate's own single-end gap
    own2_1 = jnp.max(jnp.where(same1, NEG, s1), axis=1)
    own2_2 = jnp.max(jnp.where(same2, NEG, s2), axis=1)
    own_mapq = lambda sb, o2nd: jnp.where(
        o2nd <= NEG // 2,
        60,
        jnp.clip((mapq_scale * (sb - o2nd)).astype(jnp.int32), 0, 60),
    )
    mapq1 = jnp.where(ok_best, pair_mapq, own_mapq(s1b, own2_1))
    mapq2 = jnp.where(ok_best, pair_mapq, own_mapq(s2b, own2_2))
    return (
        (t1(ts1), t1(te[:B]), s1b, t1(matches[:B]),
         jnp.where(aligned1, mapq1, 0), t1(st1), aligned1),
        (t2(ts2), t2(te[B:]), s2b, t2(matches[B:]),
         jnp.where(aligned2, mapq2, 0), t2(st2), aligned2),
    )


@partial(jax.jit, static_argnames=("cfg_static", "frag_max", "pair_bonus",
                                   "rescue_frac"))
def _query_batch_paired_packed(
    text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
    codes1_packed, len1, codes2_packed, len2,
    cfg_static, frag_max: int, pair_bonus: int, rescue_frac: float,
):
    r1, r2 = _query_batch_paired(
        text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
        codes1_packed, len1, codes2_packed, len2,
        cfg_static, frag_max, pair_bonus, rescue_frac,
    )
    return jnp.concatenate([_pack_result_rows(r1), _pack_result_rows(r2)])


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------
def build_bucket_table(seed_keys: np.ndarray) -> tuple[int, np.ndarray]:
    """Host-side prefix table: bucket_lo[b] = first index in the sorted key
    table whose key >= (b << (32 - bits)).  Sized at ~1/32 key per bucket —
    each extra bit halves the expected max occupancy, and every saved
    occupancy doubling removes one serial bisection gather from the device
    lookup (the kernel's dominant cost); capped at 2^24 buckets = 64MB."""
    n = max(len(seed_keys), 1)
    bits = int(np.clip(int(np.ceil(np.log2(n))) + 5, 12, 24))
    size = 1 << bits
    bounds = np.arange(size + 1, dtype=np.uint64) << np.uint64(32 - bits)
    lo = np.searchsorted(seed_keys.astype(np.uint64), bounds).astype(np.int32)
    return bits, lo


def _build_chd(
    keys: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, int, int] | None:
    """Displacement-hash (CHD-style) placement of distinct uint32 keys.

    Returns (slot int64 [n] — each key's unique position in a T-slot open
    table, disp int32 [m] — per-bucket displacement, mb — bucket bits, T),
    or None if placement does not converge (caller falls back to bisection).

    Vectorized greedy rounds: every still-unplaced bucket tries the same
    displacement d; a bucket wins the round when none of its keys lands on
    an occupied slot or collides with ANY other key probed this round
    (conservative: both duplicate parties retry — duplicates are rare at
    <= 0.65 load, and d+1 decorrelates repeat offenders)."""
    n = len(keys)
    # ~1 key per bucket: a failed probe then retries (mostly) alone, so each
    # round places ~(1 - load) of the pending keys and the loop converges in
    # a few dozen geometric rounds; multi-key buckets (birthday collisions,
    # ~20%) just need a d where all their keys place simultaneously.
    mb = min(max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1), 26)
    m = 1 << mb
    Tb = max(int(np.ceil(np.log2(max(n, 1) * 1.3))), 1)
    T = 1 << Tb
    from ..utils.native import chd_build_native

    native = chd_build_native(keys.astype(np.uint32), mb, Tb)
    if native is not None and native is not False:
        slot, disp = native
        return slot, disp, mb, T
    if native is False:
        return None
    mask = np.uint32(T - 1)
    from .encode import _mix32 as _mix32_np

    b = (keys >> np.uint32(32 - mb)).astype(np.int64)
    order = np.argsort(b, kind="stable")
    keys_s = keys[order]
    b_s = b[order]

    disp = np.zeros(m, dtype=np.int32)
    occupied = np.zeros(T, dtype=bool)
    # last-writer claim register: every slot a round probes is written before
    # it is read back, so stale entries from earlier rounds are never seen
    claim = np.zeros(T, dtype=np.int64)
    slot_s = np.full(n, -1, dtype=np.int64)
    pend_keys = keys_s
    pend_bucket = b_s  # stays ascending across rounds (filtered subsets)
    pend_kidx = np.arange(n, dtype=np.int64)
    d = 1
    while len(pend_keys) and d < (1 << 16):
        salt = np.uint32((_CHD_GOLD * d) & 0xFFFFFFFF)
        slots = (_mix32_np(pend_keys ^ salt) & mask).astype(np.int64)
        # a key fails on an occupied slot or when another key claims the
        # same slot this round (the last writer survives the collision)
        rid = np.arange(len(slots), dtype=np.int64)
        claim[slots] = rid
        bad = occupied[slots] | (claim[slots] != rid)
        # a bucket wins only if ALL its keys placed (keys share one d)
        seg = np.flatnonzero(
            np.concatenate([[True], pend_bucket[1:] != pend_bucket[:-1]])
        )
        seg_len = np.diff(np.concatenate([seg, [len(bad)]]))
        seg_bad = np.maximum.reduceat(bad.astype(np.int8), seg) > 0
        win = np.repeat(~seg_bad, seg_len)
        wslots = slots[win]
        occupied[wslots] = True
        slot_s[pend_kidx[win]] = wslots
        disp[pend_bucket[seg][~seg_bad]] = d
        keep = ~win
        pend_keys = pend_keys[keep]
        pend_bucket = pend_bucket[keep]
        pend_kidx = pend_kidx[keep]
        d += 1
    if len(pend_keys):
        return None
    slot = np.empty(n, dtype=np.int64)
    slot[order] = slot_s
    return slot, disp, mb, T


def build_seed_lookup(
    seed_keys: np.ndarray, seed_pos: np.ndarray, hits_per_seed: int = 4
) -> tuple[np.ndarray, np.ndarray, int, np.ndarray, int]:
    """Device lookup tables from the sorted seed table, run-granular (one
    row (key, start, len) per DISTINCT key).  Returns a 5-tuple shaped for
    _query_batch's positional args: (table, positions, bucket_bits, aux,
    plan); the plan integer feeds _lookup_hits (see its docstring).

    Fast path (plan = -1, CHD): table int32 [T, 2 + hits_per_seed] is an
    open slot table with each run at its perfect-hash slot carrying (key,
    run length, first hits_per_seed positions inline; empty slots have
    length 0), aux is the displacement array disp[2^bucket_bits], and the
    positions element is a dummy (unused) — the whole lookup is 2
    dependent gathers.

    Fallback (plan = steps >= 0, bisection): table is the key-sorted run
    table [D, 3] = (key, start, len), aux is bucket_lo (prefix table over
    runs), positions are the flat [S] seed positions."""
    S = len(seed_keys)
    pos = np.ascontiguousarray(seed_pos.astype(np.int32))
    if S == 0:
        return (
            np.zeros((1, 2 + hits_per_seed), np.int32),
            np.zeros(1, np.int32),
            1,
            np.zeros(2, np.int32),
            -1,
        )
    starts = np.flatnonzero(
        np.concatenate([[True], seed_keys[1:] != seed_keys[:-1]])
    ).astype(np.int64)
    ends = np.concatenate([starts[1:], [S]])
    run_keys = np.ascontiguousarray(seed_keys[starts]).astype(np.uint32)
    chd = _build_chd(run_keys)
    if chd is not None:
        slot, disp, mb, T = chd
        table = np.zeros((T, 2 + hits_per_seed), dtype=np.int32)
        table[slot, 0] = run_keys.view(np.int32)
        table[slot, 1] = (ends - starts).astype(np.int32)
        pos_wide = np.lib.stride_tricks.sliding_window_view(
            np.pad(pos, (0, hits_per_seed)), hits_per_seed
        )
        table[slot, 2:] = pos_wide[starts]
        return table, np.zeros(1, np.int32), mb, disp, -1
    run_table = np.stack(
        [
            run_keys.view(np.int32),
            starts.astype(np.int32),
            (ends - starts).astype(np.int32),
        ],
        axis=1,
    )
    bits, lo = build_bucket_table(seed_keys[starts])
    occ = int(np.diff(lo).max()) if len(lo) > 1 else 0
    steps = int(np.ceil(np.log2(occ + 1))) if occ > 0 else 0
    return np.ascontiguousarray(run_table), pos, bits, lo, steps


class Aligner:
    def __init__(self, index: AlignIndex, cfg: AlignConfig | None = None,
                 mesh=None):
        from ..parallel import default_mesh

        self.index = index
        self.cfg = cfg or AlignConfig()
        assert index.text_len % 256 == 0, "index text must be 256-padded (rebuild the align index)"
        self.mesh = mesh if mesh is not None else default_mesh()
        put = self._replicate
        self.text_d = put(pack_text2d(index.text))
        (run_table, pos, self.bucket_bits, bucket_lo,
         self.lookup_steps) = build_seed_lookup(
            index.seed_keys, index.seed_pos, self.cfg.hits_per_seed)
        self.run_table_d = put(run_table)
        self.seed_pos_d = put(pos)
        self.tstart_d = put(index.tstart.astype(np.int32))
        self.tnode_d = put(index.tnode.astype(np.int32))
        self.bucket_lo_d = put(bucket_lo)
        self._upload_cache: dict = {}
        # _cached_put runs from prefetch/prep worker threads concurrently
        # with the main thread; the lock keeps the clear-on-overflow eviction
        # from racing a concurrent insert.
        self._upload_lock = threading.Lock()

    def _replicate(self, arr):
        """Index arrays: replicated over the mesh, or plain device arrays."""
        if self.mesh is None:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(np.asarray(arr), NamedSharding(self.mesh, P()))

    def _shard_reads(self, arr):
        """Read-batch arrays: sharded over the mesh's "reads" axis (XLA then
        data-parallels the whole query across chips).  A batch length not
        divisible by the device count can't be sharded — it is REPLICATED
        (stays on the mesh so downstream jits see consistent devices) with a
        one-time warning: fix --batch-size to a multiple of the chip count."""
        arr = np.asarray(arr)
        if self.mesh is None:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding, PartitionSpec as P

        if len(arr) % self.mesh.devices.size:
            if not getattr(self, "_warned_indivisible", False):
                self._warned_indivisible = True
                log.warning(
                    "batch length %d is not divisible by the %d-device mesh;"
                    " replicating instead of sharding (every chip runs the"
                    " full batch — set --batch-size to a multiple of the"
                    " device count)", len(arr), self.mesh.devices.size,
                )
            return jax.device_put(arr, NamedSharding(self.mesh, P()))
        return jax.device_put(arr, NamedSharding(self.mesh, P("reads")))

    def _cached_put(self, arr: np.ndarray):
        """Content-addressed device cache for small per-batch side arrays
        (read lengths, N-exception lists).  These arrays are usually
        identical batch to batch — fixed-length Illumina runs repeat the
        same lens vector; N-free batches repeat the all-sentinel exception
        list — so re-using the previously-uploaded device buffer skips the
        upload."""
        if self.mesh is not None and self.mesh.devices.size > 1:
            return self._shard_reads(arr)
        key = (arr.dtype.str, arr.shape, arr.tobytes())
        with self._upload_lock:
            hit = self._upload_cache.get(key)
        if hit is None:
            hit = jnp.asarray(arr)
            with self._upload_lock:
                if len(self._upload_cache) > 16:
                    self._upload_cache.clear()
                self._upload_cache[key] = hit
        return hit

    def _pack_reads(self, codes: np.ndarray, lens: np.ndarray):
        """Wire format for a read batch: the 2-bit pack + exception list on a
        single device (halves the bandwidth-bound upload), or the legacy
        nibble pack on a multi-device mesh (the flat exception scatter would
        make GSPMD reshard the sharded batch) and on exception overflow.
        The jitted consumers accept either via _unpack_reads_j."""
        if self.mesh is None or self.mesh.devices.size == 1:
            p2 = pack_codes2(codes, np.asarray(lens))
            if p2 is not None:
                packed2, exc = p2
                return (self._shard_reads(packed2), self._cached_put(exc))
        if (self.mesh is not None and self.mesh.devices.size > 1
                and not getattr(self, "_warned_wire4", False)):
            self._warned_wire4 = True
            log.info(
                "multi-device mesh: read batches use the 4-bit wire format "
                "(the 2-bit pack's flat exception scatter would force GSPMD "
                "to reshard the batch)"
            )
        return self._shard_reads(pack_codes(codes))

    def _put_lens(self, lens: np.ndarray):
        """Read-length vector upload, deduped across batches (see
        _cached_put)."""
        return self._cached_put(np.ascontiguousarray(lens, dtype=np.int32))

    def _static(self) -> tuple:
        c = self.cfg
        return (
            self.index.k, self.index.density_bits, self.bucket_bits,
            self.lookup_steps, c.max_seeds, c.hits_per_seed,
            c.max_candidates, c.extension_band, c.match, c.mismatch, c.gap_extend,
            c.mapq_scale, c.min_score_frac,
        )

    _GRP_EXC_CAP = 32768  # N-exception cap per read-group buffer
    _GRP_ROW_QUANTUM = 32768  # buffer rows round up to this (16.7M bases
    #                           at chunk 512) so group buffers share graphs

    def put_read_group(self, enc_list, chunk: int, rows_min: int = 0):
        """Upload a whole read group ONCE as a device-resident 2-bit packed
        buffer for the chunked long-read flow: each chunk batch then ships
        only [B] int32 byte offsets instead of re-packing and re-uploading
        its bases (the rescue pass re-visits ~45% of chunks, so the codes
        path uploads every base ~1.45x; the buffer uploads each base once
        and drops ~100 per-batch uploads at 100k x 8kb reads).

        Returns None when the buffer wire doesn't apply (multi-device mesh:
        the exception scatter would force GSPMD resharding, same reason as
        _pack_reads' 4-bit fallback; or > _GRP_EXC_CAP N bases): callers
        fall back to the per-batch codes path.  Reads are padded to 4-base
        boundaries so every chunk offset is byte-aligned.

        The buffer's row count is QUANTIZED (padded up to a _GRP_ROW_QUANTUM
        multiple) because it is a jit argument shape: without it every
        streamed group compiles a fresh query+extend graph family.  Full
        groups from iter_read_groups land in the
        same bucket (their base totals differ by at most one read), and the
        upload-pipelined sub-group flow passes ``rows_min`` so every
        sub-buffer shares ONE shape."""
        if chunk % 4 or (self.mesh is not None and self.mesh.devices.size > 1):
            return None
        Wb = chunk // 4
        # reads padded to CHUNK boundaries: every chunk is one whole row of
        # the 2-D packed buffer (one gather index per chunk; ~3% padding at
        # 8kb reads vs 512 chunks)
        offs = np.zeros(len(enc_list), dtype=np.int64)
        pos = 0
        for i, e in enumerate(enc_list):
            offs[i] = pos
            pos += -(-len(e) // chunk) * chunk
        if pos >= (1 << 31):
            return None
        buf = np.zeros(pos + chunk, dtype=np.int8)  # final-row slack
        for e, o in zip(enc_list, offs):
            buf[o:o + len(e)] = e
        # one flat [1, total] row through the batch packer: the native
        # single pass packs + collects N positions (buffer base coords) at
        # memory bandwidth — the strided NumPy pack cost 3.4s of host time
        # per 160MB group and dominated the buffer wire's win
        p2 = pack_codes2(buf.reshape(1, -1),
                         np.array([len(buf)], dtype=np.int64),
                         cap=self._GRP_EXC_CAP)
        if p2 is None:
            return None
        packed_row, exc = p2
        packed = packed_row.reshape(-1, Wb)
        rows = packed.shape[0]
        q = self._GRP_ROW_QUANTUM
        rows_pad = max((rows + q - 1) // q * q, rows_min)
        if rows_pad > rows:  # zero rows; never addressed with lens > 0
            packed = np.vstack(
                [packed, np.zeros((rows_pad - rows, Wb), dtype=np.uint8)]
            )
        import jax

        return {
            "buf_d": jax.device_put(packed),
            "exc_d": self._cached_put(exc),
            "wm": np.empty((0, Wb), dtype=np.uint8),
            "read_off": offs,
            "chunk": chunk,
            "pad_off": (rows - 1) * chunk,  # last (slack) row
        }

    def _buf_wire(self, grp, base_off: np.ndarray):
        row_idx = (base_off // grp["chunk"]).astype(np.int32)
        return (grp["buf_d"], self._shard_reads(row_idx), grp["exc_d"],
                grp["wm"])

    def prep_codes_buf(self, grp, base_off: np.ndarray, lens: np.ndarray):
        """Upload one buffer-batch's wire arrays (row offsets + lens) without
        dispatching — the prefetch-thread half of dispatch_codes_buf (see
        prep_codes)."""
        return (self._buf_wire(grp, base_off), self._put_lens(lens))

    def dispatch_codes_buf(self, grp, base_off: np.ndarray, lens: np.ndarray):
        """dispatch_codes against a put_read_group buffer: rows are the
        chunks starting at ``base_off`` (buffer base coords, 4-aligned)."""
        return self.dispatch_prepped(self.prep_codes_buf(grp, base_off, lens))

    def prep_extend_buf(self, grp, base_off, lens, w0, strand):
        """Upload one extend-batch's wire arrays against a read-group buffer
        without dispatching (prefetch-thread half of dispatch_extend_buf)."""
        return (
            self._buf_wire(grp, base_off),
            self._put_lens(lens),
            self._shard_reads(w0.astype(np.int32)),
            self._shard_reads(strand.astype(np.int32)),
        )

    def prep_extend(self, codes, lens, w0, strand):
        """prep_extend_buf for the per-batch codes wire."""
        return (
            self._pack_reads(codes, lens),
            self._put_lens(lens),
            self._shard_reads(w0.astype(np.int32)),
            self._shard_reads(strand.astype(np.int32)),
        )

    def dispatch_extend_prepped(self, wire):
        """dispatch_extend for a prep_extend/prep_extend_buf result."""
        reads_dev, lens_dev, w0_dev, strand_dev = wire
        return _extend_batch(
            self.text_d, reads_dev, lens_dev, w0_dev, strand_dev,
            self._static(),
        )

    def dispatch_extend_buf(self, grp, base_off, lens, w0, strand):
        """dispatch_extend against a put_read_group buffer."""
        return self.dispatch_extend_prepped(
            self.prep_extend_buf(grp, base_off, lens, w0, strand)
        )

    def prep_codes(self, codes: np.ndarray, lens: np.ndarray):
        """Pack + upload one batch's wire arrays WITHOUT dispatching — safe
        to call from a single prefetch thread so the pack and upload overlap
        device compute and the main thread's result downloads (ops/fused._prepped_batches uses the same
        split for the fused loop)."""
        return (self._pack_reads(codes, lens), self._put_lens(lens))

    def dispatch_prepped(self, wire):
        """dispatch_codes for a prep_codes() result."""
        reads_dev, lens_dev = wire
        return _query_batch_packed(
            self.text_d, self.run_table_d, self.seed_pos_d, self.bucket_lo_d,
            self.tstart_d, self.tnode_d,
            reads_dev, lens_dev, self._static(),
        )

    def dispatch_codes(self, codes: np.ndarray, lens: np.ndarray):
        """Launch the query asynchronously; returns one packed device array
        ([4, B] int32 — see _pack_result_rows).  Use collect() to materialize
        a BatchResult — keeping several batches in flight pipelines host work
        against device compute."""
        return self.dispatch_prepped(self.prep_codes(codes, lens))

    def dispatch_extend(self, codes, lens, w0, strand):
        """Seed-free banded extension at predicted window starts ``w0``
        (int32 [B], text coords); ``strand`` int8 [B] picks fwd/revcomp per
        row.  Returns a packed device array for collect()."""
        return self.dispatch_extend_prepped(
            self.prep_extend(codes, lens, w0, strand)
        )

    def prep_paired_codes(self, codes1, lens1, codes2, lens2):
        """Pack + upload both mates' wire arrays without dispatching (the
        prefetch-thread half of dispatch_paired_codes — see prep_codes)."""
        return (
            self._pack_reads(codes1, lens1), self._put_lens(lens1),
            self._pack_reads(codes2, lens2), self._put_lens(lens2),
        )

    def dispatch_paired_prepped(self, wire):
        """dispatch_paired_codes for a prep_paired_codes() result."""
        c = self.cfg
        reads1_dev, lens1_dev, reads2_dev, lens2_dev = wire
        return _query_batch_paired_packed(
            self.text_d, self.run_table_d, self.seed_pos_d, self.bucket_lo_d,
            self.tstart_d, self.tnode_d,
            reads1_dev, lens1_dev, reads2_dev, lens2_dev,
            self._static(), c.frag_max, c.pair_bonus, c.rescue_frac,
        )

    def dispatch_paired_codes(self, codes1, lens1, codes2, lens2):
        """Launch a joint mate-pair query (fragment model); returns one
        packed device array ([8, B] int32: mate1 rows then mate2 rows) —
        materialize with collect_pair()."""
        return self.dispatch_paired_prepped(
            self.prep_paired_codes(codes1, lens1, codes2, lens2)
        )

    def align_paired_codes(self, codes1, lens1, codes2, lens2):
        """Joint mate-pair alignment -> (BatchResult mate1, BatchResult mate2)."""
        return self.collect_pair(self.dispatch_paired_codes(
            codes1, lens1, codes2, lens2))

    @staticmethod
    def _unpack_result(arr: np.ndarray) -> BatchResult:
        ts, te, hi, flags = arr
        return BatchResult(
            ts, te, hi >> 16, hi & 0xFFFF, (flags >> 2) & 0x3F,
            ((flags >> 1) & 1).astype(np.int8), (flags & 1).astype(bool),
        )

    @staticmethod
    def collect(out) -> BatchResult:
        if isinstance(out, tuple):  # unpacked 7-tuple (in-jit consumers)
            ts, te, score, matches, mapq, strand, aligned = (
                np.asarray(x) for x in out
            )
            return BatchResult(ts, te, score, matches, mapq, strand, aligned)
        return Aligner._unpack_result(np.asarray(out))

    @staticmethod
    def collect_pair(out) -> tuple[BatchResult, BatchResult]:
        arr = np.asarray(out)
        return Aligner._unpack_result(arr[:4]), Aligner._unpack_result(arr[4:])

    def align_codes(self, codes: np.ndarray, lens: np.ndarray) -> BatchResult:
        """codes int8 [B, Lr] padded with 4; lens int32 [B]."""
        return self.collect(self.dispatch_codes(codes, lens))

    def align_paired_files(
        self, path1, path2=None, batch_size: int = 4096,
        chunk_bytes: int = 64 << 20,
    ) -> list[GafRecord]:
        """Fragment-model alignment of mate pairs: two files (R1/R2, paired
        by order) or one interleaved file (path2=None) — the reference's
        ShortReadPaired / ShortReadPairedInter modes (types.rs:34-48,
        alignment.rs:14-119).

        Streams both inputs in ~chunk_bytes record-aligned buffers (the
        same bounded-memory policy as align_file): a 10M-pair run never
        holds whole files or their parsed records in RAM.  Interleaved
        chunks may end on an odd record; the dangling mate is carried into
        the next chunk."""
        from ..utils.native import fastx_parse_native, load_native

        if load_native() is None:
            raise ValueError(
                f"{path1}: paired mode needs the native parser"
            )

        from ..utils import pipeline_depth

        depth = pipeline_depth()
        pending = []
        out: list[GafRecord] = []

        def drain(entry):
            b_ids1, b_ids2, lens1, lens2, dev = entry
            res1, res2 = self.collect_pair(dev)
            out.extend(self._emit_gaf_lens(
                [(rid, None) for rid in b_ids1], lens1, res1))
            out.extend(self._emit_gaf_lens(
                [(rid, None) for rid in b_ids2], lens2, res2))

        def matrix(cf, of_, lo, hi, pad):
            lens = np.diff(of_[lo:hi + 1])
            codes = np.full((batch_size, pad), 4, dtype=np.int8)
            mask = np.arange(pad)[None, :] < lens[:, None]
            codes[:len(lens)][mask] = cf[of_[lo]:of_[hi]]
            lens_p = np.zeros(batch_size, dtype=np.int64)
            lens_p[: len(lens)] = lens
            return codes, lens_p

        # batch assembly + pack + upload run one batch ahead on a prefetch
        # worker (prep_paired_codes) so both mates' upload RPCs overlap the
        # collects instead of serializing between dispatches
        from concurrent.futures import ThreadPoolExecutor

        def parse(path, buf):
            parsed = fastx_parse_native(buf)
            if parsed is None:
                raise ValueError(f"{path}: unparseable FASTA/FASTQ chunk")
            return parsed

        from ..io.fastx import stream_paired_parsed

        with ThreadPoolExecutor(max_workers=1) as ex:
            prep_q: list = []  # ((ids1, ids2), future) in dispatch order

            def prep(cf1, of1, cf2, of2, lo, hi, pad):
                c1, len1 = matrix(cf1, of1, lo, hi, pad)
                c2, len2 = matrix(cf2, of2, lo, hi, pad)
                return len1, len2, self.prep_paired_codes(c1, len1, c2, len2)

            def pump(force=False):
                while prep_q and (force or prep_q[0][1].done()
                                  or len(prep_q) > 1):
                    (i1, i2), fut = prep_q.pop(0)
                    len1, len2, wire = fut.result()
                    pending.append((
                        i1, i2, len1, len2,
                        self.dispatch_paired_prepped(wire),
                    ))
                    if len(pending) >= depth:
                        drain(pending.pop(0))

            def feed_chunk(cf1, of1, ids1, cf2, of2, ids2):
                n = len(ids1)
                if n == 0:
                    return
                pad = _round_up(
                    int(max(np.diff(of1).max(), np.diff(of2).max()))
                )
                for lo in range(0, n, batch_size):
                    hi = min(lo + batch_size, n)
                    prep_q.append((
                        (ids1[lo:hi], ids2[lo:hi]),
                        ex.submit(prep, cf1, of1, cf2, of2, lo, hi, pad),
                    ))
                    pump()

            for block in stream_paired_parsed(path1, path2, parse,
                                              chunk_bytes):
                feed_chunk(*block)
            pump(force=True)
        for entry in pending:
            drain(entry)
        return out

    def align_file(
        self, path, batch_size: int = 4096, chunk_bytes: int = 64 << 20
    ) -> list[GafRecord]:
        """Align every read in a FASTA/FASTQ file (gzip ok), streaming the
        file in ~chunk_bytes record-aligned buffers so memory stays bounded
        for arbitrarily large inputs.  Uses the native C++ parser when
        available; falls back to the Python reader."""
        from ..io.fastx import stream_fastx_buffers
        from ..utils.native import fastx_parse_native, load_native

        if load_native() is None:
            from ..io.fastx import iter_fastx

            return self.align_reads(list(iter_fastx(path)), batch_size)

        # pipelined several batches deep: later batches run on device while
        # earlier batches' GAF records are emitted on the host (the queue is
        # carried across stream chunks).
        # Batch assembly + pack + upload run one batch ahead on a prefetch
        # worker (prep_codes) so the upload RPC overlaps the collects.
        from concurrent.futures import ThreadPoolExecutor

        from ..utils import pipeline_depth

        depth = pipeline_depth()
        pending: list[tuple[list, np.ndarray, object]] = []
        out: list[GafRecord] = []

        def drain(entry):
            b_ids, lens, dev = entry
            res = self.collect(dev)
            chunk = [(rid, None) for rid in b_ids]
            out.extend(self._emit_gaf_lens(chunk, lens, res))

        def prep(codes_flat, offsets, lens_all, pad_len, lo, hi):
            codes = np.full((batch_size, pad_len), 4, dtype=np.int8)
            lens = np.zeros(batch_size, dtype=np.int64)
            for i in range(lo, hi):
                L = int(lens_all[i])
                codes[i - lo, :L] = codes_flat[offsets[i] : offsets[i] + L]
                lens[i - lo] = L
            return lens, self.prep_codes(codes, lens)

        with ThreadPoolExecutor(max_workers=1) as ex:
            prep_q: list = []  # (ids, future) in dispatch order

            def pump():
                while prep_q and (prep_q[0][1].done() or len(prep_q) > 1):
                    b_ids, fut = prep_q.pop(0)
                    lens, wire = fut.result()
                    pending.append((b_ids, lens, self.dispatch_prepped(wire)))
                    if len(pending) >= depth:
                        drain(pending.pop(0))

            for buf in stream_fastx_buffers(path, chunk_bytes):
                parsed = fastx_parse_native(buf)
                if parsed is None:
                    raise ValueError(f"{path}: unparseable FASTA/FASTQ chunk")
                codes_flat, offsets, ids = parsed
                lens_all = np.diff(offsets)
                n = len(ids)
                if n == 0:
                    continue
                if lens_all.max() > 1000:
                    raise ValueError(
                        f"reads up to {int(lens_all.max())}bp in {path}: the short-read "
                        "engine handles <= ~1kb; use the long-read path (-l)"
                    )
                pad_len = _round_up(int(lens_all.max()))
                for lo in range(0, n, batch_size):
                    hi = min(lo + batch_size, n)
                    prep_q.append((
                        ids[lo:hi],
                        ex.submit(prep, codes_flat, offsets, lens_all,
                                  pad_len, lo, hi),
                    ))
                    pump()
            while prep_q:
                b_ids, fut = prep_q.pop(0)
                lens, wire = fut.result()
                pending.append((b_ids, lens, self.dispatch_prepped(wire)))
                if len(pending) >= depth:
                    drain(pending.pop(0))
        for entry in pending:
            drain(entry)
        return out

    def _emit_gaf_lens(self, chunk, lens, res: BatchResult) -> list[GafRecord]:
        """GAF emission when only read lengths (not sequences) are at hand."""
        fake = [(rid, b"x" * int(lens[i])) for i, (rid, _) in enumerate(chunk)]
        return self._emit_gaf(fake, res)

    def align_reads(
        self, reads: list[tuple[str, bytes]], batch_size: int = 512
    ) -> list[GafRecord]:
        """Align (read_id, seq) pairs, emitting GAF records for aligned reads."""
        if not reads:
            return []
        out: list[GafRecord] = []
        pad_len = _round_up(max(len(s) for _, s in reads))
        for lo in range(0, len(reads), batch_size):
            chunk = reads[lo : lo + batch_size]
            B = len(chunk)
            codes = np.full((batch_size, pad_len), 4, dtype=np.int8)
            lens = np.zeros(batch_size, dtype=np.int64)
            for i, (_, seq) in enumerate(chunk):
                codes[i, : len(seq)] = encode_seq(seq)
                lens[i] = len(seq)
            res = self.align_codes(codes, lens)
            out.extend(self._emit_gaf(chunk, res))
        return out

    def _emit_gaf(
        self, chunk: list[tuple[str, bytes]], res: BatchResult
    ) -> list[GafRecord]:
        """query_start/query_end cover the whole read because the short-read
        DP (_banded_extend) is full-query glocal: every query base is
        consumed (terminal mismatches are scored, never clipped), so
        [0, read_len) IS the aligned query span — unlike giraffe, which may
        soft-clip read ends.  Long reads go through align/long_read.py, which
        emits the chained sub-span honestly."""
        B = len(chunk)
        idx = self.index
        ts = res.text_start[:B].astype(np.int64)
        te = res.text_end[:B].astype(np.int64)
        i0, i1, off = idx.project(ts, te)
        records = []
        for j, (read_id, seq) in enumerate(chunk):
            if not res.aligned[j]:
                continue
            span = int(te[j] - ts[j])
            path_len = int(idx.tlen[int(i0[j]) : int(i1[j]) + 1].sum())
            rl = len(seq)
            records.append(
                GafRecord(
                    read_id=read_id,
                    read_len=rl,
                    query_start=0,
                    query_end=rl,
                    strand="+" if res.strand[j] == 0 else "-",
                    path=idx.path_str(int(i0[j]), int(i1[j])),
                    path_len=path_len,
                    path_start=int(off[j]),
                    path_end=int(off[j]) + span,
                    matches=int(res.matches[j]),
                    block_len=rl,
                    mapq=int(res.mapq[j]),
                    identity=float(res.matches[j]) / max(rl, 1),
                )
            )
        return records


def _round_up(n: int, m: int = 32) -> int:
    return ((n + m - 1) // m) * m
