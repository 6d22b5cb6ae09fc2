"""The production banded glocal DP (aligner._banded_extend) against a literal
NumPy oracle of the same recurrence, on noisy window-derived reads with small
indels and variable lengths."""
import numpy as np
import pytest

import jax.numpy as jnp

from pantax_tpu.align.aligner import _banded_extend

PAD, MATCH, MIS, GAP = 8, 1, -1, -2


def _case(rng, N=64, Lr=96, T=8192):
    text = rng.integers(0, 4, size=T).astype(np.int8)
    text = np.concatenate([text, np.full(1024, 4, dtype=np.int8)])
    w0 = rng.integers(0, T - (Lr + 2 * PAD) - 1, size=N).astype(np.int32)
    reads = np.empty((N, Lr), dtype=np.int8)
    lens = rng.integers(Lr // 2, Lr + 1, size=N).astype(np.int32)
    for i in range(N):
        # window-derived read with noise and small indels
        start = w0[i] + PAD + rng.integers(-4, 5)
        seg = text[start : start + Lr].copy()
        m = rng.random(Lr) < 0.05
        seg[m] = rng.integers(0, 4, size=int(m.sum()))
        reads[i] = seg[:Lr]
        reads[i, lens[i]:] = 4
    return text, w0, reads, lens


def _oracle(window, read, n, pad):
    """Banded glocal DP for one read, cells (score, matches, start) compared
    lexicographically.  Band row b at read position i aligns read[i] to
    window[i + b], for b in [0, 2*pad).  Row i = 0 starts anywhere in the band
    (free start); each later row takes the best of a diagonal step, an
    insertion (read base against a gap: row b from row b+1 of i-1) and then
    deletions (reference bases skipped: b from any j < b in the same row),
    each gap base costing GAP.  Returns (score, start, end, matches) with
    end = the window column after the best cell of the last row, lowest band
    row first on ties."""
    wb = 2 * pad

    def sub(i, b):
        x, y = int(read[i]), int(window[i + b])
        ok = x == y and x < 4 and y < 4
        return (MATCH if ok else MIS), int(ok)

    row = []
    for b in range(wb):
        s, m = sub(0, b)
        row.append((s, m, b))
    for i in range(1, n):
        v = []
        for b in range(wb):
            s, m = sub(i, b)
            diag = (row[b][0] + s, row[b][1] + m, row[b][2])
            if b + 1 < wb:
                up = (row[b + 1][0] + GAP, row[b + 1][1], row[b + 1][2])
                diag = max(diag, up)
            v.append(diag)
        row = []
        for b in range(wb):
            best = v[b]
            for j in range(b):
                cand = (v[j][0] + (b - j) * GAP, v[j][1], v[j][2])
                best = max(best, cand)
            row.append(best)
    b_best = max(range(wb), key=lambda b: (row[b], -b))
    score, matches, start = row[b_best]
    return score, start, n - 1 + b_best + 1, matches


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_banded_extend_matches_numpy_oracle(seed):
    rng = np.random.default_rng(seed)
    text, w0, reads, lens = _case(rng)
    W = reads.shape[1] + 2 * PAD
    windows = np.stack([text[s : s + W] for s in w0])
    got = _banded_extend(
        jnp.asarray(windows), jnp.asarray(reads), jnp.asarray(lens),
        PAD, MATCH, MIS, GAP,
    )
    want = np.array([
        _oracle(windows[i], reads[i], int(lens[i]), PAD)
        for i in range(len(reads))
    ])
    for col, name in enumerate(["score", "start", "end", "matches"]):
        np.testing.assert_array_equal(
            np.asarray(got[col]), want[:, col], err_msg=name)
