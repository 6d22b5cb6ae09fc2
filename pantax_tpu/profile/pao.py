"""Path Abundance Optimization (PAO).

The reference solves, per species (/root/reference/pantax/src/profile.rs:1297-1511):

    min (1/n) sum_v y_v
    s.t. y_v >= +(sum_p A[v,p] x_p - b_v)
         y_v >= -(sum_p A[v,p] x_p - b_v)      for nodes v with b_v > 0
         0 <= x_p <= 1.05 * max(b)
         (binary "strain indicator" vars s_p with sum s_p <= npaths — these are
          never binding because minimization_min_cov defaults to 0, so the MILP
          reduces to the LP above)

i.e. box-constrained L1 regression  min (1/n) ||A x - b||_1,  A binary
node-membership.  Here it is solved with a two-block ADMM in JAX (device path):

    min (1/n)||z||_1 + I_[0,ub](w)   s.t.  z = A x - b,  w = x
    x-step:  (AtA + I) x = At (b + z - u_z) + (w - u_w)      (p x p solve)
    z-step:  soft-threshold(A x - b + u_z, 1/(n rho))
    w-step:  clip(x + u_w, 0, ub)

with over-relaxation.  A scipy/HiGHS backend provides the exact-LP oracle
(mirroring the reference's highs_opt, profile.rs:2689-2882).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

# Float32 products here run at full float32 precision: a GPU's default f32
# matmul may use TF32 (about three decimal digits), and the ADMM must land
# within 1e-4 of the exact LP objective.
_HIGHEST = jax.lax.Precision.HIGHEST


@dataclass
class PaoResult:
    x: np.ndarray          # [p] per-path coverage depth
    objective: float       # (1/n) * sum |Ax - b| over the selected nodes


# ---------------------------------------------------------------------------
# node subsampling (parity: profile.rs:1287-1295,1387-1403 — seed 42; the RNG
# differs from the reference's StdRng, but determinism knobs are preserved)
# ---------------------------------------------------------------------------
def sample_valid_nodes(
    valid_nodes: np.ndarray, sample_nodes: int, sample_test: bool
) -> np.ndarray:
    cap = 500 if sample_test else sample_nodes
    if cap and len(valid_nodes) > cap:
        rng = np.random.default_rng(42)
        picked = rng.choice(valid_nodes, size=cap, replace=False)
        return np.sort(picked)
    return valid_nodes


# ---------------------------------------------------------------------------
# ADMM backend (JAX)
# ---------------------------------------------------------------------------
def _admm_scan(A, b, ub, rho, n_eff, state, L, iters: int):
    """Run ``iters`` ADMM steps from ``state`` = (x, z, w, uz, uw); ``L`` is
    the Cholesky factor of (AtA + I), computed once."""
    thresh = 1.0 / (jnp.maximum(n_eff, 1) * rho)
    alpha = 1.6  # over-relaxation

    def step(carry, _):
        x, z, w, uz, uw = carry
        rhs = jnp.dot(A.T, b + z - uz, precision=_HIGHEST) + (w - uw)
        x = jax.scipy.linalg.cho_solve((L, True), rhs)
        Ax = jnp.dot(A, x, precision=_HIGHEST)
        Ax_r = alpha * Ax + (1 - alpha) * (z + b)
        x_r = alpha * x + (1 - alpha) * w
        z_new = Ax_r - b + uz
        z = jnp.sign(z_new) * jnp.maximum(jnp.abs(z_new) - thresh, 0.0)
        w = jnp.clip(x_r + uw, 0.0, ub)
        uz = uz + Ax_r - b - z
        uw = uw + x_r - w
        return (x, z, w, uz, uw), None

    return jax.lax.scan(step, state, None, length=iters)[0]


def _admm_factor(A):
    if not jnp.issubdtype(A.dtype, jnp.floating):
        # coefficient matrices are binary node-membership masks: callers
        # upload int8 (4x fewer bytes than f32) and the cast to f32 happens
        # on device, fused into the matmul
        A = A.astype(jnp.float32)
    p = A.shape[1]
    AtA = jnp.dot(A.T, A, precision=_HIGHEST) + jnp.eye(p, dtype=A.dtype)
    return jnp.linalg.cholesky(AtA)


def _zero_state(A):
    n, p = A.shape
    x0 = jnp.zeros(p, dtype=A.dtype)
    z0 = jnp.zeros(n, dtype=A.dtype)
    return (x0, z0, x0, z0, x0)


def _admm_body(A, b, ub, rho, n_eff, iters: int):
    """One traceable fixed-iteration ADMM run; ``n_eff`` is the L1 objective's
    node count (a traced scalar so masked/fused callers can pass the
    valid-node count)."""
    state = _admm_scan(A, b, ub, rho, n_eff, _zero_state(A), _admm_factor(A), iters)
    xf = jnp.clip(state[2], 0.0, ub)
    obj = jnp.sum(jnp.abs(jnp.dot(A, xf, precision=_HIGHEST) - b)) / jnp.maximum(
        n_eff, 1)
    return xf, obj


def _admm_chunk_impl(A, b, ub, rho, state, L, iters: int):
    """Advance the ADMM by ``iters`` steps and report a convergence residual:
    max of the primal infeasibilities max|Ax-b-z|, max|x-w| and the chunk's
    boundary progress max|w - w_entry| (dual proxy).  The host stops early on
    the residual without a data-dependent while_loop in the compiled graph.
    ``ub`` may be a scalar or a per-path [p] vector (0 pins a path to zero —
    the batched second solve uses this instead of column removal)."""
    if not jnp.issubdtype(A.dtype, jnp.floating):
        A = A.astype(jnp.float32)  # int8 upload, on-device cast (see factor)
    w_entry = state[2]
    state = _admm_scan(A, b, ub, rho, A.shape[0], state, L, iters)
    x, z, w, uz, uw = state
    r_z = jnp.max(jnp.abs(jnp.dot(A, x, precision=_HIGHEST) - b - z))
    r_w = jnp.max(jnp.abs(x - w))
    d_w = jnp.max(jnp.abs(w - w_entry))
    return state, jnp.maximum(jnp.maximum(r_z, r_w), d_w)


_admm_chunk = partial(jax.jit, static_argnames=("iters",))(_admm_chunk_impl)


@partial(jax.jit, static_argnames=("iters",))
def _admm_chunk_batch(A, b, ub, rho, state, L, iters: int):
    """vmapped _admm_chunk over a leading instance axis: species sharing a
    padded bucket shape solve in ONE device program (the reference's rayon
    species axis, profile.rs:3297, as a batch axis instead of threads)."""
    return jax.vmap(
        lambda A, b, ub, state, L: _admm_chunk_impl(A, b, ub, rho, state, L, iters)
    )(A, b, ub, state, L)


_ADMM_FACTOR_BATCH_JIT = jax.jit(jax.vmap(_admm_factor))


def _bucket(n: int, quantum: int | None = None) -> int:
    """Round up to a power-of-two multiple of quantum so species of different
    sizes share compiled ADMM shapes (per-shape jit compiles dominate
    otherwise).  Zero-padded rows contribute |0 - 0| = 0 to the objective and
    padded columns are discarded, so the optimum is unchanged.
    PANTAX_TPU_ADMM_QUANTUM overrides the floor (A/B: smaller buckets make
    tiny-species solves cheaper at the cost of more compiled shapes)."""
    if quantum is None:
        quantum = int(os.environ.get("PANTAX_TPU_ADMM_QUANTUM", "4096"))
    m = quantum
    while m < n:
        m *= 2
    return m


_ADMM_FACTOR_JIT = jax.jit(_admm_factor)


def _solve_admm(
    A: np.ndarray, b: np.ndarray, ub: float,
    iters: int = 1500, chunk: int = 250, tol: float = 1e-5,
) -> PaoResult:
    """ADMM with residual-based early stopping: run jitted chunks of
    ``chunk`` iterations and stop when the primal/dual residual of the
    scale-normalized problem drops below ``tol`` (most instances converge in
    1-2 chunks; ``iters`` caps the worst case).  The host polish then turns
    the near-solution into an exact LP vertex."""
    n, p = A.shape
    n_pad = _bucket(max(n, 1))
    p_pad = max(4, -(-p // 4) * 4)
    A_pad = np.zeros((n_pad, p_pad), dtype=np.float32)
    A_pad[:n, :p] = A
    b_pad = np.zeros(n_pad, dtype=np.float32)
    b_pad[:n] = b
    A_j = jnp.asarray(A_pad)
    b_j = jnp.asarray(b_pad)
    scale = float(np.max(b)) if len(b) and np.max(b) > 0 else 1.0
    rho = jnp.float32(1.0)
    b_nrm = b_j / scale
    ub_nrm = ub / scale
    L = _ADMM_FACTOR_JIT(A_j)
    state = _zero_state(A_j)
    for _ in range(max(iters // chunk, 1)):
        state, res = _admm_chunk(A_j, b_nrm, ub_nrm, rho, state, L, chunk)
        if float(np.asarray(res)) < tol:
            break
    x = np.clip(np.asarray(state[2], dtype=np.float64), 0.0, ub_nrm)[:p] * scale
    # polish: per-coordinate exact line search (coordinate descent on the LP)
    x = _polish(A.astype(np.float64), b.astype(np.float64), x, ub)
    obj = float(np.abs(A @ x - b).sum() / max(len(b), 1))
    return PaoResult(x=x, objective=obj)


def _polish(A: np.ndarray, b: np.ndarray, x: np.ndarray, ub, sweeps: int = 8) -> np.ndarray:
    """Coordinate-wise exact minimization of ||Ax - b||_1 within the box.

    Along one coordinate, sum_v |r_v + c_v t| is convex piecewise linear with
    breakpoints -r_v / c_v and slopes |c_v|; the unconstrained minimizer is
    the weighted median of the breakpoints, and the boxed optimum is its clip
    to [-x_j, ub - x_j] (convexity).  O(n log n) per coordinate, turning the
    ADMM near-solution into an exact LP vertex in a few sweeps.
    """
    n, p = A.shape
    if n == 0 or p == 0:
        return x
    ub = np.broadcast_to(np.asarray(ub, dtype=np.float64), x.shape)
    r = A @ x - b
    cols_nz = [A[:, j] != 0 for j in range(p)]
    # binary membership columns (the PAO case): unit weights make the
    # weighted median a plain k-th order statistic — np.partition is O(n)
    # vs the generic argsort path, and selects the identical element
    # (k = first index where the unit-weight cumsum reaches half)
    cols_binary = [bool((A[:, j][nz] == 1.0).all()) for j, nz in
                   enumerate(cols_nz)]
    for _ in range(sweeps):
        moved = 0.0
        for j in range(p):
            col = A[:, j]
            nz = cols_nz[j]
            if not nz.any():
                continue
            if cols_binary[j]:
                breaks = -r[nz]
                k = (len(breaks) - 1) // 2
                t_star = np.partition(breaks, k)[k]
            else:
                breaks = -(r[nz] / col[nz])
                w = np.abs(col[nz])
                order = np.argsort(breaks)
                cw = np.cumsum(w[order])
                half = cw[-1] / 2.0
                t_star = breaks[order][int(np.searchsorted(cw, half))]
            t = float(np.clip(t_star, -x[j], ub[j] - x[j]))
            if t != 0.0:
                x[j] += t
                r += col * t
                moved += abs(t)
        if moved < 1e-12:
            break
    return x


# ---------------------------------------------------------------------------
# HiGHS backend (scipy) — exact LP oracle
# ---------------------------------------------------------------------------
def _solve_highs(A: np.ndarray, b: np.ndarray, ub: float) -> PaoResult:
    from scipy.optimize import linprog
    from scipy.sparse import csr_matrix, eye, hstack

    n, p = A.shape
    if n == 0:
        return PaoResult(x=np.zeros(p), objective=0.0)
    As = csr_matrix(A)
    In = eye(n, format="csr")
    # vars [x (p), y (n)]; constraints  A x - y <= b,  -A x - y <= -b
    A_ub = hstack([As, -In], format="csr")
    A_ub2 = hstack([-As, -In], format="csr")
    from scipy.sparse import vstack

    G = vstack([A_ub, A_ub2], format="csr")
    h = np.concatenate([b, -b])
    c = np.concatenate([np.zeros(p), np.full(n, 1.0 / n)])
    bounds = [(0.0, ub)] * p + [(0.0, None)] * n
    # interior point + crossover: the same optimal objective as the simplex,
    # several times sooner on species-sized instances (tens of thousands of
    # rows).  Where the optimum is not unique the two can stop at different
    # optimal points (PARITY.md, "Other solver backends")
    res = linprog(c, A_ub=G, b_ub=h, bounds=bounds, method="highs-ipm")
    if not res.success:
        raise RuntimeError(f"PAO LP failed: {res.message}")
    x = res.x[:p]
    obj = float(np.abs(A @ x - b).sum() / n)
    return PaoResult(x=x, objective=obj)


def solve_pao_batch(
    instances: list[tuple[np.ndarray, np.ndarray, float, np.ndarray | None]],
    solver: str = "admm",
    iters: int = 1500,
    chunk: int = 250,
    tol: float = 1e-5,
) -> list[PaoResult]:
    """Solve many independent PAO instances ``(A, b, ub, fixed_zero|None)``.

    Same-bucket ADMM instances are stacked and solved in ONE jitted device
    program (vmapped ADMM) — the reference's rayon species loop
    (profile.rs:3297) as a batch axis instead of threads, so S species cost
    one dispatch per residual chunk instead of S.  Path pinning uses a
    per-path upper bound of 0 (x in [0,0] ⇔ column removal), so first and
    second solves share shapes, compiled programs and the Cholesky factors.
    Non-admm solvers and singleton buckets fall through to `solve_pao`
    (bit-identical to the serial path).  Results come back in input order.
    """
    results: list[PaoResult | None] = [None] * len(instances)
    prepped: list[tuple | None] = [None] * len(instances)
    groups: dict[tuple[int, int], list[int]] = {}
    for i, (A, b, ub, fz) in enumerate(instances):
        A = np.asarray(A, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        n, p = A.shape
        if solver != "admm" or n == 0 or p == 0:
            results[i] = solve_pao(A, b, ub, solver=solver, fixed_zero=fz)
            continue
        prepped[i] = (A, b, float(ub), fz)
        key = (_bucket(n), max(4, -(-p // 4) * 4))
        groups.setdefault(key, []).append(i)

    for (n_pad, p_pad), idxs in groups.items():
        if len(idxs) == 1:
            i = idxs[0]
            A, b, ub, fz = prepped[i]
            results[i] = solve_pao(A, b, ub, solver="admm", fixed_zero=fz)
            continue
        S = len(idxs)
        # node-membership matrices are binary (profile.rs:1333-1343): upload
        # int8 (4x fewer bytes), cast to f32 on device; general-valued
        # A (not produced by any current caller) falls back to f32
        binary = all(
            ((prepped[i][0] == 0) | (prepped[i][0] == 1)).all() for i in idxs
        )
        A_st = np.zeros((S, n_pad, p_pad), dtype=np.int8 if binary else np.float32)
        b_st = np.zeros((S, n_pad), dtype=np.float32)
        ub_st = np.zeros((S, p_pad), dtype=np.float32)
        scales = np.ones(S, dtype=np.float64)
        for s, i in enumerate(idxs):
            A, b, ub, fz = prepped[i]
            n, p = A.shape
            A_st[s, :n, :p] = A
            scale = float(np.max(b)) if len(b) and np.max(b) > 0 else 1.0
            scales[s] = scale
            b_st[s, :n] = b / scale
            ubv = np.full(p, ub / scale, dtype=np.float32)
            if fz is not None:
                ubv[np.asarray(fz, dtype=bool)] = 0.0
            ub_st[s, :p] = ubv
        A_j = jnp.asarray(A_st)
        b_j = jnp.asarray(b_st)
        ub_j = jnp.asarray(ub_st)
        L = _ADMM_FACTOR_BATCH_JIT(A_j)
        x0 = jnp.zeros((S, p_pad), dtype=jnp.float32)
        z0 = jnp.zeros((S, n_pad), dtype=jnp.float32)
        state = (x0, z0, x0, z0, x0)
        rho = jnp.float32(1.0)
        for _ in range(max(iters // chunk, 1)):
            state, res = _admm_chunk_batch(A_j, b_j, ub_j, rho, state, L, chunk)
            if float(np.max(np.asarray(res))) < tol:
                break
        X = np.asarray(state[2], dtype=np.float64)

        def _finish(s: int, i: int) -> None:
            A, b, ub, fz = prepped[i]
            n, p = A.shape
            ubv = np.full(p, ub, dtype=np.float64)
            if fz is not None:
                ubv[np.asarray(fz, dtype=bool)] = 0.0
            x = np.clip(X[s, :p] * scales[s], 0.0, ubv)
            x = _polish(A, b, x, ubv)
            obj = float(np.abs(A @ x - b).sum() / max(len(b), 1))
            results[i] = PaoResult(x=x, objective=obj)

        if S > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(8, S)) as ex:
                list(ex.map(lambda si: _finish(*si), enumerate(idxs)))
        else:
            _finish(0, idxs[0])
    return results


def solve_pao(
    A: np.ndarray,
    b: np.ndarray,
    ub: float,
    solver: str = "admm",
    fixed_zero: np.ndarray | None = None,
) -> PaoResult:
    """Solve min (1/n)||A x - b||_1, 0 <= x <= ub, optionally pinning a subset
    of paths to zero (the reference's second solve adds x_p == 0 constraints,
    profile.rs:1482-1510)."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    p = A.shape[1]
    if fixed_zero is not None and fixed_zero.any():
        free = ~fixed_zero
        sub = solve_pao(A[:, free], b, ub, solver=solver)
        x = np.zeros(p)
        x[free] = sub.x
        return PaoResult(x=x, objective=sub.objective)
    if p == 0:
        return PaoResult(x=np.zeros(0), objective=float(np.abs(b).sum() / max(len(b), 1)))
    if solver == "highs":
        return _solve_highs(A, b, ub)
    if solver == "admm":
        return _solve_admm(A, b, ub)
    raise ValueError(f"unknown PAO solver {solver!r}")
