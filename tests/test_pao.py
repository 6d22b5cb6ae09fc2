"""PAO solver: ADMM (JAX) against the exact scipy/HiGHS LP oracle."""
import numpy as np
import pytest

from pantax_tpu.profile.pao import sample_valid_nodes, solve_pao


def random_instance(rng, n=200, p=4):
    A = (rng.random((n, p)) < 0.45).astype(np.float64)
    A[:, 0] = (rng.random(n) < 0.8)  # denser first path
    x_true = rng.uniform(0, 5, size=p)
    x_true[rng.random(p) < 0.3] = 0.0
    noise = rng.normal(0, 0.05, size=n)
    b = np.maximum(A @ x_true + noise, 0.0)
    ub = 1.05 * max(b.max(), 1e-9)
    return A, b, ub


@pytest.mark.parametrize("seed", range(6))
def test_admm_matches_highs_objective(seed):
    rng = np.random.default_rng(seed)
    A, b, ub = random_instance(rng)
    exact = solve_pao(A, b, ub, solver="highs")
    admm = solve_pao(A, b, ub, solver="admm")
    # objective within tight relative tolerance of the exact LP optimum
    assert admm.objective <= exact.objective * (1 + 1e-3) + 1e-6
    np.testing.assert_allclose(admm.x, exact.x, atol=0.05)


def test_pinned_paths_are_zero():
    rng = np.random.default_rng(42)
    A, b, ub = random_instance(rng, p=5)
    pinned = np.array([False, True, False, True, False])
    res = solve_pao(A, b, ub, solver="admm", fixed_zero=pinned)
    assert res.x[1] == 0.0 and res.x[3] == 0.0
    exact = solve_pao(A, b, ub, solver="highs", fixed_zero=pinned)
    assert res.objective <= exact.objective * (1 + 1e-3) + 1e-6


def test_empty_rows():
    res = solve_pao(np.zeros((0, 3)), np.zeros(0), 1.0, solver="admm")
    assert res.x.shape == (3,)


def test_admm_vs_highs_property_50_instances():
    """Property sweep (VERDICT r1 item 7): |x_admm - x_highs| small and the
    second-filter strain SELECTION (the sensitive consumer of first_sol,
    profile.rs:1229-1285) agrees with the exact LP across >= 50 instances,
    including graph-extracted coefficient matrices."""
    from pantax_tpu.config import ProfilingConfig
    from pantax_tpu.profile.filters import HapMetrics, OtuState, second_filter_paths

    cfg = ProfilingConfig.for_read_type("short")

    def selection(x, trio_means, ratios, fracs):
        p = len(x)
        state = OtuState(
            otu="t", hap_metrics=[HapMetrics() for _ in range(p)],
            possible_paths_idx=list(range(p)), orign_n_haps=p,
            hap2trio_nodes_m_size=p,
        )
        for j in range(p):
            m = state.hap_metrics[j]
            m.first_sol = float(x[j])
            m.frequencies_mean = float(trio_means[j])
            m.path_cov_ratio = float(ratios[j])
            m.unique_trio_nodes_fraction = float(fracs[j])
        second_filter_paths(state, cfg)
        return tuple(sorted(state.second_possible_paths_idx))

    mismatches = 0
    checked = 0
    for seed in range(50):
        rng = np.random.default_rng(1000 + seed)
        p = int(rng.integers(2, 8))
        if seed % 3 == 2:
            # graph-extracted shape: overlapping-path structure — shared core
            # plus per-path private segments (what pangenome coeffs look like)
            n = int(rng.integers(60, 400))
            A = np.zeros((n, p))
            A[: n // 2, :] = 1.0  # shared core nodes
            priv = rng.integers(0, p, size=n - n // 2)
            A[np.arange(n // 2, n), priv] = 1.0
        else:
            A, _, _ = random_instance(rng, n=int(rng.integers(50, 400)), p=p)
        x_true = rng.uniform(0, 4, size=p)
        x_true[rng.random(p) < 0.25] = 0.0
        b = np.maximum(A @ x_true + rng.normal(0, 0.03, size=len(A)), 0.0)
        ub = 1.05 * max(b.max(), 1e-9)
        exact = solve_pao(A, b, ub, solver="highs")
        admm = solve_pao(A, b, ub, solver="admm")
        assert admm.objective <= exact.objective * (1 + 1e-3) + 1e-6, seed
        assert np.abs(admm.x - exact.x).max() < 0.1, seed
        # selection agreement through the divergence/rescue filter
        trio_means = np.maximum(x_true + rng.normal(0, 0.05, p), 0.0)
        ratios = rng.uniform(0.85, 1.0, p)
        fracs = rng.uniform(0.85, 1.0, p)
        checked += 1
        if selection(admm.x, trio_means, ratios, fracs) != selection(
            exact.x, trio_means, ratios, fracs
        ):
            mismatches += 1
    # the divergence filter rounds to 2dp, so only instances where both
    # solutions straddle a rounding boundary can disagree; allow a whisker
    assert checked == 50
    assert mismatches <= 1, f"{mismatches}/50 selection mismatches"


def test_batch_matches_serial():
    """solve_pao_batch (vmapped same-bucket ADMM + ub=0 pinning) agrees with
    per-instance solve_pao on solutions and with HiGHS on objectives, across
    mixed sizes (same and different buckets) and pinned instances."""
    from pantax_tpu.profile.pao import solve_pao_batch

    rng = np.random.default_rng(7)
    instances = []
    for k in range(6):
        n = int(rng.integers(50, 400)) if k != 4 else 5000  # one odd bucket
        p = int(rng.integers(2, 8))
        A, _, _ = random_instance(rng, n=n, p=p)
        x_true = rng.uniform(0, 4, size=p)
        b = np.maximum(A @ x_true + rng.normal(0, 0.03, size=n), 0.0)
        ub = 1.05 * max(b.max(), 1e-9)
        fz = None
        if k % 3 == 1:
            fz = rng.random(p) < 0.4
            if fz.all():
                fz[0] = False
        instances.append((A, b, ub, fz))

    batch = solve_pao_batch(instances, solver="admm")
    for (A, b, ub, fz), res in zip(instances, batch):
        serial = solve_pao(A, b, ub, solver="admm", fixed_zero=fz)
        exact = solve_pao(A, b, ub, solver="highs", fixed_zero=fz)
        assert res.objective <= exact.objective * (1 + 1e-3) + 1e-6
        np.testing.assert_allclose(res.x, serial.x, atol=0.05)
        if fz is not None:
            assert (res.x[fz] == 0.0).all()


def test_batch_engine_matches_serial_engine():
    """finish_two_stage over many species == per-species _solve_two_stage:
    the batched driver must not change first_sol/divergence/second_sol."""
    import copy

    from pantax_tpu.config import ProfilingConfig
    from pantax_tpu.profile.engine import (
        _solve_two_stage, finish_two_stage, prepare_two_stage,
    )
    from pantax_tpu.profile.filters import HapMetrics, OtuState

    cfg = ProfilingConfig.for_read_type("short")
    rng = np.random.default_rng(11)
    species = []
    for k in range(5):
        p = int(rng.integers(2, 6))
        nvert = int(rng.integers(40, 200))
        paths = {}
        for j in range(p):
            m = rng.random(nvert) < rng.uniform(0.3, 0.8)
            m[0] = True
            paths[f"h{j}"] = np.flatnonzero(m)
        x_true = rng.uniform(0.5, 4, size=p)
        node_abund = np.zeros(nvert)
        names = sorted(paths)
        for j, nm in enumerate(names):
            node_abund[paths[nm]] += x_true[j]
        node_abund = np.maximum(node_abund + rng.normal(0, 0.05, nvert), 0.0)
        node_len = rng.integers(20, 900, size=nvert).astype(np.int64)
        base_cov = (node_abund * node_len).astype(np.float64)
        state = OtuState(
            otu=f"sp{k}", hap_metrics=[HapMetrics() for _ in range(p)],
            possible_paths_idx=list(range(p)), orign_n_haps=p,
            hap2trio_nodes_m_size=p,
        )
        for j in range(p):
            m = state.hap_metrics[j]
            m.frequencies_mean = float(max(x_true[j] + rng.normal(0, 0.05), 0.01))
            m.unique_trio_nodes_fraction = float(rng.uniform(0.85, 1.0))
        species.append((state, nvert, paths, node_abund, base_cov, node_len))

    serial_states = []
    for st, nvert, paths, ab, bc, nl in copy.deepcopy(species):
        _solve_two_stage(st, nvert, paths, ab, bc, nl, cfg)
        serial_states.append(st)

    jobs = [
        prepare_two_stage(st, nvert, paths, ab, bc, nl, cfg)
        for st, nvert, paths, ab, bc, nl in species
    ]
    finish_two_stage(jobs, cfg)

    for st_b, st_s in zip((s[0] for s in species), serial_states):
        assert st_b.second_possible_paths_idx == st_s.second_possible_paths_idx
        for mb, ms in zip(st_b.hap_metrics, st_s.hap_metrics):
            assert (mb.first_sol is None) == (ms.first_sol is None)
            if mb.first_sol is not None:
                np.testing.assert_allclose(mb.first_sol, ms.first_sol, atol=0.05)
            assert mb.divergence == ms.divergence
            assert (mb.second_sol is None) == (ms.second_sol is None)
            if mb.second_sol is not None:
                np.testing.assert_allclose(mb.second_sol, ms.second_sol, atol=0.05)


def test_sampling_deterministic():
    nodes = np.arange(10000)
    a = sample_valid_nodes(nodes, 500, False)
    b = sample_valid_nodes(nodes, 500, False)
    np.testing.assert_array_equal(a, b)
    assert len(a) == 500
    assert (np.diff(a) > 0).all()
    c = sample_valid_nodes(np.arange(300), 500, False)
    assert len(c) == 300


@pytest.mark.parametrize("seed", range(3))
def test_admm_objective_within_1e_4_of_highs(seed):
    """The parity standard of the device solver: serial and batched ADMM
    (float32, HIGHEST-precision products, then polished) reach an objective
    within 1e-4 (relative) of the exact float64 HiGHS LP."""
    from pantax_tpu.profile.pao import solve_pao_batch

    rng = np.random.default_rng(100 + seed)
    instances = []
    for _ in range(3):
        A, b, ub = random_instance(rng, n=int(rng.integers(100, 600)),
                                   p=int(rng.integers(2, 8)))
        instances.append((A, b, ub, None))
    batch = solve_pao_batch(instances, solver="admm")
    for (A, b, ub, _), res in zip(instances, batch):
        exact = solve_pao(A, b, ub, solver="highs").objective
        serial = solve_pao(A, b, ub, solver="admm").objective
        for got in (res.objective, serial):
            assert got <= exact * (1 + 1e-4) + 1e-9


def _lowered_dots(case):
    import jax
    import jax.numpy as jnp

    from pantax_tpu.ops import coverage_device, profile_tail
    from pantax_tpu.profile import pao

    A = jnp.ones((16, 4), jnp.float32)
    b = jnp.ones(16, jnp.float32)
    if case == "admm_chunk":
        L = pao._ADMM_FACTOR_JIT(A)
        low = pao._admm_chunk.lower(A, b, 1.0, jnp.float32(1.0),
                                    pao._zero_state(A), L, iters=2)
    elif case == "admm_factor":
        low = pao._ADMM_FACTOR_JIT.lower(A)
    elif case == "tail_prepare":
        i32 = lambda *s: jnp.zeros(s, jnp.int32)
        low = profile_tail._prepare_batch.lower(
            b, i32(16), i32(1), i32(1), i32(1, 4), i32(1, 4),
            jnp.ones(1, jnp.float32), n_pad=16, p_pad=4, Lp=4)
    else:  # windowed coverage scatter: one-hot einsum over a short window
        R, Lw = 4, 8
        i32 = lambda *s: jnp.zeros(s, jnp.int32)
        low = jax.jit(
            coverage_device._coverage_scatter,
            static_argnames=("num_nodes", "total_bases", "num_trios",
                             "has_dups"),
        ).lower(i32(R, Lw), i32(R), i32(R), i32(R), i32(8), i32(9),
                jnp.zeros(4, jnp.uint32), i32(4), i32(4, 3),
                num_nodes=8, total_bases=64, num_trios=4, has_dups=True)
    return [ln for ln in low.as_text().splitlines() if "dot_general" in ln]


@pytest.mark.parametrize(
    "case", ["admm_chunk", "admm_factor", "tail_prepare", "coverage_scatter"])
def test_device_matmuls_pin_highest_precision(case):
    """Every float32 product on the device tail and coverage paths asks for
    full float32 precision: a GPU's default f32 matmul may round its inputs
    to TF32, which the 1e-4 objective standard cannot absorb."""
    dots = _lowered_dots(case)
    assert dots, "no matrix product found in the lowered program"
    for ln in dots:
        assert "precision = [HIGHEST, HIGHEST]" in ln, ln


@pytest.mark.parametrize("kind", ["random", "shared_core", "duplicate_path"])
def test_highs_ipm_oracle_matches_simplex_objective(kind):
    """The HiGHS oracle (interior point + crossover) reaches the simplex's
    optimal objective on PAO instances, degenerate ones included, and
    returns a feasible x; x itself may be another point of the optimal
    face when the optimum is not unique (PARITY.md)."""
    from scipy.optimize import linprog
    from scipy.sparse import csr_matrix, eye, hstack, vstack

    def simplex_objective(A, b, ub):
        n, p = A.shape
        As = csr_matrix(A)
        G = vstack([hstack([As, -eye(n)]), hstack([-As, -eye(n)])],
                   format="csr")
        c = np.concatenate([np.zeros(p), np.full(n, 1.0 / n)])
        res = linprog(c, A_ub=G, b_ub=np.concatenate([b, -b]),
                      bounds=[(0.0, ub)] * p + [(0.0, None)] * n,
                      method="highs-ds")
        assert res.success
        return float(np.abs(A @ res.x[:p] - b).sum() / n)

    for seed in range(8):
        rng = np.random.default_rng(500 + seed)
        p = int(rng.integers(2, 8))
        n = int(rng.integers(60, 400))
        A, _, _ = random_instance(rng, n=n, p=p)
        if kind == "shared_core":
            A = np.zeros((n, p))
            A[: n // 2] = 1.0
            A[np.arange(n // 2, n), rng.integers(0, p, n - n // 2)] = 1.0
        elif kind == "duplicate_path":
            A[:, 1] = A[:, 0]
        x_true = rng.uniform(0, 4, size=p)
        b = np.maximum(A @ x_true + rng.normal(0, 0.03, size=n), 0.0)
        ub = 1.05 * max(b.max(), 1e-9)
        got = solve_pao(A, b, ub, solver="highs")
        assert (got.x >= -1e-9).all() and (got.x <= ub + 1e-9).all()
        want = simplex_objective(A, b, ub)
        assert abs(got.objective - want) <= 1e-9 * max(want, 1e-12), seed
