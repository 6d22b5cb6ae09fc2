"""Device-resident profile tail (ops/profile_tail.py): stats parity against
the host filters' own math, branch-logic bit-parity with first_filter_paths,
device PAO vs the host solver, and end-to-end device-tail vs host-tail tables
on the example database."""
import numpy as np
import pytest

from pantax_tpu.config import ProfilingConfig
from pantax_tpu.profile.filters import (
    HapMetrics, OtuState, first_filter_paths, zscore_filter,
)

EXAMPLE_INFO = "/root/reference/example/example_genomes_info.txt"
BASE = "/root/reference/example/ngs"


# ---------------------------------------------------------------------------
# helpers: exact host stats for a single synthetic species
# ---------------------------------------------------------------------------
def _host_stats_single(paths, trio_index, ta, na, bc, nodes_len, min_depth):
    """TailStats computed with the host filters' own float64 math."""
    from pantax_tpu.ops.profile_tail import TailStats

    names = sorted(paths)
    hm = trio_index.hap_matrix
    G = len(names)
    c1 = np.zeros(G)
    freq = np.zeros(G)
    pcov = np.zeros(G)
    for h in range(G):
        mask = hm[:, h] > 0 if hm.size else np.zeros(0, bool)
        vals = np.asarray(ta)[mask]
        nz = vals[vals > 0.0]
        c1[h] = len(nz)
        kept = zscore_filter(nz, 3.0) if len(nz) else np.zeros(0)
        freq[h] = float(kept.mean()) if kept.size else 0.0
        pcov[h] = float(
            np.asarray(bc, dtype=np.float32)[paths[names[h]]].sum(
                dtype=np.float32)
        )
    na_opt = np.where(np.asarray(na) > min_depth, np.asarray(na), 0.0)
    nz = na_opt[na_opt > 0.0]
    return TailStats(
        c1=c1,
        freq_mean=freq,
        path_cov=pcov,
        sp_nz_mean=np.array([float(nz.mean()) if nz.size else 0.0]),
        sp_max=np.array([float(np.max(na)) if len(na) else 0.0]),
        sp_valid=np.array([float((np.asarray(na) > 0).sum())]),
    )


def _single_species_tt(paths, trio_index, nodes_len):
    """Hand-built TailTables for one species at node offset 0 (unit tests
    bypass build_tail_tables' FusedTables dependency)."""
    import jax.numpy as jnp

    from pantax_tpu.ops.profile_tail import TailTables, segment_layout

    names = sorted(paths)
    G = len(names)
    parts = [np.asarray(paths[n], dtype=np.int32) for n in names]
    hm = trio_index.hap_matrix
    off = np.zeros(G + 1, dtype=np.int64)
    np.cumsum([len(p) for p in parts], out=off[1:])
    path_list = [np.asarray(paths[n]) for n in names]
    trio_hap = (np.argmax(hm, axis=1).astype(np.int32)
                if hm.size else np.zeros(0, np.int32))
    path_node = np.concatenate(parts)
    path_hap = np.repeat(np.arange(G, dtype=np.int32), [len(p) for p in parts])
    node_species = np.zeros(len(nodes_len), np.int32)
    return TailTables(
        trio_hap_d=jnp.asarray(trio_hap),
        path_node_d=jnp.asarray(path_node),
        node_species_d=jnp.asarray(node_species),
        trio_lay=segment_layout(trio_hap, G),
        path_lay=segment_layout(path_hap, G, src=path_node),
        node_lay=segment_layout(node_species, 1),
        hap_node_off=off,
        trio_count=np.array(
            [(hm[:, h] > 0).sum() if hm.size else 0 for h in range(G)],
            dtype=np.int64,
        ),
        path_len=np.array([
            float(np.asarray(nodes_len, np.float32)[p].sum(dtype=np.float32))
            for p in parts
        ]),
        hap_species=np.zeros(G, np.int32),
        hap_local=np.arange(G, dtype=np.int32),
        sp_hap_lo=np.array([0, G], dtype=np.int64),
        sp_all_same=np.array([
            all(np.array_equal(path_list[0], q) for q in path_list[1:])
        ]),
        sp_m_size=np.array([hm.size], dtype=np.int64),
        sp_nvert=np.array([len(nodes_len)], dtype=np.int64),
        sp_off=np.array([0], dtype=np.int64),
        G=G,
        S=1,
    )


def _random_species(rng, n_haps=4, n_nodes=160):
    """Random chain-ish paths sharing a node pool, with enough unique trios."""
    from pantax_tpu.graph.trio import build_trio_index

    nodes_len = rng.integers(1, 40, size=n_nodes).astype(np.int64)
    base = np.arange(n_nodes, dtype=np.int64)  # 0-based local ids (paths_dict)
    paths = {}
    for h in range(n_haps):
        keep = rng.random(n_nodes) > 0.25
        p = base[keep]
        # splice a private detour so each hap owns some unique trios
        ins = rng.permutation(p[: max(len(p) // 4, 3)])
        paths[f"hap{h}"] = np.concatenate([p, ins])
    ti = build_trio_index(nodes_len, paths)
    return nodes_len, paths, ti


# ---------------------------------------------------------------------------
# branch-logic bit-parity: exact stats -> identical filter output
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("case", ["multi", "same", "single", "notrio"])
def test_first_filter_from_stats_bit_parity(shift, case):
    from pantax_tpu.graph.trio import build_trio_index
    from pantax_tpu.ops.profile_tail import first_filter_from_stats

    rng = np.random.default_rng(42 + shift)
    for trial in range(6):
        if case == "multi":
            nodes_len, paths, ti = _random_species(rng)
        elif case == "same":
            n = 64
            nodes_len = rng.integers(1, 20, size=n).astype(np.int64)
            p = np.arange(n)
            paths = {"a": p, "b": p.copy(), "c": p.copy()}
            ti = build_trio_index(nodes_len, paths)
        elif case == "single":
            n = 64
            nodes_len = rng.integers(1, 20, size=n).astype(np.int64)
            paths = {"only": np.arange(n)}
            ti = build_trio_index(nodes_len, paths)
        else:  # notrio: distinct 2-node paths -> no windows at all
            nodes_len = np.array([5, 7, 9, 11], dtype=np.int64)
            paths = {"a": np.array([0, 1]), "b": np.array([2, 3])}
            ti = build_trio_index(nodes_len, paths)
        n_nodes = len(nodes_len)
        U = ti.num_unique
        ta = np.where(
            rng.random(U) < 0.35, 0.0, rng.gamma(2.0, 5.0, size=U)
        )
        na = np.where(
            rng.random(n_nodes) < 0.3, 0.0, rng.gamma(2.0, 5.0, size=n_nodes)
        )
        bc = rng.integers(0, 20, size=n_nodes).astype(np.int64)
        cfg = ProfilingConfig(shift=shift, min_depth=0.5)

        na_opt = np.where(na > cfg.min_depth, na, 0.0)
        want = OtuState(otu="x", hap_metrics=[HapMetrics() for _ in paths])
        first_filter_paths(want, paths, ti.hap_matrix, ta, na_opt, cfg)

        tt = _single_species_tt(paths, ti, nodes_len)
        stats = _host_stats_single(
            paths, ti, ta, na, bc, nodes_len, cfg.min_depth
        )
        got = OtuState(otu="x", hap_metrics=[HapMetrics() for _ in paths])
        first_filter_from_stats(got, 0, tt, stats, sorted(paths), cfg)

        assert got.possible_paths_idx == want.possible_paths_idx
        assert got.same_path_flag == want.same_path_flag
        assert got.orign_n_haps == want.orign_n_haps
        assert got.hap2trio_nodes_m_size == want.hap2trio_nodes_m_size
        for g, w in zip(got.hap_metrics, want.hap_metrics):
            assert g.unique_trio_nodes_fraction == w.unique_trio_nodes_fraction
            if w.frequencies_mean is None:
                assert g.frequencies_mean is None
            else:
                assert g.frequencies_mean == pytest.approx(
                    w.frequencies_mean, rel=1e-12
                )


# ---------------------------------------------------------------------------
# device stats vs host math
# ---------------------------------------------------------------------------
def test_tail_stats_matches_host_math():
    import jax.numpy as jnp

    from pantax_tpu.ops.profile_tail import compute_tail_stats

    rng = np.random.default_rng(7)
    nodes_len, paths, ti = _random_species(rng, n_haps=5, n_nodes=200)
    n_nodes = len(nodes_len)
    U = ti.num_unique
    assert U > 10
    ta = np.where(rng.random(U) < 0.3, 0.0, rng.gamma(2.0, 4.0, size=U))
    na = np.where(
        rng.random(n_nodes) < 0.25, 0.0, rng.gamma(2.0, 4.0, size=n_nodes)
    )
    bc = rng.integers(0, 30, size=n_nodes).astype(np.int32)

    tt = _single_species_tt(paths, ti, nodes_len)
    got = compute_tail_stats(
        tt, jnp.asarray(na.astype(np.float32)), jnp.asarray(ta.astype(np.float32)),
        jnp.asarray(bc), min_depth=0.5,
    )
    want = _host_stats_single(paths, ti, ta, na, bc, nodes_len, 0.5)
    np.testing.assert_array_equal(got.c1, want.c1)          # exact counts
    np.testing.assert_allclose(got.freq_mean, want.freq_mean, rtol=1e-5)
    np.testing.assert_array_equal(got.path_cov, want.path_cov)  # exact ints
    np.testing.assert_allclose(got.sp_nz_mean, want.sp_nz_mean, rtol=1e-5)
    np.testing.assert_allclose(got.sp_max, want.sp_max, rtol=1e-6)
    np.testing.assert_array_equal(got.sp_valid, want.sp_valid)


# ---------------------------------------------------------------------------
# device PAO vs host solver
# ---------------------------------------------------------------------------
def test_device_solver_matches_host_pao():
    import jax.numpy as jnp

    from pantax_tpu.ops.profile_tail import DeviceTailSolver
    from pantax_tpu.profile.pao import solve_pao

    rng = np.random.default_rng(3)
    for trial in range(5):
        nodes_len, paths, ti = _random_species(rng, n_haps=3, n_nodes=120)
        n_nodes = len(nodes_len)
        names = sorted(paths)
        # ground-truth mixture with noise
        x_true = rng.gamma(2.0, 3.0, size=len(names))
        A_full = np.zeros((n_nodes, len(names)), dtype=np.float64)
        for j, nm in enumerate(names):
            A_full[np.asarray(paths[nm]), j] = 1.0
        na = A_full @ x_true + rng.normal(0, 0.3, size=n_nodes)
        na = np.clip(na, 0.0, None)
        na[rng.random(n_nodes) < 0.1] = 0.0
        ub = 1.05 * float(na.max())

        tt = _single_species_tt(paths, ti, nodes_len)
        solver = DeviceTailSolver(
            tt, jnp.asarray(na.astype(np.float32)),
            [(0, list(range(len(names))), ub)],
            sp_max=np.array([float(na.max())]),
        )
        x_dev = solver.solve()[0]

        valid = na > 0
        A = A_full[valid]
        b = na[valid]
        x_host = solve_pao(A, b, ub, solver="admm").x
        obj = lambda x: np.abs(A @ x - b).sum() / len(b)
        # both are polished LP vertices; objectives must agree tightly
        assert obj(x_dev) <= obj(x_host) * (1 + 1e-4) + 1e-6
        np.testing.assert_allclose(x_dev, x_host, rtol=2e-3, atol=2e-3)

        # second solve with a pinned path
        pins = np.zeros(len(names), bool)
        pins[0] = True
        ubv = np.full(len(names), ub)
        ubv[0] = 0.0
        x_dev2 = solver.solve(ub_vec_of=lambda ji, p: ubv)[0]
        x_host2 = solve_pao(A, b, ub, solver="admm", fixed_zero=pins).x
        assert obj(x_dev2) <= obj(x_host2) * (1 + 1e-4) + 1e-6
        assert x_dev2[0] == 0.0
        np.testing.assert_allclose(x_dev2, x_host2, rtol=2e-3, atol=2e-3)


def test_device_solver_only_jobs_skips_buckets():
    """solve(only_jobs=...) skips buckets with no listed job (second pass):
    skipped jobs return None, listed jobs match the unrestricted solve."""
    import jax.numpy as jnp

    from pantax_tpu.ops.profile_tail import DeviceTailSolver

    rng = np.random.default_rng(7)
    nodes_len, paths, ti = _random_species(rng, n_haps=6, n_nodes=100)
    names = sorted(paths)
    n_nodes = len(nodes_len)
    A_full = np.zeros((n_nodes, len(names)))
    for j, nm in enumerate(names):
        A_full[np.asarray(paths[nm]), j] = 1.0
    na = np.clip(A_full @ rng.gamma(2.0, 3.0, size=len(names)), 0.0, None)
    ub = 1.05 * float(na.max())
    tt = _single_species_tt(paths, ti, nodes_len)
    # job 0: 3 paths (p_pad 4); job 1: 6 paths (p_pad 8) -> distinct buckets
    jobs = [(0, [0, 1, 2], ub), (0, list(range(6)), ub)]
    solver = DeviceTailSolver(
        tt, jnp.asarray(na.astype(np.float32)), jobs,
        sp_max=np.array([float(na.max())]),
    )
    assert len(solver.buckets) == 2
    full = solver.solve()
    partial = solver.solve(only_jobs={1})
    assert partial[0] is None
    np.testing.assert_allclose(partial[1], full[1], rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# end-to-end: device tail vs host tail on the example database
# ---------------------------------------------------------------------------
def test_fused_device_tail_matches_host_tail(tmp_path):
    import filecmp

    from pantax_tpu.align.aligner import Aligner
    from pantax_tpu.align.encode import encode_seq
    from pantax_tpu.align.index import build_align_index
    from pantax_tpu.db.construct import build_database
    from pantax_tpu.ops.fused import build_fused_tables, profile_fused
    from pantax_tpu.sim import simulate_reads

    db = build_database(EXAMPLE_INFO, tmp_path / "db", base_dir=BASE)
    index = build_align_index(db)
    aligner = Aligner(index)
    reads = simulate_reads(
        db, {"GCF_002012065.1": 4, "GCF_024223415.1": 2,
             "GCF_006400955.1": 2, "MGYG000002538_genomic": 1},
        n_reads=3000, read_len=150, seed=11,
    )
    L = 160
    codes = np.full((len(reads), L), 4, dtype=np.int8)
    lens = np.zeros(len(reads), dtype=np.int64)
    for i, r in enumerate(reads):
        codes[i, : len(r.seq)] = encode_seq(r.seq)
        lens[i] = len(r.seq)
    tables = build_fused_tables(db, index)

    outs = {}
    for tail in ("host", "device"):
        cfg = ProfilingConfig.for_read_type("short", tail=tail)
        out = tmp_path / f"out_{tail}"
        ok = profile_fused(
            aligner, codes, lens, index, db, cfg, out, batch=1024,
            tables=tables,
        )
        assert ok
        outs[tail] = out

    assert filecmp.cmp(
        outs["host"] / "species_abundance.txt",
        outs["device"] / "species_abundance.txt", shallow=False,
    )
    for name in ("strain_abundance.txt", "ori_strain_abundance.txt"):
        a = (outs["host"] / name).read_text().splitlines()
        b = (outs["device"] / name).read_text().splitlines()
        assert len(a) == len(b), name
        assert a[0] == b[0]
        for ra, rb in zip(a[1:], b[1:]):
            ca, cb = ra.split("\t"), rb.split("\t")
            assert ca[:3] == cb[:3], (name, ra, rb)
            np.testing.assert_allclose(
                [float(x) for x in ca[3:]], [float(x) for x in cb[3:]],
                rtol=2e-4, atol=1e-6, err_msg=f"{name}: {ra} vs {rb}",
            )


def test_tail_modes_agree_on_borderline_divergence(tmp_path):
    """Strain SETS are identical between --tail host (float64 filters) and
    --tail device (float32 stats) even when the divergence threshold fc sits
    EXACTLY on a strain's rounded divergence: sweeping fc through each
    strain's round2(|first_sol - trio_mean| / (first_sol + trio_mean)) value
    (and one step below it) flips that strain's keep/rescue/drop decision —
    both tails must flip together (profile.rs:1229-1285 second filter)."""
    from pantax_tpu.align.aligner import Aligner
    from pantax_tpu.align.encode import encode_seq
    from pantax_tpu.align.index import build_align_index
    from pantax_tpu.db.construct import build_database
    from pantax_tpu.ops.fused import (
        FusedPipeline, build_fused_tables, profile_from_fused_result,
    )
    from pantax_tpu.sim import simulate_reads

    db = build_database(EXAMPLE_INFO, tmp_path / "db", base_dir=BASE)
    index = build_align_index(db)
    aligner = Aligner(index)
    # uneven mixture spreads the divergences (measured on this fixture:
    # f = 0.295799 / 0.137416 / 0.062787 -> round2 0.30 / 0.14 / 0.06)
    reads = simulate_reads(
        db, {"GCF_002012065.1": 6, "GCF_024223415.1": 1,
             "GCF_006400955.1": 3, "MGYG000002538_genomic": 2},
        n_reads=3000, read_len=150, seed=5,
    )
    L = 160
    codes = np.full((len(reads), L), 4, dtype=np.int8)
    lens = np.zeros(len(reads), dtype=np.int64)
    for i, r in enumerate(reads):
        codes[i, : len(r.seq)] = encode_seq(r.seq)
        lens[i] = len(r.seq)
    tables = build_fused_tables(db, index)

    def divergences(out):
        f = {}
        for line in (out / "ori_strain_abundance.txt").read_text(
        ).splitlines()[1:]:
            c = line.split("\t")
            if c[7] and c[8]:
                m, s = float(c[7]), float(c[8])
                f[c[2]] = abs(s - m) / (s + m) if s + m else 0.0
        return f

    def strain_set(out):
        return {
            line.split("\t")[2]
            for line in (out / "strain_abundance.txt").read_text(
            ).splitlines()[1:]
        }

    # baseline run to measure the divergences, then the borderline sweep
    base_cfg = ProfilingConfig.for_read_type("short", tail="host")
    pipe = FusedPipeline(aligner, tables, batch=1024)
    pipe.feed(codes, lens)
    base_res = pipe.finish()
    base_out = tmp_path / "base"
    profile_from_fused_result(base_res, tables, index, db, base_cfg, base_out)
    divs = sorted(divergences(base_out).values())
    assert len(divs) >= 3, "fixture must yield >= 3 surviving strains"

    fcs = []
    for f in divs:
        fcs.append(round(np.round(f, 2), 2))          # exactly at boundary
        fcs.append(round(np.round(f, 2) - 0.01, 2))   # one step below
    for fc in sorted(set(fcs)):
        sets = {}
        for tail in ("host", "device"):
            cfg = ProfilingConfig.for_read_type("short", tail=tail)
            cfg.unique_trio_nodes_mean_count_f = fc
            p = FusedPipeline(aligner, tables, batch=1024)
            p.feed(codes, lens)
            res = p.finish()
            out = tmp_path / f"fc{fc}_{tail}"
            profile_from_fused_result(res, tables, index, db, cfg, out)
            sets[tail] = strain_set(out)
        assert sets["host"] == sets["device"], (
            f"strain sets diverge between tail modes at fc={fc}: "
            f"host={sets['host']} device={sets['device']}"
        )


@pytest.mark.parametrize("n,G", [(1, 3), (1000, 17), (4097, 50)])
def test_sorted_segment_sum_matches_scatter(n, G):
    """The fixed-tree segment sum behind the tail stats equals a float64
    scatter-add (to float32 rounding) for unsorted ids, with and without a
    source gather, drops padding ids >= G, leaves empty segments at zero,
    and spans segments longer than one layout row."""
    import jax.numpy as jnp

    from pantax_tpu.ops.profile_tail import _ROW, _segment_sum, segment_layout

    rng = np.random.default_rng(n)
    seg = rng.integers(0, G + 2, size=n).astype(np.int32)
    seg[: min(n, 2 * _ROW + 3)] = 0  # segment 0 takes three rows
    vals = rng.random(n).astype(np.float32)
    want = np.zeros(G)
    np.add.at(want, seg[seg < G], vals[seg < G].astype(np.float64))
    got = np.asarray(_segment_sum(jnp.asarray(vals), segment_layout(seg, G)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got[np.setdiff1d(np.arange(G), seg)] == 0.0).all()
    src = rng.permutation(n)
    got_src = _segment_sum(jnp.asarray(vals[np.argsort(src)]),
                           segment_layout(seg, G, src=src))
    np.testing.assert_array_equal(np.asarray(got_src), got)
