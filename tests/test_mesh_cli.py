"""`--mesh 4` against `--mesh off` through the command line on a small
synthetic community: the four output tables must be byte-identical (the
coverage addends are integer-valued and every tail sum has a fixed order),
which is what `chip_smoke.py --four` checks on four GPUs."""
import numpy as np
import pytest

TABLES = ("species_abundance.txt", "strain_abundance.txt",
          "ori_strain_abundance.txt", "reads_classification.tsv")


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    from pantax_tpu.align.index import build_align_index
    from pantax_tpu.benchmarks import scale_db, simulate_read_batch

    root = tmp_path_factory.mktemp("mesh_cli")
    db = scale_db(str(root / "community"), n_species=3, strains_per=3,
                  genome_len=20_000, seed=7)
    index = build_align_index(db)
    weights = np.array([(1.0, 3.0, 9.0)[h % 3]
                        for h in range(len(index.hap_names))])
    codes, lens, _ = simulate_read_batch(index, 6000, 150, 0.01, seed=11,
                                         hap_weights=weights)
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    fq = root / "reads.fq"
    with open(fq, "wb") as f:
        for i, (row, n) in enumerate(zip(lut[np.clip(codes, 0, 4)], lens)):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, row[:n].tobytes(), b"I" * n))
    return db, fq, root


@pytest.mark.parametrize("tail", ["device", "host"])
def test_cli_mesh4_tables_match_one_device(sample, tail):
    from pantax_tpu import parallel
    from pantax_tpu.cli import main

    db, fq, root = sample
    out = {}
    try:
        for mesh in ("4", "off"):
            run = root / f"{tail}_mesh_{mesh}"
            rc = main(["-d", str(db.root), "-T", str(run), "-n", "--force",
                       "-o", str(run / "out"),
                       "-R", str(run / "reads_classification.tsv"),
                       "-s", "--fastpath", "--species", "--strain",
                       "--tail", tail, "--mesh", mesh, "-r", str(fq)])
            assert rc == 0
            out[mesh] = run
    finally:
        parallel.set_default_mesh(None)
    assert len((out["off"] / "strain_abundance.txt").read_text().splitlines()) > 1
    for name in TABLES:
        assert ((out["4"] / name).read_bytes()
                == (out["off"] / name).read_bytes()), name
