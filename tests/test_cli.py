"""CLI end-to-end on the example data (CPU backend, small read subsets)."""
import gzip
import itertools
import os

import pytest

from pantax_tpu.cli import main
from pantax_tpu.io.fastx import iter_fastx

EXAMPLE_INFO = "/root/reference/example/example_genomes_info.txt"
BASE = "/root/reference/example/ngs"
NGS = "/root/reference/example/ngs/short_reads.fq.gz"
HIFI = "/root/reference/example/hifi/long_reads.fq.gz"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("cli")
    os.chdir(wd)
    rc = main(["-f", EXAMPLE_INFO, "-d", "db", "--create", "--base-dir", BASE])
    assert rc == 0
    return wd


def _subset_fastq(path, out, n):
    with open(out, "wb") as f:
        for name, seq in itertools.islice(iter_fastx(path), n):
            f.write(b"@" + name.encode() + b"\n" + seq + b"\n+\n" + b"I" * len(seq) + b"\n")


def test_cli_short_reads(workdir):
    _subset_fastq(NGS, "sub.fq", 3000)
    rc = main(["-d", "db", "-s", "-r", "sub.fq", "--species", "--strain",
               "-o", "t1", "-R", "t1_cls.tsv", "-T", "tmp1"])
    assert rc == 0
    assert os.path.exists("t1_species_abundance.txt")
    assert os.path.exists("t1_strains_abundance.txt")
    assert os.path.exists("t1_cls.tsv")
    assert not os.path.exists("tmp1")  # tmp removed without --next/--debug
    body = open("t1_species_abundance.txt").read()
    assert "562" in body and "34" in body


def test_cli_long_reads(workdir):
    _subset_fastq(HIFI, "subl.fq", 60)
    rc = main(["-d", "db", "-l", "-r", "subl.fq", "--species", "--strain",
               "-o", "t2", "-T", "tmp2", "--batch-size", "512"])
    assert rc == 0
    body = open("t2_species_abundance.txt").read()
    assert "562" in body and "34" in body


def test_cli_resume_with_next(workdir):
    _subset_fastq(NGS, "sub3.fq", 1000)
    rc = main(["-d", "db", "-s", "-r", "sub3.fq", "--species", "-n", "-T", "tmp3"])
    assert rc == 0
    assert os.path.exists("tmp3/gfa_mapped.gaf")
    # second stage reuses the alignment + species profile
    rc = main(["-d", "db", "-s", "-r", "sub3.fq", "--strain", "-T", "tmp3"])
    assert rc == 0
    assert os.path.exists("strain_abundance.txt")


def test_cli_error_cases(workdir):
    assert main(["-d", "db", "-s"]) == 2          # no reads
    assert main(["-d", "db", "-r", "x.fq"]) == 2  # no read type


def test_cli_fastpath_matches_default(workdir):
    if not os.path.exists("t1_species_abundance.txt"):
        # self-contained under -k selection: produce the default-path output
        # this test compares against (same command as test_cli_short_reads)
        _subset_fastq(NGS, "sub.fq", 3000)
        assert main(["-d", "db", "-s", "-r", "sub.fq", "--species",
                     "--strain", "-o", "t1", "-R", "t1_cls.tsv",
                     "-T", "tmp1"]) == 0
    _subset_fastq(NGS, "subf.fq", 3000)
    rc = main(["-d", "db", "-s", "-r", "subf.fq", "--species", "--strain",
               "-o", "fp", "-T", "tmpfp", "--fastpath", "--batch-size", "1024"])
    assert rc == 0
    import pandas as pd
    a = pd.read_csv("t1_species_abundance.txt", sep="\t",
                    dtype={"species_taxid": str})
    b = pd.read_csv("fp_species_abundance.txt", sep="\t",
                    dtype={"species_taxid": str})
    # same reads as test_cli_short_reads -> same species profile
    merged = a.merge(b, on="species_taxid", suffixes=("_a", "_b"))
    import numpy as np
    np.testing.assert_allclose(merged["predicted_coverage_a"],
                               merged["predicted_coverage_b"], rtol=1e-9)
    assert len(pd.read_csv("fp_strains_abundance.txt", sep="\t")) >= 3


def test_cli_paired_modes(workdir):
    """-p with R1/R2 files and with one interleaved file: the example reads
    are interleaved pairs (S0R0 appears twice: /1 then /2)."""
    reads = list(itertools.islice(iter_fastx(NGS), 1200))
    with open("pe_R1.fq", "wb") as f1, open("pe_R2.fq", "wb") as f2:
        for i in range(0, len(reads), 2):
            for f, (name, seq) in ((f1, reads[i]), (f2, reads[i + 1])):
                f.write(b"@" + name.encode() + b"\n" + seq + b"\n+\n"
                        + b"I" * len(seq) + b"\n")
    _subset_fastq(NGS, "pe_inter.fq", 1200)

    rc = main(["-d", "db", "-s", "-p", "-r", "pe_R1.fq", "pe_R2.fq",
               "--species", "-o", "pe2", "-T", "tmpp2", "--batch-size", "512"])
    assert rc == 0
    rc = main(["-d", "db", "-s", "-p", "-r", "pe_inter.fq",
               "--species", "-o", "pe1", "-T", "tmpp1", "--batch-size", "512"])
    assert rc == 0
    a = open("pe2_species_abundance.txt").read()
    b = open("pe1_species_abundance.txt").read()
    assert a == b, "two-file and interleaved paired modes must agree"
    assert "562" in a


def test_cli_fastpath_paired_interleaved_matches_two_file(workdir):
    """--fastpath -p with ONE interleaved file de-interleaves adjacent
    records and runs the SAME joint fragment-model fused step as two-file
    mode (reference ShortReadPairedInter, types.rs:34-48) — species/strain/
    classification tables byte-identical, no independent-mate fallback."""
    import filecmp

    reads = list(itertools.islice(iter_fastx(NGS), 1200))
    with open("fpp_R1.fq", "wb") as f1, open("fpp_R2.fq", "wb") as f2:
        for i in range(0, len(reads), 2):
            for f, (name, seq) in ((f1, reads[i]), (f2, reads[i + 1])):
                f.write(b"@" + name.encode() + b"\n" + seq + b"\n+\n"
                        + b"I" * len(seq) + b"\n")
    _subset_fastq(NGS, "fpp_inter.fq", 1200)

    rc = main(["-d", "db", "-s", "-p", "-r", "fpp_R1.fq", "fpp_R2.fq",
               "--species", "--strain", "--fastpath", "-o", "fpp2",
               "-R", "fpp2_cls.tsv", "-T", "tmpfpp2", "--batch-size", "512"])
    assert rc == 0
    rc = main(["-d", "db", "-s", "-p", "-r", "fpp_inter.fq",
               "--species", "--strain", "--fastpath", "-o", "fpp1",
               "-R", "fpp1_cls.tsv", "-T", "tmpfpp1", "--batch-size", "512"])
    assert rc == 0
    for a, b in (("fpp2_species_abundance.txt", "fpp1_species_abundance.txt"),
                 ("fpp2_strains_abundance.txt", "fpp1_strains_abundance.txt"),
                 ("fpp2_cls.tsv", "fpp1_cls.tsv")):
        assert filecmp.cmp(a, b, shallow=False), (a, b)
    assert "562" in open("fpp1_species_abundance.txt").read()


def test_sketch_cli_prebuilds_fast_cache(workdir):
    """pantax-tpu-sketch pre-builds the --syldb sketch cache (the reference's
    standalone sketch binary role, sketch.rs:1-6)."""
    from pantax_tpu.db.sketch_cli import main as sketch_main

    rc = sketch_main(["-f", EXAMPLE_INFO, "-o", "sketches", "--base-dir", BASE])
    assert rc == 0
    import glob

    files = glob.glob("sketches/*.sketch.npz")
    assert len(files) == 4
    # the CLI's --fast path consumes the same cache layout
    _subset_fastq(NGS, "subfast.fq", 500)
    rc = main(["-f", EXAMPLE_INFO, "-d", "dbfast", "--create", "--fast",
               "-s", "-r", "subfast.fq", "--syldb", "sketches",
               "--base-dir", BASE])
    assert rc == 0
    # --fast builds the screened DB under <db>_fast (construct.rs semantics)
    assert os.path.exists("dbfast_fast/species_range.txt")


def test_qt_screen_only(workdir):
    """--qt runs the --fast genome screen, writes the filtered genomes_info,
    and exits without building a DB (main.rs:208-210 fast_query_and_filter)."""
    _subset_fastq(NGS, "subqt.fq", 400)
    rc = main(["-f", EXAMPLE_INFO, "-d", "dbqt", "--create", "--fast", "--qt",
               "-s", "-r", "subqt.fq", "--syldb", "sketches",
               "--base-dir", BASE])
    assert rc == 0
    assert os.path.exists("dbqt_fast/genomes_info_fast_input.txt")
    assert not os.path.exists("dbqt_fast/species_range.txt")


def test_index_warm_kernels(workdir):
    """--index --warm-kernels pre-compiles the query + fused graphs (the
    executable is part of the index; giraffe index role)."""
    rc = main(["-d", "db", "--index", "--warm-kernels", "--batch-size", "256"])
    assert rc == 0


def test_index_warm_kernels_long(workdir):
    """--index --warm-kernels -l pre-compiles the long-read chunk graphs."""
    rc = main(["-d", "db", "--index", "--warm-kernels", "-l",
               "--long-read-type", "hifi", "--batch-size", "128"])
    assert rc == 0


def test_cli_fastpath_long_matches_default(workdir):
    """--fastpath -l (array-native long-read flow) reproduces the GAF
    pipeline's species profile on the example HiFi reads."""
    if not os.path.exists("t2_species_abundance.txt"):
        _subset_fastq(HIFI, "subl.fq", 60)
        assert main(["-d", "db", "-l", "-r", "subl.fq", "--species",
                     "--strain", "-o", "t2", "-T", "tmp2",
                     "--batch-size", "512"]) == 0
    _subset_fastq(HIFI, "subl2.fq", 60)
    rc = main(["-d", "db", "-l", "-r", "subl2.fq", "--species", "--strain",
               "-o", "lfp", "-T", "tmplfp", "--fastpath",
               "--batch-size", "512"])
    assert rc == 0
    import numpy as np
    import pandas as pd
    a = pd.read_csv("t2_species_abundance.txt", sep="\t",
                    dtype={"species_taxid": str})
    b = pd.read_csv("lfp_species_abundance.txt", sep="\t",
                    dtype={"species_taxid": str})
    merged = a.merge(b, on="species_taxid", suffixes=("_a", "_b"))
    assert len(merged) == len(a)
    np.testing.assert_allclose(merged["predicted_coverage_a"],
                               merged["predicted_coverage_b"], rtol=1e-9)
    assert os.path.exists("lfp_strains_abundance.txt")
