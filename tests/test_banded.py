"""Banded engine: exact vs the full engine when the band contains the
optimal path; band-doubling auto mode converges to the exact score."""

import numpy as np
import pytest

from aligntools_tpu.batch import batch_scores
from aligntools_tpu.engine.banded import banded_score, banded_score_auto
from aligntools_tpu.params import AlignParams

ALPHA = list(b"ACGT")


def _similar_pair(rng, n, mutations, indels):
    """A pair differing by point mutations and small indels — the banded
    use case (optimal path near the main diagonal)."""
    q = rng.choice(ALPHA, n).astype(np.uint8)
    t = list(q.tolist())
    for _ in range(mutations):
        t[int(rng.integers(0, len(t)))] = int(rng.choice(ALPHA))
    for _ in range(indels):
        pos = int(rng.integers(0, len(t)))
        if rng.random() < 0.5 and len(t) > 2:
            del t[pos]
        else:
            t.insert(pos, int(rng.choice(ALPHA)))
    return bytes(q.tolist()), bytes(t)


@pytest.mark.parametrize("mode", ["global", "local"])
def test_full_band_equals_unbanded(mode):
    """Band >= max(m, n) covers the whole matrix: must equal exactly."""
    rng = np.random.default_rng(101)
    for pd in (dict(), dict(match=2, mismatch=-3, gap_open=-1,
                           gap_extend=-2)):  # includes o > e
        p = AlignParams(**pd)
        for _ in range(8):
            q = bytes(rng.choice(ALPHA, int(rng.integers(2, 60))).tolist())
            t = bytes(rng.choice(ALPHA, int(rng.integers(2, 60))).tolist())
            band = max(len(q), len(t))
            score, _ = banded_score(mode, q, t, band, p)
            want = batch_scores(mode, [(q, t)], p)[0]
            assert score == want, (mode, pd, q, t)


@pytest.mark.parametrize("mode", ["global", "local"])
def test_similar_pairs_small_band(mode):
    """Realistic banded use: similar pairs, band 48 — exact, verified by
    the auto doubling protocol AND against the full engine."""
    rng = np.random.default_rng(103)
    p = AlignParams(match=2, mismatch=-2, gap_open=-4, gap_extend=-1)
    for _ in range(6):
        q, t = _similar_pair(rng, 300, mutations=12, indels=4)
        want = batch_scores(mode, [(q, t)], p)[0]
        score, band, cert = banded_score_auto(mode, q, t, p, band0=48)
        assert score == want, (mode, len(q), len(t), band)
        if mode == "global":
            # the crossing certificate discharges central global pairs at
            # a band far below the matrix size
            assert cert and band < 300, band


def test_band_too_small_raises():
    with pytest.raises(ValueError):
        banded_score("global", b"ACGT", b"A" * 200, 16)


def test_banded_batch():
    from aligntools_tpu.engine.banded import banded_batch_scores

    rng = np.random.default_rng(107)
    pairs = [_similar_pair(rng, 200, 8, 3) for _ in range(6)]
    p = AlignParams(match=2, mismatch=-2, gap_open=-4, gap_extend=-1)
    scores, _ = banded_batch_scores("local", pairs, 64, p)
    want = batch_scores("local", pairs, p)
    assert np.array_equal(scores, want)


@pytest.mark.parametrize("mode", ["global", "local", "edit", "fit",
                                  "overlap"])
def test_banded_scores_match_spec(mode):
    """The vmapped XLA banded fill vs the spec oracle, per mode: with a
    band covering the whole matrix the scores are exact (mixed lengths,
    two parameter sets); a narrow band never beats the exact score."""
    from aligntools_tpu.engine.banded import banded_batch_scores
    from aligntools_tpu.spec import engine as spec

    rng = np.random.default_rng(211)
    for pd, band in (
        (dict(match=2, mismatch=-2, gap_open=-4, gap_extend=-1), 32),
        (dict(match=2, mismatch=-3, gap_open=-1, gap_extend=-2), 17),
    ):  # second set has o > e (exercises the local open-at-border fold)
        p = AlignParams(**pd)
        pairs = []
        for k in range(11):
            q, t = _similar_pair(rng, int(rng.integers(20, 150)),
                                 mutations=6, indels=3)
            if mode in ("global", "edit") and abs(len(t) - len(q)) > band:
                q, t = q[: len(t)], t  # keep end cell in band
            if mode == "fit" and len(q) > len(t):
                q, t = t, q
            pairs.append((q, t))
        fn = getattr(spec, f"spec_{mode}")
        want = [fn(q, t, p) for q, t in pairs]
        want = np.asarray([w if mode == "edit" else w.score for w in want])
        full = max(max(len(q), len(t)) for q, t in pairs)
        got = banded_batch_scores(mode, pairs, full, p)[0]
        assert np.array_equal(got, want), (mode, pd)
        narrow = banded_batch_scores(mode, pairs, band, p)[0]
        if mode == "edit":
            assert np.all(narrow >= want), (mode, pd)
        else:
            assert np.all(narrow <= want), (mode, pd)


def test_banded_edit():
    """Ukkonen-banded edit distance: full band == spec; small band on
    similar pairs converges to the exact distance (u=1: provable regime)."""
    from aligntools_tpu.spec.engine import spec_edit

    rng = np.random.default_rng(109)
    p = AlignParams(mismatch=1)
    for _ in range(6):
        q, t = _similar_pair(rng, 250, mutations=10, indels=5)
        want = spec_edit(q, t, p)
        full, _ = banded_score("edit", q, t, max(len(q), len(t)), p)
        assert int(full) == want
        score, band, cert = banded_score_auto("edit", q, t, p, band0=32)
        assert int(score) == want and band < len(q)
        assert cert  # u=1 >= 0: the min-plus crossing bound certifies


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_banded_rows_full_band(mode):
    """Band covering the whole matrix: rows byte-identical to the spec
    (all four traceback modes; edit has none)."""
    from aligntools_tpu.engine.banded import banded_align
    from aligntools_tpu.spec import engine as sp

    rng = np.random.default_rng(113)
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    for _ in range(12):
        q = bytes(rng.choice(ALPHA, int(rng.integers(2, 50))).tolist())
        t = bytes(rng.choice(ALPHA, int(rng.integers(2, 50))).tolist())
        if mode == "fit" and len(q) > len(t):
            q, t = t, q
        r, _ = banded_align(mode, q, t, max(len(q), len(t)), p)
        w = getattr(sp, f"spec_{mode}")(q, t, p)
        assert (r.score, r.row1, r.row2) == (w.score, w.row1, w.row2), (
            mode, q, t,
        )


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_banded_rows_small_band(mode):
    """Similar pairs, band 48: score exact vs the full engine and the rows
    reconstruct the inputs (valid in-band optimal alignment)."""
    from aligntools_tpu.engine.banded import banded_align
    from aligntools_tpu.spec import engine as sp

    rng = np.random.default_rng(115)
    p = AlignParams(match=2, mismatch=-2, gap_open=-4, gap_extend=-1)
    for _ in range(5):
        q, t = _similar_pair(rng, 300, 10, 4)
        if mode == "fit" and len(q) > len(t):
            q, t = t, q
        r, _ = banded_align(mode, q, t, 48, p)
        w = getattr(sp, f"spec_{mode}")(q, t, p)
        assert r.score == w.score
        u1 = r.row1.replace(b"-", b"")
        u2 = r.row2.replace(b"-", b"")
        if mode == "global":
            assert u1 == q and u2 == t
        elif mode == "fit":
            assert u1 == q and u2 in t  # whole query fits into the target
        elif mode == "overlap":
            # walk stops at column 0: emitted target is a prefix of t
            assert u1 in q and u2 == t[: len(u2)]
        else:
            assert u1 in q and u2 in t
        assert len(r.row1) == len(r.row2)


def test_banded_overlap_empty_alignment():
    """The reference's j_max=0 case (bottom-row argmax <= 0): overlap
    yields score 0 and two EMPTY rows (SURVEY micro: ACGT/AGT -> 0.000000
    + empty rows with default params; alignment.h:950-959)."""
    from aligntools_tpu.engine.banded import banded_align
    from aligntools_tpu.spec.engine import spec_overlap

    q, t = b"ACGT", b"AGT"
    r, _ = banded_align("overlap", q, t, 8)
    w = spec_overlap(q, t)
    assert (r.score, r.row1, r.row2) == (w.score, w.row1, w.row2)
    assert r.row1 == b"" and r.row2 == b""


@pytest.mark.parametrize("mode", ["fit", "overlap"])
def test_banded_fit_overlap_full_band(mode):
    """Full-cover band equals the spec oracle for the bottom-row-start
    modes (fit sans jump: alignment.h:596-694; overlap: 926-964)."""
    from aligntools_tpu.spec import engine as sp

    rng = np.random.default_rng(117)
    for pd in (dict(), dict(match=2, mismatch=-3, gap_open=-1,
                            gap_extend=-2)):
        p = AlignParams(**pd)
        for _ in range(8):
            m = int(rng.integers(2, 50))
            n = int(rng.integers(m, 70))
            q = bytes(rng.choice(ALPHA, m).tolist())
            t = bytes(rng.choice(ALPHA, n).tolist())
            score, _ = banded_score(mode, q, t, max(m, n), p)
            want = getattr(sp, f"spec_{mode}")(q, t, p).score
            assert score == want, (mode, pd, q, t)


@pytest.mark.parametrize("mode", ["fit", "overlap"])
def test_banded_fit_overlap_auto_certified(mode):
    """certified=True from the auto protocol implies the exact score."""
    from aligntools_tpu.spec import engine as sp

    rng = np.random.default_rng(119)
    p = AlignParams(match=2, mismatch=-2, gap_open=-4, gap_extend=-1)
    for _ in range(10):
        m = int(rng.integers(4, 40))
        n = int(rng.integers(m, 80))
        t = rng.choice(ALPHA, n)
        q = t[:m].copy()  # prefix-anchored: in-band for fit and overlap
        mut = rng.random(m) < 0.08
        q[mut] = rng.choice(ALPHA, int(mut.sum()))
        q, t = bytes(q.tolist()), bytes(t.tolist())
        sc, band, cert = banded_score_auto(mode, q, t, p, band0=16)
        want = getattr(sp, f"spec_{mode}")(q, t, p).score
        if cert:
            assert sc == want, (mode, q, t, band)


def test_adversarial_plateau_band_doubling():
    """The score-plateau stopping rule is provably unsafe: q's perfect
    copy sits 64 columns off the diagonal, so bands 8 and 16 agree on a
    wrong local score (both all-mismatch windows -> 0). The certificate
    refuses to certify the plateau, and the certificate-driven auto
    protocol keeps doubling to the exact score."""
    from aligntools_tpu.engine.banded import band_certificate

    p = AlignParams(match=10, mismatch=-1, gap_open=-20, gap_extend=-5)
    q = b"C" * 16
    t = b"A" * 64 + b"C" * 16
    full = batch_scores("local", [(q, t)], p)[0]
    s8, _ = banded_score("local", q, t, 8, p)
    s16, _ = banded_score("local", q, t, 16, p)
    assert s8 == s16 != full  # the plateau lies
    assert s16 < band_certificate("local", len(q), len(t), 16, p)
    score, band, cert = banded_score_auto("local", q, t, p, band0=8)
    assert cert and score == full, (score, band)


def test_banded_fit_rejects_jump_and_long_query():
    with pytest.raises(ValueError):
        banded_score("fit", b"ACGTACGT", b"ACG", 8)


def test_banded_batch_end_cell_check_edit():
    """ADVICE r1: edit needs the same |n-m| <= band end-cell validation as
    global (banded_score already raises for both)."""
    from aligntools_tpu.engine.banded import banded_batch_scores

    pairs = [(b"ACGT", b"ACGTACGTACGTACGTACGTACGTACGTACGT")]
    with pytest.raises(ValueError):
        banded_batch_scores("edit", pairs, 4, AlignParams())
    with pytest.raises(ValueError):
        banded_batch_scores("global", pairs, 4, AlignParams())


def test_banded_fit_l_start():
    """Fit whose optimal alignment ends in a query-consuming gap: the
    bottom-row scan must pick the L matrix (use_l) and start the walk in
    LOW — rarely hit by random pairs (alignment.h:681-688)."""
    from aligntools_tpu.engine.banded import banded_align
    from aligntools_tpu.spec.engine import spec_fit

    p = AlignParams(match=2, mismatch=-10, gap_open=-1, gap_extend=-1)
    q = b"ACGTACGTXX"  # trailing XX absent from t -> cheaper as a gap
    t = b"TTTTACGTACGTTTTT"
    w = spec_fit(q, t, p)
    assert w.row2.endswith(b"--")  # the case under test
    r, _ = banded_align("fit", q, t, max(len(q), len(t)), p)
    assert (r.score, r.row1, r.row2) == (w.score, w.row1, w.row2)


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_banded_rows_match_spec(mode):
    """Pointer-emitting XLA banded fill + window walk, with a band that
    covers the whole matrix: scores AND rows identical to the spec
    oracle on a tie-heavy mix."""
    from aligntools_tpu.engine.banded import banded_align_batch
    from aligntools_tpu.spec import engine as spec

    rng = np.random.default_rng(311)
    p = AlignParams(match=2, mismatch=-2, gap_open=-4, gap_extend=-1)
    pairs = []
    for k in range(9):
        alpha = [65, 66] if k % 3 else ALPHA  # tie-heavy binary mixed in
        q = bytes(rng.choice(alpha, int(rng.integers(3, 90))).tolist())
        t = bytes(rng.choice(alpha, int(rng.integers(3, 110))).tolist())
        if mode == "global":
            q, t = q, q[: max(1, len(q) - 5)]  # keep end cell in band
        if mode == "fit" and len(q) > len(t):
            q, t = t, q
        pairs.append((q, t))
    band = max(max(len(q), len(t)) for q, t in pairs)
    fn = getattr(spec, f"spec_{mode}")
    want = [fn(q, t, p) for q, t in pairs]
    got, _ = banded_align_batch(mode, pairs, band, p)
    for k, (w, g) in enumerate(zip(want, got)):
        assert (g.score, g.row1, g.row2) == (w.score, w.row1, w.row2), (
            mode, k, pairs[k],
        )
