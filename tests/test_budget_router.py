"""HBM budget router for full alignments (batch.py rows path).

The pointer tensor is the only O(B*m*n) allocation; the router must make
ANY full-alignment request survive a finite pointer budget — packed
chunked emission first, then batch slicing, then the per-pair
checkpoint-rescan fallback (engine/rescan.py) — with rows byte-identical
to the unconstrained run (and therefore to the reference binary the
engines are parity-tested against: traceback routines
src/alignment.h:372-412, 558-592, 766-800, 896-922).
"""

import numpy as np
import pytest

from aligntools_tpu import batch as ab
from aligntools_tpu.params import AlignParams


def _pairs(rng, n_pairs, m_hi, n_hi):
    alpha = list(b"ACGT")
    return [
        (
            bytes(rng.choice(alpha, int(rng.integers(1, m_hi))).tolist()),
            bytes(rng.choice(alpha, int(rng.integers(1, n_hi))).tolist()),
        )
        for _ in range(n_pairs)
    ]


def _assert_same(want, got):
    for w, g in zip(want, got):
        assert (w.score, w.row1, w.row2) == (g.score, g.row1, g.row2)


@pytest.mark.parametrize("mode", ["global", "local", "overlap"])
def test_budget_slices_bucket(monkeypatch, mode):
    """A budget that fits only a few pairs per fill slices the bucket;
    rows must be byte-identical to the unconstrained run."""
    rng = np.random.default_rng(101)
    pairs = _pairs(rng, 14, 60, 300)
    p = AlignParams()
    want = ab.align_batch(mode, pairs, p, traceback=True)
    # ~3 pairs per fill at m_pad=64, n_pad<=512 unpacked (x2.5 factor)
    monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", str(64 * 513 * 3 * 6))
    got = ab.align_batch(mode, pairs, p, traceback=True)
    _assert_same(want, got)


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "fit"])
def test_budget_rescan_fallback(monkeypatch, mode):
    """A budget too small for even ONE pair's pointer tensor routes every
    pair through checkpoint-rescan; rows still byte-identical."""
    rng = np.random.default_rng(102)
    pairs = _pairs(rng, 5, 50, 260)
    if mode == "fit":  # fit requires m <= n
        pairs = [(q[: len(t)], t) for q, t in pairs]
    p = AlignParams(match=2, mismatch=-2) if mode == "fit" else AlignParams()
    sites = None
    if mode == "fit":
        sites = [
            sorted(int(x) for x in rng.integers(0, max(1, len(t)), 3))
            for _, t in pairs
        ]
    want = ab.align_batch(mode, pairs, p, sites_list=sites, traceback=True)
    monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", "10000")
    got = ab.align_batch(mode, pairs, p, sites_list=sites, traceback=True)
    _assert_same(want, got)


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "fit"])
def test_packed_chunked_survives_unpacked_oom_shape(monkeypatch, mode):
    """The round-4 contract: at a budget the UNPACKED pointer tensor
    exceeds, the packed chunked fill + raw-block device walk still
    returns byte-correct rows without slicing down to single pairs."""
    from aligntools_tpu.engine import select as sel

    rng = np.random.default_rng(103)
    B = 8
    # fixed lengths -> exactly one bucket key: (m_pad, n_pad) = (120, 1024)
    alpha = list(b"ACGT")
    pairs = [
        (bytes(rng.choice(alpha, 120).tolist()),
         bytes(rng.choice(alpha, 900).tolist()))
        for _ in range(B)
    ]
    m_pad, n_pad = ab._bucket_keys(pairs, 64, 128)[0]
    p = AlignParams(match=2, mismatch=-2) if mode == "fit" else AlignParams()
    want = ab.align_batch(mode, pairs, p, traceback=True)

    monkeypatch.setattr(sel, "use_chunked", lambda b, n: True)
    # budget: the whole batch fits packed (nibble/2-bit) but NOT unpacked
    rpb = 4 if mode == "overlap" else 2
    packed = B * m_pad * (n_pad + 1) // rpb
    unpacked = B * m_pad * (n_pad + 1)
    budget = int((packed + unpacked) / 2 / ab.PTR_BUDGET_FRAC)
    monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", str(budget))
    got = ab.align_batch(mode, pairs, p, traceback=True)
    _assert_same(want, got)
    # the packed estimate must fit the budget in ONE fill (no slicing),
    # while the unpacked tensor would have blown it
    bucket = ab._bucketize(pairs, None)[(m_pad, n_pad)]
    est = ab._rows_ptr_bytes_pp(mode, bucket, False, "auto",
                                len(bucket.idx))
    assert est * B <= budget * ab.PTR_BUDGET_FRAC
    assert unpacked > budget * ab.PTR_BUDGET_FRAC


def test_fit_jump_budget_router(monkeypatch):
    """fit -s (jump state, byte layout) under a slicing budget."""
    rng = np.random.default_rng(104)
    pairs, sites = [], []
    for _ in range(6):
        m = int(rng.integers(1, 40))
        n = int(rng.integers(40, 300))
        pairs.append(
            (bytes(rng.choice(list(b"ACGT"), m).tolist()),
             bytes(rng.choice(list(b"ACGT"), n).tolist()))
        )
        sites.append(sorted(int(x) for x in rng.integers(0, n, 3)))
    p = AlignParams(match=2, mismatch=-2)
    want = ab.align_batch("fit", pairs, p, sites_list=sites, traceback=True)
    monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", str(64 * 513 * 2 * 6))
    got = ab.align_batch("fit", pairs, p, sites_list=sites, traceback=True)
    _assert_same(want, got)


def test_auto_stride_grows_for_huge_shapes():
    s = ab._auto_stride(2_000_000, 1_000_000, 16 << 30)
    # checkpoints (m/S * 16 * n) must fit 40% of budget
    assert (2_000_000 / s) * 16 * 1_000_001 <= 0.4 * (16 << 30)
    assert s % 8 == 0
