"""The in-row max-plus scans and the chunked engine's carried edges.

The row engines resolve each row's horizontal dependency (U, fit's J)
with a running max over slope-normalized candidates (engine/scan.py
``_u_scan``/``_j_scan``); the chunked engine splits the same rows into
column chunks and carries each row's edge across them. Both are checked
here against a plain sequential recurrence, at widths 4 to 8,192 and
with many chunk boundaries per row.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from aligntools_tpu.engine import chunked as ck
from aligntools_tpu.engine import scan as sc
from aligntools_tpu.params import AlignParams
from aligntools_tpu.spec import engine as spec

WIDTHS = [4, 17, 128, 1000, 8192]


def _row(rng, n):
    """An integer-valued f32 row with some -inf entries."""
    r = rng.integers(-60, 60, n).astype(np.float32)
    r[rng.random(n) < 0.1] = -np.inf
    return r


def _u_seq(m_row, u0, o, e):
    n = len(m_row) - 1
    u = np.empty(n + 1, np.float32)
    bit = np.empty(n, np.uint8)
    u[0] = u0
    for j in range(1, n + 1):
        a, b = m_row[j - 1] + o, u[j - 1] + e
        u[j] = max(a, b)
        bit[j - 1] = 0 if a >= b else sc.PK_U_IS_UPP
    return u, bit


def _j_seq(m_row, allowed, jp):
    n = len(m_row) - 1
    jr = np.empty(n + 1, np.float32)
    bit = np.empty(n, np.uint8)
    jr[0] = -np.inf
    for j in range(1, n + 1):
        a = m_row[j - 1] + jp if allowed[j - 1] else -np.inf
        b = jr[j - 1]
        jr[j] = max(a, b)
        bit[j - 1] = 0 if (a > -np.inf and a >= b) else sc.PK_J_IS_JUMP
    return jr, bit


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("o,e", [(-5, -1), (-1, -2), (3, -1)])
def test_u_scan_matches_sequential(width, o, e):
    rng = np.random.default_rng(width * 7 + o)
    m_row = _row(rng, width + 1)
    u0 = float(rng.integers(-20, 5))
    jidx = jnp.arange(width + 1, dtype=jnp.float32)
    u, bit = sc._u_scan(jnp.asarray(m_row), u0, o, e, jidx)
    want_u, want_bit = _u_seq(m_row, u0, o, e)
    assert np.array_equal(np.asarray(u), want_u)
    assert np.array_equal(np.asarray(bit), want_bit)


@pytest.mark.parametrize("width", WIDTHS)
def test_j_scan_matches_sequential(width):
    rng = np.random.default_rng(width)
    m_row = _row(rng, width + 1)
    allowed = rng.random(width) < 0.8
    jr, bit = sc._j_scan(jnp.asarray(m_row), jnp.asarray(allowed), -10.0)
    want_j, want_bit = _j_seq(m_row, allowed, -10.0)
    assert np.array_equal(np.asarray(jr), want_j)
    assert np.array_equal(np.asarray(bit), want_bit)


def _planes(pairs, n_pad=None):
    m_pad = sc.pad_len(max(len(q) for q, _ in pairs))
    n_pad = n_pad or sc.pad_len(max(len(t) for _, t in pairs))
    B = len(pairs)
    qs = np.full((B, m_pad), -1, np.int32)
    ts = np.full((B, n_pad), -2, np.int32)
    for r, (q, t) in enumerate(pairs):
        qs[r, : len(q)] = np.frombuffer(q, np.uint8)
        ts[r, : len(t)] = np.frombuffer(t, np.uint8)
    return qs, ts


def _ps(p, pairs):
    ps = np.zeros((len(pairs), 6), np.float32)
    ps[:, :5] = [p.match, p.mismatch, p.gap_open, p.gap_extend, p.jump]
    ps[:, 5] = [len(q) for q, _ in pairs]
    return jnp.asarray(ps)


def _pairs(rng, count, m, n):
    alpha = list(b"ACGT")
    return [(bytes(rng.choice(alpha, m).tolist()),
             bytes(rng.choice(alpha, int(rng.integers(n // 2, n + 1)))
                   .tolist())) for _ in range(count)]


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "edit"])
@pytest.mark.parametrize("width", [4, 1000, 8192])
def test_chunked_edges_long_rows(mode, width):
    """Short queries against targets up to 8,192 columns in 128-column
    chunks (up to 64 carried edges per row) vs the spec oracle."""
    rng = np.random.default_rng(width + len(mode))
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    if mode == "edit":
        p = AlignParams(mismatch=1)
    pairs = _pairs(rng, 3, 9, width)
    qs, ts = _planes(pairs)
    ns = np.asarray([len(t) for _, t in pairs], np.int32)
    got = np.asarray(ck.chunked_scores(
        mode, jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(ns), 128,
        params=_ps(p, pairs)))
    fn = getattr(spec, f"spec_{mode}")
    want = [fn(q, t, p) for q, t in pairs]
    want = [w if mode == "edit" else w.score for w in want]
    assert np.array_equal(got.astype(np.float64), want), (mode, width)


@pytest.mark.parametrize("use_jump", [False, True])
@pytest.mark.parametrize("width", [1000, 8192])
def test_chunked_fit_edges_long_rows(use_jump, width):
    """Fit (+ junction jumps) across many chunks vs the spec oracle."""
    rng = np.random.default_rng(width + use_jump)
    p = AlignParams(match=2, mismatch=-2)
    pairs = _pairs(rng, 3, 12, width)
    sites = [sorted(int(x) for x in rng.integers(0, len(t), 6))
             for _, t in pairs]
    qs, ts = _planes(pairs)
    allow = np.ones(ts.shape, bool)
    if use_jump:
        for r, s in enumerate(sites):
            allow[r, s] = False
    ns = np.asarray([len(t) for _, t in pairs], np.int32)
    got = np.asarray(ck.chunked_fit_scores(
        use_jump, jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(allow),
        jnp.asarray(ns), 128, params=_ps(p, pairs)))
    want = [spec.spec_fit(q, t, p, s if use_jump else None).score
            for (q, t), s in zip(pairs, sites)]
    assert np.array_equal(got.astype(np.float64), want)
