"""Chunked XLA score engine (engine/chunked.py) vs the row-scan engine.

The chunked engine re-tiles the same recurrences (reference semantics:
src/alignment.h:417-473, 805-847, 596-694, 926-964, 291-315) into
column chunks with carried row edges; scores must be BIT-identical to
the scan engine across chunk widths, ragged true lengths, and chunk
boundaries falling before/on/after each pair's n.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from aligntools_tpu.engine import chunked as ck
from aligntools_tpu.engine import scan as sc
from aligntools_tpu.params import AlignParams


def _batch(rng, B, m_max, n_max, alphabet=b"ACGT"):
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    ms = rng.integers(0, m_max + 1, B)
    ns = rng.integers(1, n_max + 1, B)
    m_pad = sc.pad_len(m_max)
    n_pad = sc.pad_len(n_max)
    qs = np.full((B, m_pad), -1, np.int32)
    ts = np.full((B, n_pad), -2, np.int32)
    for r in range(B):
        qs[r, : ms[r]] = rng.choice(alpha, ms[r])
        ts[r, : ns[r]] = rng.choice(alpha, ns[r])
    return qs, ts, ms, ns, m_pad, n_pad


def _params_mat(p, ms):
    ps = np.zeros((len(ms), 6), np.float32)
    ps[:, :5] = [p.match, p.mismatch, p.gap_open, p.gap_extend, p.jump]
    ps[:, 5] = ms
    return jnp.asarray(ps)


def _scan_scores(mode, qs, ts, ns, ps, n_pad):
    import jax

    if mode == "global":
        f = lambda q, t, n, p: sc.global_fill(q, t, n, p, n_pad, False)[0]
    elif mode == "local":
        f = lambda q, t, n, p: sc.local_fill(q, t, n, p, n_pad, False)[0]
    elif mode == "overlap":
        f = lambda q, t, n, p: sc.overlap_fill(q, t, n, p, n_pad, False)[0]
    elif mode == "edit":
        f = lambda q, t, n, p: sc.edit_fill(q, t, n, p, n_pad)
    return np.asarray(
        jax.vmap(f)(jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(ns), ps)
    )


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "edit"])
@pytest.mark.parametrize("n_chunk", [128, 256, 512])
def test_chunked_matches_scan(mode, n_chunk):
    rng = np.random.default_rng(hash((mode, n_chunk)) % 2**31)
    p = AlignParams()
    qs, ts, ms, ns, m_pad, n_pad = _batch(rng, 16, 90, 700)
    ps = _params_mat(p, ms)
    want = _scan_scores(mode, qs, ts, ns, ps, n_pad)
    got = np.asarray(
        ck.chunked_scores(
            mode, jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(ns),
            n_chunk, params=ps,
        )
    )
    # edit's +-inf never appears (n >= 1 so (m,n) is always finite); the
    # other modes may hold -inf for degenerate pairs — compare bitwise.
    assert np.array_equal(want, got, equal_nan=True), (
        f"{mode} n_chunk={n_chunk}: {want} != {got}"
    )


@pytest.mark.parametrize("use_jump", [False, True])
@pytest.mark.parametrize("n_chunk", [128, 384])
def test_chunked_fit_matches_scan(use_jump, n_chunk):
    import jax

    rng = np.random.default_rng(7 + n_chunk + use_jump)
    p = AlignParams(match=2, mismatch=-2)
    B, n_max = 12, 900
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    m_pad, n_pad = sc.pad_len(60), sc.pad_len(n_max)
    qs = np.full((B, m_pad), -1, np.int32)
    ts = np.full((B, n_pad), -2, np.int32)
    allow = np.ones((B, n_pad), bool)
    ms = rng.integers(0, 61, B)
    ns = rng.integers(61, n_max + 1, B)  # fit requires m <= n
    for r in range(B):
        qs[r, : ms[r]] = rng.choice(alpha, ms[r])
        ts[r, : ns[r]] = rng.choice(alpha, ns[r])
        if use_jump:
            sites = rng.integers(0, ns[r], 5)
            allow[r, sites] = False
    ps = _params_mat(p, ms)

    def f(q, t, n, pp, al):
        return sc.fit_fill(q, t, n, pp, al, n_pad, use_jump, False)[0]

    want = np.asarray(
        jax.vmap(f)(
            jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(ns), ps,
            jnp.asarray(allow),
        )
    )
    got = np.asarray(
        ck.chunked_fit_scores(
            use_jump, jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(allow),
            jnp.asarray(ns), n_chunk, params=ps,
        )
    )
    assert np.array_equal(want, got, equal_nan=True), f"{want} != {got}"


def test_chunk_width_invariance():
    """Same scores no matter where chunk boundaries fall (incl. a single
    chunk spanning everything == the unchunked formulation)."""
    rng = np.random.default_rng(3)
    p = AlignParams()
    qs, ts, ms, ns, m_pad, n_pad = _batch(rng, 8, 50, 500)
    ps = _params_mat(p, ms)
    outs = []
    for c in (128, 256, n_pad):
        outs.append(
            np.asarray(
                ck.chunked_scores(
                    "local", jnp.asarray(qs), jnp.asarray(ts),
                    jnp.asarray(ns), c, params=ps,
                )
            )
        )
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(outs[0], outs[2])


def test_pick_chunk():
    assert ck.pick_chunk(8192, 2048) == (4, 2048)
    assert ck.pick_chunk(4224, 2048) == (3, 1408)
    nblk, c = ck.pick_chunk(129, 2048)
    assert nblk * c >= 129 and c % 128 == 0


def test_batch_routes_chunked(monkeypatch):
    """align_batch's chunked branch (batch.py _chunked_bucket_scores)
    produces the same results as the default CPU routing. use_chunked is
    GPU-gated, so force it to exercise the plumbing here."""
    from aligntools_tpu import batch as ab
    from aligntools_tpu.engine import select as sel

    rng = np.random.default_rng(11)
    alpha = list(b"ACGT")
    pairs = [
        (
            bytes(rng.choice(alpha, int(rng.integers(0, 80))).tolist()),
            bytes(rng.choice(alpha, int(rng.integers(1, 400))).tolist()),
        )
        for _ in range(12)
    ]
    p = AlignParams()
    for mode in ("global", "local", "overlap", "edit"):
        want = ab.align_batch(mode, pairs, p, traceback=False)
        monkeypatch.setattr(sel, "use_chunked", lambda b, n: True)
        got = ab.align_batch(mode, pairs, p, traceback=False)
        monkeypatch.undo()
        for w, g in zip(want, got):
            if mode == "edit":
                assert w == g, (mode, w, g)
            else:
                assert w.score == g.score, (mode, w.score, g.score)


def test_batch_routes_chunked_fit(monkeypatch):
    from aligntools_tpu import batch as ab
    from aligntools_tpu.engine import select as sel

    rng = np.random.default_rng(13)
    alpha = list(b"ACGT")
    pairs, sites_list = [], []
    for _ in range(8):
        m = int(rng.integers(1, 60))
        n = int(rng.integers(60, 500))
        pairs.append(
            (bytes(rng.choice(alpha, m).tolist()),
             bytes(rng.choice(alpha, n).tolist()))
        )
        sites_list.append(sorted(int(x) for x in rng.integers(0, n, 3)))
    p = AlignParams(match=2, mismatch=-2)
    want = ab.align_batch("fit", pairs, p, sites_list=sites_list,
                          traceback=False)
    monkeypatch.setattr(sel, "use_chunked", lambda b, n: True)
    got = ab.align_batch("fit", pairs, p, sites_list=sites_list,
                         traceback=False)
    assert [w.score for w in want] == [g.score for g in got]


@pytest.mark.parametrize("mode", ["global", "local", "overlap"])
@pytest.mark.parametrize("n_chunk", [128, 256])
def test_chunked_ptr_matches_scan(mode, n_chunk):
    """Pointer-emitting chunked fill: packed bytes, traceback starts, and
    scores all bit-identical to the vmapped engine/scan.py machines."""
    import jax

    rng = np.random.default_rng(hash((mode, n_chunk, "ptr")) % 2**31)
    p = AlignParams()
    qs, ts, ms, ns, m_pad, n_pad = _batch(rng, 10, 70, 500)
    ps = _params_mat(p, ms)
    if mode == "global":
        f = lambda q, t, n, pp: sc.global_fill(q, t, n, pp, n_pad, True)
    elif mode == "local":
        f = lambda q, t, n, pp: sc.local_fill(q, t, n, pp, n_pad, True)
    else:
        f = lambda q, t, n, pp: sc.overlap_fill(q, t, n, pp, n_pad, True)
    want = jax.vmap(f)(jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(ns), ps)
    got = ck.chunked_ptr_fill(
        mode, jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(ns), n_chunk,
        params=ps,
    )
    assert len(got) == len(want)
    for k, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), np.asarray(g)
        assert np.array_equal(w, g, equal_nan=True), (
            mode, n_chunk, f"component {k}", w, g)


@pytest.mark.parametrize("use_jump", [False, True])
def test_chunked_fit_ptr_matches_scan(use_jump):
    import jax

    rng = np.random.default_rng(29 + use_jump)
    p = AlignParams(match=2, mismatch=-2)
    B, n_max = 10, 700
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    m_pad, n_pad = sc.pad_len(50), sc.pad_len(n_max)
    qs = np.full((B, m_pad), -1, np.int32)
    ts = np.full((B, n_pad), -2, np.int32)
    allow = np.ones((B, n_pad), bool)
    ms = rng.integers(1, 51, B)
    ns = rng.integers(51, n_max + 1, B)
    for r in range(B):
        qs[r, : ms[r]] = rng.choice(alpha, ms[r])
        ts[r, : ns[r]] = rng.choice(alpha, ns[r])
        if use_jump:
            allow[r, rng.integers(0, ns[r], 5)] = False
    ps = _params_mat(p, ms)
    want = jax.vmap(
        lambda q, t, n, pp, al: sc.fit_fill(q, t, n, pp, al, n_pad,
                                            use_jump, True)
    )(jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(ns), ps,
      jnp.asarray(allow))
    got = ck.chunked_fit_ptr_fill(
        use_jump, jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(allow),
        jnp.asarray(ns), 256, params=ps,
    )
    for k, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), np.asarray(g)
        assert np.array_equal(w, g, equal_nan=True), (
            use_jump, f"component {k}")


def test_batch_full_alignments_route_chunked(monkeypatch):
    """Traceback path through the chunked pointer fill: AlignResults
    (scores AND rows) identical to the default CPU routing."""
    from aligntools_tpu import batch as ab
    from aligntools_tpu.engine import select as sel

    rng = np.random.default_rng(17)
    alpha = list(b"ACGT")
    pairs = [
        (
            bytes(rng.choice(alpha, int(rng.integers(1, 60))).tolist()),
            bytes(rng.choice(alpha, int(rng.integers(1, 300))).tolist()),
        )
        for _ in range(10)
    ]
    p = AlignParams()
    for mode in ("global", "local", "overlap"):
        want = ab.align_batch(mode, pairs, p, traceback=True)
        monkeypatch.setattr(sel, "use_chunked", lambda b, n: True)
        got = ab.align_batch(mode, pairs, p, traceback=True)
        monkeypatch.undo()
        for w, g in zip(want, got):
            assert (w.score, w.row1, w.row2) == (g.score, g.row1, g.row2), (
                mode, w, g)
    # fit with junction jumps, rows included
    pairs_f, sites_list = [], []
    for _ in range(6):
        m = int(rng.integers(1, 40))
        n = int(rng.integers(40, 300))
        pairs_f.append(
            (bytes(rng.choice(alpha, m).tolist()),
             bytes(rng.choice(alpha, n).tolist()))
        )
        sites_list.append(sorted(int(x) for x in rng.integers(0, n, 3)))
    pf = AlignParams(match=2, mismatch=-2)
    want = ab.align_batch("fit", pairs_f, pf, sites_list=sites_list,
                          traceback=True)
    monkeypatch.setattr(sel, "use_chunked", lambda b, n: True)
    got = ab.align_batch("fit", pairs_f, pf, sites_list=sites_list,
                         traceback=True)
    for w, g in zip(want, got):
        assert (w.score, w.row1, w.row2) == (g.score, g.row1, g.row2)


def test_decaying_params_fast_path():
    """local's unmasked latch (decaying_params=True) must be bit-equal
    to the masked path for non-positive penalties — incl. ragged m with
    m=0 pairs whose unmasked latch picks up pad-row values and is fixed
    after the fold."""
    rng = np.random.default_rng(41)
    p = AlignParams()  # mis=-2, o=-5, e=-1: decaying
    qs, ts, ms, ns, m_pad, n_pad = _batch(rng, 16, 90, 700)
    ms[0] = 0  # the degenerate m=0 fix must be exercised
    qs[0, :] = -1
    ps = _params_mat(p, ms)
    a = (jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(ns))
    slow = np.asarray(ck.chunked_scores("local", *a, 256, params=ps))
    fast = np.asarray(ck.chunked_scores("local", *a, 256, params=ps,
                                        decaying_params=True))
    assert np.array_equal(slow, fast, equal_nan=True)
