"""Batched path: parity with the spec oracle + padding/bucketing invariance.

Padding must not perturb scores, argmax rows, or tie-breaks (SURVEY.md §7
hard parts): each pair's result must be identical whether aligned alone or
inside a mixed-length batch that pads it into a larger bucket."""

import numpy as np
import pytest

from aligntools_tpu.batch import align_batch, batch_scores
from aligntools_tpu.params import AlignParams
from aligntools_tpu.spec import engine as spec

ALPHA = b"ACGT"


def _rand_pairs(rng, count, qlo, qhi, tlo, thi):
    out = []
    for _ in range(count):
        q = bytes(rng.choice(list(ALPHA), int(rng.integers(qlo, qhi))).tolist())
        t = bytes(rng.choice(list(ALPHA), int(rng.integers(tlo, thi))).tolist())
        out.append((q, t))
    return out


@pytest.mark.parametrize("mode", ["global", "local", "overlap"])
def test_batch_matches_spec(mode):
    rng = np.random.default_rng(3)
    pairs = _rand_pairs(rng, 24, 1, 70, 1, 300)  # spans several buckets
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    got = align_batch(mode, pairs, p)
    fn = getattr(spec, f"spec_{mode}")
    for k, (q, t) in enumerate(pairs):
        want = fn(q, t, p)
        assert got[k].score == want.score, (mode, k)
        assert (got[k].row1, got[k].row2) == (want.row1, want.row2), (mode, k)


def test_batch_fit_with_sites():
    rng = np.random.default_rng(5)
    pairs, sites = [], []
    for _ in range(16):
        q = bytes(rng.choice(list(ALPHA), int(rng.integers(1, 30))).tolist())
        t = bytes(rng.choice(list(ALPHA), int(rng.integers(len(q), 200))).tolist())
        pairs.append((q, t))
        k = int(rng.integers(0, 5))
        sites.append(sorted(int(x) for x in rng.integers(0, len(t), k)))
    p = AlignParams()
    got = align_batch("fit", pairs, p, sites_list=sites)
    for k, (q, t) in enumerate(pairs):
        want = spec.spec_fit(q, t, p, sites[k])
        assert got[k].score == want.score, k
        assert (got[k].row1, got[k].row2) == (want.row1, want.row2), k


def test_batch_edit():
    rng = np.random.default_rng(9)
    pairs = _rand_pairs(rng, 12, 1, 100, 1, 100)
    p = AlignParams(mismatch=1)
    got = batch_scores("edit", pairs, p)
    for k, (q, t) in enumerate(pairs):
        assert got[k] == spec.spec_edit(q, t, p), k


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_padding_invariance(mode):
    """A pair's result is identical alone vs inside a mixed batch (which
    places it in a larger padded bucket with other pairs)."""
    rng = np.random.default_rng(13)
    p = AlignParams()
    q = bytes(rng.choice(list(ALPHA), 20).tolist())
    t = bytes(rng.choice(list(ALPHA), 37).tolist())
    solo = align_batch(mode, [(q, t)], p)[0]
    # a large pair lands in its own bucket; same-bucket partners below check
    # that co-batching (and the shared padded shapes) leave results identical
    big_q = bytes(rng.choice(list(ALPHA), 300).tolist())
    big_t = bytes(rng.choice(list(ALPHA), 900).tolist())
    # same-bucket partners with different true lengths
    q2 = bytes(rng.choice(list(ALPHA), 21).tolist())
    t2 = bytes(rng.choice(list(ALPHA), 30).tolist())
    mixed = align_batch(mode, [(q2, t2), (q, t), (big_q, big_t)], p)[1]
    assert mixed.score == solo.score
    assert (mixed.row1, mixed.row2) == (solo.row1, solo.row2)


def test_score_only_matches():
    rng = np.random.default_rng(17)
    pairs = _rand_pairs(rng, 10, 1, 50, 1, 50)
    p = AlignParams()
    fast = batch_scores("global", pairs, p)
    full = [r.score for r in align_batch("global", pairs, p)]
    assert list(fast) == full


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "edit"])
def test_chunked_route_matches_vmap(mode, monkeypatch):
    """The GPU's large-batch route (chunked engine, forced here) vs the
    vmap engine (``engine="xla"``) through batch_scores, per mode."""
    from aligntools_tpu.engine import select as sel

    rng = np.random.default_rng(31)
    pairs = _rand_pairs(rng, 10, 1, 60, 1, 150)
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    want = batch_scores(mode, pairs, p, engine="xla")
    monkeypatch.setattr(sel, "use_chunked", lambda b, n: True)
    got = batch_scores(mode, pairs, p)
    assert np.array_equal(got, want)


def test_chunked_route_fit(monkeypatch):
    from aligntools_tpu.engine import select as sel

    rng = np.random.default_rng(33)
    pairs, sites = [], []
    for _ in range(9):
        q = bytes(rng.choice(list(ALPHA), int(rng.integers(1, 30))).tolist())
        t = bytes(rng.choice(list(ALPHA), int(rng.integers(len(q), 160))).tolist())
        pairs.append((q, t))
        sites.append(sorted(int(x) for x in rng.integers(0, len(t), 3)))
    p = AlignParams()
    monkeypatch.setattr(sel, "use_chunked", lambda b, n: True)
    for sl in (sites, None):
        got = batch_scores("fit", pairs, p, sites_list=sl)
        want = batch_scores("fit", pairs, p, sites_list=sl, engine="xla")
        assert np.array_equal(got, want), sl is None


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_device_traceback_matches_host(mode):
    """On-device batched walk vs the host walker, bit-for-bit (runs the
    device path explicitly; on CPU it exercises the same jitted code)."""
    from aligntools_tpu.engine import device_tb
    from aligntools_tpu.batch import _bucketize, _params_mat, _vfill, _vfill_fit
    import jax.numpy as jnp
    import jax

    rng = np.random.default_rng(51)
    pairs = []
    for _ in range(11):
        q = bytes(rng.choice(list(ALPHA), int(rng.integers(1, 50))).tolist())
        lo = len(q) if mode == "fit" else 1
        t = bytes(rng.choice(list(ALPHA), int(rng.integers(lo, 120))).tolist())
        pairs.append((q, t))
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    want = align_batch(mode, pairs, p)
    buckets = _bucketize(pairs, None)
    assert len(buckets) == 1, "lengths chosen to land in one bucket"
    (b,) = buckets.values()
    ps = _params_mat(p, b.m)
    ns = jnp.asarray(b.n)
    qs, ts = jnp.asarray(b.q), jnp.asarray(b.t)
    if mode == "fit":
        allowed = jnp.asarray(np.ones((len(b.idx), b.n_pad), dtype=bool))
        out = _vfill_fit(qs, ts, allowed, b.n_pad, False, True, ns, ps)
        starts = [(1 if int(out[1][r]) == 0 else 0, b.m[r], int(out[2][r]))
                  for r in range(len(b.idx))]
    else:
        out = _vfill(qs, ts, mode, b.n_pad, True, ns, ps)
        if mode == "global":
            starts = [(int(out[1][r]), b.m[r], b.n[r])
                      for r in range(len(b.idx))]
        elif mode == "local":
            starts = [(1, int(out[1][r]), int(out[2][r]))
                      for r in range(len(b.idx))]
        else:
            starts = [(0, b.m[r], int(out[1][r]))
                      for r in range(len(b.idx))]
    rows = device_tb.batch_traceback(mode, out[-1], b.q, b.t,
                                     [pairs[k] for k in b.idx], starts)
    for r, k in enumerate(b.idx):
        assert rows[r] == (want[k].row1, want[k].row2), (mode, k)


@pytest.mark.parametrize("mode,use_jump,pack", [
    ("global", False, 1), ("local", False, 1),
    ("overlap", False, 1), ("fit", False, 1), ("fit", True, 1),
    ("global", False, 2), ("local", False, 2),
    ("overlap", False, 2), ("fit", False, 2), ("overlap", False, 4),
])
def test_chunked_packed_device_walk(mode, use_jump, pack):
    """Pointer-emitting chunked fill at 1, 2 or 4 rows per byte, walked on
    the device (raw packed block layout for pack > 1, as the GPU rows
    path does) vs the host walk of the vmap fill: scores AND rows
    bit-identical."""
    import jax.numpy as jnp

    from aligntools_tpu.engine import chunked as ck
    from aligntools_tpu.engine import device_tb

    rng = np.random.default_rng(71)
    B, m_pad, n_pad, chunk = 8, 64, 384, 128
    pairs, sites = [], []
    for _ in range(B):
        m = int(rng.integers(1, m_pad + 1))
        n = int(rng.integers(m if mode == "fit" else 1, n_pad + 1))
        if mode == "fit":
            n = max(n, m)
        pairs.append((bytes(rng.choice(list(ALPHA), m).tolist()),
                      bytes(rng.choice(list(ALPHA), n).tolist())))
        sites.append(sorted(int(x) for x in rng.integers(0, n, 3)))
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    qs = np.full((B, m_pad), -1, np.int32)
    ts = np.full((B, n_pad), -2, np.int32)
    ms = np.zeros(B, np.int32)
    ns = np.zeros(B, np.int32)
    allow = np.ones((B, n_pad), bool)
    for k, (q, t) in enumerate(pairs):
        qs[k, : len(q)] = np.frombuffer(q, np.uint8)
        ts[k, : len(t)] = np.frombuffer(t, np.uint8)
        ms[k], ns[k] = len(q), len(t)
        if use_jump:
            allow[k, sites[k]] = False
    ps = np.zeros((B, 6), np.float32)
    ps[:, :5] = [p.match, p.mismatch, p.gap_open, p.gap_extend, p.jump]
    ps[:, 5] = ms
    dq, dt, dn, dp = (jnp.asarray(x) for x in (qs, ts, ns, ps))
    if mode == "fit":
        out = ck.chunked_fit_ptr_fill(use_jump, dq, dt, jnp.asarray(allow),
                                      dn, chunk, pack, params=dp)
    else:
        out = ck.chunked_ptr_fill(mode, dq, dt, dn, chunk, pack, params=dp)
    if pack > 1:
        assert out[-1].shape[1] == m_pad // pack  # packed rows
    want = align_batch(mode, pairs, p, sites_list=sites if use_jump else None)
    assert np.array_equal(np.asarray(out[0]).astype(np.float64),
                          [w.score for w in want])
    a = np.asarray(out[1])
    if mode == "global":
        starts = [(int(a[k]), int(ms[k]), int(ns[k])) for k in range(B)]
    elif mode == "local":
        bvec = np.asarray(out[2])
        starts = [(1, int(a[k]), int(bvec[k])) for k in range(B)]
    elif mode == "fit":
        bvec = np.asarray(out[2])
        starts = [(1 if int(a[k]) == 0 else 0, int(ms[k]), int(bvec[k]))
                  for k in range(B)]
    else:
        starts = [(0, int(ms[k]), int(a[k])) for k in range(B)]
    blk = chunk if pack > 1 else 0
    rows = device_tb.batch_traceback(mode, out[-1], qs, ts, pairs, starts,
                                     col_base=1 if blk else 0, pack4=pack,
                                     blk_chunk=blk)
    for k in range(B):
        assert rows[k] == (want[k].row1, want[k].row2), (mode, k)


def test_bucket_ladder_properties():
    """Quarter-octave rungs: >= x, hardware-aligned, monotone, and at
    most 1.25x overhead per dim past the floor (modulo alignment)."""
    from aligntools_tpu.batch import bucket_len

    for floor, align in ((64, 16), (128, 128)):
        prev = 0
        for x in range(1, 40000, 7):
            b = bucket_len(x, floor, steps=4)
            assert b >= x and b >= floor
            assert b % align == 0
            assert b >= prev or x < prev  # monotone in x
            if x > floor:
                assert b <= max(
                    -(-int(x * 1.25) // align) * align, floor
                ), (x, b)
            prev = b
        # steps=1 reproduces round-1 powers of two
        assert bucket_len(1000, 128, steps=1) == 1024
        assert bucket_len(1025, 128, steps=1) == 2048


def test_bucket_pad_reduction_and_compile_cap():
    """>= 15% padded-cell reduction on a mixed-length
    workload at equal-or-fewer compile counts (plus the absolute floor).
    Clustered lengths (realistic read-length distributions) take the
    fine ladder; a full log-uniform length spray must degrade to pow2
    rather than blow up the bucket count."""
    from aligntools_tpu.batch import MAX_BUCKETS, _bucket_keys, bucket_len

    rng = np.random.default_rng(11)

    def cells(keys):
        return sum(mp * np_ for mp, np_ in keys)

    # clustered: m ~ 300 +- 20%, n ~ 3000 +- 25%
    ms = np.exp(rng.normal(np.log(300), 0.2, 512)).astype(int)
    ns = np.exp(rng.normal(np.log(3000), 0.25, 512)).astype(int)
    wl = [(b"A" * m, b"A" * n) for m, n in zip(ms, ns)]
    fine = _bucket_keys(wl, 64, 128)
    pow2 = [(bucket_len(len(q), 64, 1), bucket_len(len(t), 128, 1))
            for q, t in wl]
    assert len(set(fine)) <= max(MAX_BUCKETS, len(set(pow2)))
    assert cells(fine) < 0.85 * cells(pow2), (cells(fine), cells(pow2))
    # spray: ladder would multiply buckets 6x -> must fall back to pow2
    lens = np.exp(rng.uniform(np.log(100), np.log(8000), (512, 2)))
    spray = [(b"A" * int(a), b"A" * int(b)) for a, b in lens]
    keys = _bucket_keys(spray, 64, 128)
    pow2s = [(bucket_len(len(q), 64, 1), bucket_len(len(t), 128, 1))
             for q, t in spray]
    assert len(set(keys)) <= len(set(pow2s))


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "fit"])
def test_ladder_bucket_padding_invariance(mode):
    """Pairs landing in non-pow2 rungs (e.g. 80x384) score and trace
    identically to the same pairs padded alone."""
    rng = np.random.default_rng(13)
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    pairs = []
    for _ in range(12):
        m = int(rng.integers(66, 79))   # rung 80
        n = int(rng.integers(260, 380))  # rung 384
        if mode == "fit":
            n = max(n, m)
        pairs.append((bytes(rng.choice(list(ALPHA), m).tolist()),
                      bytes(rng.choice(list(ALPHA), n).tolist())))
    got = align_batch(mode, pairs, p)
    fn = getattr(spec, f"spec_{mode}")
    for k, (q, t) in enumerate(pairs):
        want = fn(q, t, p)
        assert got[k].score == want.score, (mode, k)
        assert (got[k].row1, got[k].row2) == (want.row1, want.row2), (mode, k)


def test_packed_transport_matches_uint8():
    """2-bit packed transport (_pack2 + _unpack_sentinelize) decodes to
    the exact int32 sentinel planes of the plain uint8 path, for
    alphabets of 1-4 chars, ragged lengths, and batch-rung pad rows."""
    import jax.numpy as jnp

    from aligntools_tpu import batch as ab

    rng = np.random.default_rng(77)
    for k in (1, 2, 4):
        alpha_chars = rng.choice(256, size=k, replace=False).astype(np.uint8)
        pairs = []
        for _ in range(23):
            m = int(rng.integers(1, 60))
            n = int(rng.integers(1, 200))
            pairs.append((
                bytes(rng.choice(alpha_chars, m).tolist()),
                bytes(rng.choice(alpha_chars, n).tolist()),
            ))
        buckets = ab._bucketize(pairs, None)
        for b in buckets.values():
            assert b.alpha is not None, "small alphabet must be detected"
            q_np, t_np, _, m_np, n_np = ab._pad_rows(b)
            ms = jnp.asarray(m_np.astype(np.int32))
            ns = jnp.asarray(n_np.astype(np.int32))
            want_q, want_t = ab._sentinelize_dev(
                jnp.asarray(q_np), jnp.asarray(t_np), ms, ns
            )
            # the packed transport path (2-bit blob + fused meta blob)
            got_q, got_t, got_ns, got_ms, _ = ab._dev_inputs(
                q_np, t_np, m_np, n_np, b.alpha
            )
            assert np.array_equal(np.asarray(got_q), np.asarray(want_q))
            assert np.array_equal(np.asarray(got_t), np.asarray(want_t))
            assert np.array_equal(np.asarray(got_ns), n_np)
            assert np.array_equal(np.asarray(got_ms), m_np)
    # > 4 distinct chars: transport must fall back (no alpha)
    pairs = [(bytes(range(10)), bytes(range(10, 30)))]
    buckets = ab._bucketize(pairs, None)
    for b in buckets.values():
        assert b.alpha is None
