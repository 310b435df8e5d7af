"""Sequence parallelism: target sharded over the 8-virtual-device CPU mesh
must give bit-identical scores to the single-device engines, all modes."""

import numpy as np
import pytest

from aligntools_tpu.batch import batch_scores
from aligntools_tpu.params import AlignParams
from aligntools_tpu.parallel.seqpar import seqpar_score

ALPHA = list(b"ACGT")


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "edit", "fit"])
def test_seqpar_matches_single_device(mode):
    rng = np.random.default_rng(47)
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    for i in range(6):
        m = int(rng.integers(1, 90))
        n = int(rng.integers(m if mode == "fit" else 1, 1500))
        if mode == "fit":
            n = max(n, m)
        q = bytes(rng.choice(ALPHA, m).tolist())
        t = bytes(rng.choice(ALPHA, n).tolist())
        sites = None
        if mode == "fit" and i % 2:
            sites = sorted(int(x) for x in rng.integers(0, n, 4))
        got = seqpar_score(mode, q, t, p, sites=sites)
        want = batch_scores(mode, [(q, t)], p,
                            sites_list=[sites] if sites else None)[0]
        assert got == want, (mode, i, m, n)


def test_dp_sp_composition():
    """2D mesh: batch sharded over 'data' x targets sharded over 'seq' —
    both parallel axes composed in one shard_map, bit-identical scores."""
    import jax
    from jax.sharding import Mesh
    from aligntools_tpu.parallel.seqpar import seqpar_batch_scores

    rng = np.random.default_rng(91)
    devs = np.asarray(jax.devices())
    mesh = Mesh(devs.reshape(2, 4), ("data", "seq"))
    for mode in ("global", "local", "fit", "overlap", "edit"):
        pairs, sites = [], []
        for _ in range(5):  # deliberately not a multiple of the data axis
            m = int(rng.integers(1, 40))
            n = int(rng.integers(m, 700))
            pairs.append((bytes(rng.choice(ALPHA, m).tolist()),
                          bytes(rng.choice(ALPHA, n).tolist())))
            sites.append(sorted(int(x) for x in rng.integers(0, n, 3)))
        p = AlignParams(match=2, mismatch=-1, gap_open=-3, gap_extend=-1)
        sl = sites if mode == "fit" else None
        got = seqpar_batch_scores(mode, pairs, p, sites_list=sl, mesh=mesh)
        want = batch_scores(mode, pairs, p, sites_list=sl)
        assert np.array_equal(got, want), mode


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_seqpar_full_alignments(mode):
    """Sequence-parallel FULL alignments: sharded fill + per-device pointer
    slabs + device walk == the single-device full-alignment path, byte for
    byte (rows, not just scores)."""
    from aligntools_tpu.batch import align_batch
    from aligntools_tpu.parallel.seqpar import seqpar_align

    rng = np.random.default_rng(73)
    p = AlignParams(match=2, mismatch=-2, gap_open=-4, gap_extend=-1)
    for i in range(4):
        m = int(rng.integers(3, 48))
        n = int(rng.integers(max(m, 400), 1200))  # several 128-col shards
        q = bytes(rng.choice(ALPHA, m).tolist())
        t = bytes(rng.choice(ALPHA, n).tolist())
        sites = None
        if mode == "fit" and i % 2:
            sites = sorted(int(x) for x in rng.integers(0, n, 4))
        got = seqpar_align(mode, q, t, p, sites=sites)
        want = align_batch(mode, [(q, t)], p,
                           sites_list=[sites] if sites else None)[0]
        assert got.score == want.score, (mode, i)
        assert (got.row1, got.row2) == (want.row1, want.row2), (mode, i)


def test_seqpar_full_tie_heavy():
    """Binary alphabet maximizes DP ties: the distributed argmax/pointer
    tie-breaks must still match the reference order exactly."""
    from aligntools_tpu.batch import align_batch
    from aligntools_tpu.parallel.seqpar import seqpar_align

    rng = np.random.default_rng(74)
    p = AlignParams()
    for mode in ("global", "local", "fit", "overlap"):
        for i in range(3):
            m = int(rng.integers(3, 24))
            n = int(rng.integers(max(m, 300), 900))
            q = bytes(rng.choice([65, 66], m).tolist())
            t = bytes(rng.choice([65, 66], n).tolist())
            got = seqpar_align(mode, q, t, p)
            want = align_batch(mode, [(q, t)], p)[0]
            assert got.score == want.score, (mode, i)
            assert (got.row1, got.row2) == (want.row1, want.row2), (mode, i)


def test_seqpar_slab_packing_shapes():
    """The sharded pointer slab is bit-packed IN the fill scan: 4 DP rows
    per byte for overlap's 2-bit codes, 2 (nibbles) for the affine modes,
    1 only for fit+jump's 6-bit layout (parallel/seqpar.py docstring) —
    checked via eval_shape so a silent fallback to byte rows would fail."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from aligntools_tpu.parallel import seqpar as sp

    mesh = Mesh(np.asarray(jax.devices()), ("seq",))
    n_pad = 128 * mesh.devices.size
    m_pad = 16
    args = (
        jnp.zeros(m_pad, jnp.int32),
        jnp.zeros(n_pad, jnp.int32),
        jnp.ones(n_pad, jnp.float32),
        jnp.int32(n_pad),
        jnp.zeros(8, jnp.float32),
    )
    for mode, use_jump, rpb in (
        ("global", False, 2), ("local", False, 2), ("fit", False, 2),
        ("overlap", False, 4), ("fit", True, 1),
    ):
        out = jax.eval_shape(
            functools.partial(
                sp._seqpar_fill_ptr, mode, n_pad, use_jump, rpb, mesh
            ),
            *args,
        )
        assert out[3].shape == (m_pad // rpb, n_pad), (mode, rpb)
        assert out[3].dtype == jnp.uint8
