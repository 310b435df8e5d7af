"""Tests that need the GPU (marker ``gpu``); they skip elsewhere.

``python chip_smoke.py`` runs them on the card (phase 7). They check what
only the card can show: the routing the GPU takes, the device memory
limit the rows router reads, and device results against the oracles.
"""

import numpy as np
import pytest

from aligntools_tpu.params import AlignParams
from aligntools_tpu.spec import engine as spec

pytestmark = pytest.mark.gpu

ALPHA = np.frombuffer(b"ACGT", np.uint8)


def _pairs(seed, count, m, n):
    """``count`` random pairs of exactly m x n: one bucket, one compile."""
    rng = np.random.default_rng(seed)
    return [(rng.choice(ALPHA, m).tobytes(), rng.choice(ALPHA, n).tobytes())
            for _ in range(count)]


def test_gpu_routing_defaults(gpu):
    from aligntools_tpu import backend
    from aligntools_tpu.engine import autotune, chunked, scan, select

    assert backend.on_gpu() and backend.require_device() == "gpu"
    bmin = autotune.table()["chunked_bmin"]
    assert select.use_chunked(bmin, 8192)
    assert select.use_chunked(1, chunked.default_chunk())
    assert not select.use_chunked(1, 114688) or bmin <= 1
    assert scan._unroll() == 8
    assert chunked.default_chunk() == autotune.table().get(
        "chunked_chunk", chunked.DEFAULT_CHUNK)


def test_hbm_budget_is_bytes_limit(gpu):
    from aligntools_tpu.batch import _hbm_budget

    assert _hbm_budget() == gpu.memory_stats()["bytes_limit"]


def test_compile_cache_on_gpu(gpu):
    import jax

    from aligntools_tpu import backend

    backend.enable_compile_cache()
    assert backend._cache_enabled
    assert jax.config.jax_compilation_cache_dir == backend.cache_dir()


@pytest.mark.parametrize("n", [4, 8192, 114_491])
def test_cummax_on_device(gpu, n):
    """lax.cummax lowers by size on the GPU; exact at tmp.fa's width."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    x = rng.integers(-10_000, 10_000, n).astype(np.float32)
    x[rng.random(n) < 0.05] = -np.inf
    got = np.asarray(jax.jit(jax.lax.cummax)(jnp.asarray(x)))
    assert np.array_equal(got, np.maximum.accumulate(x))


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "edit"])
def test_engines_agree_on_device(gpu, mode, monkeypatch):
    """Chunked and vmap engines on the card: equal to each other and to
    the spec oracle."""
    from aligntools_tpu.batch import batch_scores
    from aligntools_tpu.engine import select

    pairs = _pairs(3, 24, 120, 3000)
    p = AlignParams(mismatch=1) if mode == "edit" else AlignParams()
    vm = batch_scores(mode, pairs, p, engine="xla")
    monkeypatch.setattr(select, "use_chunked", lambda b, n: True)
    ch = batch_scores(mode, pairs, p)
    assert np.array_equal(vm, ch)
    fn = getattr(spec, f"spec_{mode}")
    for k in (0, 7):
        w = fn(*pairs[k], p)
        assert vm[k] == (w if mode == "edit" else w.score)


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "fit"])
def test_device_walk_on_device(gpu, mode):
    """Rows from the device walk on the card vs the spec oracle."""
    from aligntools_tpu.batch import align_batch

    pairs = _pairs(5, 12, 80, 600)
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    got = align_batch(mode, pairs, p)
    fn = getattr(spec, f"spec_{mode}")
    for k, (q, t) in enumerate(pairs):
        w = fn(q, t, p)
        assert (got[k].score, got[k].row1, got[k].row2) == (
            w.score, w.row1, w.row2), (mode, k)
