"""Engine-crossover calibration table (engine/autotune.py).

The measurement needs a GPU (``aligntools calibrate`` on the card); these
tests cover the table, its placement beside the compile cache, and the
routing that reads it.
"""

import json

import pytest

from aligntools_tpu import backend
from aligntools_tpu.engine import autotune
from aligntools_tpu.engine import select


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    autotune._loaded = None
    yield tmp_path
    autotune._loaded = None


def test_defaults_without_cache(cache):
    assert autotune.table() == autotune._DEFAULTS


def test_table_lives_beside_compile_cache(cache):
    assert autotune._cache_path().startswith(str(cache))
    assert autotune._cache_path().endswith(".json")


def test_cached_table_overrides(cache):
    with open(autotune._cache_path(), "w") as f:
        json.dump({"chunked_bmin": 8, "chunked_chunk": 512,
                   "device_kind": "x"}, f)
    t = autotune.table()
    assert t["chunked_bmin"] == 8 and t["chunked_chunk"] == 512


def test_corrupt_cache_falls_back(cache):
    with open(autotune._cache_path(), "w") as f:
        f.write("{not json")
    assert autotune.table() == autotune._DEFAULTS


def test_calibrate_requires_gpu(cache):
    with pytest.raises(RuntimeError, match="GPU"):
        autotune.calibrate(force=True)


def test_bench_rejects_unknown_engine():
    with pytest.raises(ValueError):
        autotune.bench("pallas", 2, 16, 16)


@pytest.mark.parametrize("engine", ["chunked", "vmap"])
def test_bench_times_each_engine(engine):
    first, best = autotune.bench(engine, 2, 16, 128, chunk=128, reps=1)
    assert first > 0 and best > 0


@pytest.mark.parametrize("batch,bmin,n_pad,want", [
    (1, 8, 114688, False), (7, 8, 8192, False), (8, 8, 8192, True),
    (4096, 8, 114688, True), (32, 128, 8192, False), (128, 128, 8192, True),
    (1, 128, 2048, True), (32, 128, 128, True),
])
def test_use_chunked_follows_table_on_gpu(cache, monkeypatch, batch, bmin,
                                          n_pad, want):
    """On the GPU a target that fits one chunk always takes the chunked
    engine; a longer one takes it from the measured batch crossover up."""
    with open(autotune._cache_path(), "w") as f:
        json.dump({"chunked_bmin": bmin}, f)
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    monkeypatch.delenv("ALIGNTOOLS_CHUNK_WIDTH", raising=False)
    assert select.use_chunked(batch, n_pad) is want


def test_bucket_budget_by_backend(monkeypatch):
    from aligntools_tpu import batch as bt

    monkeypatch.delenv("ALIGNTOOLS_MAX_BUCKETS", raising=False)
    assert bt._bucket_budget() == bt.MAX_BUCKETS  # CPU backend here
    monkeypatch.setattr(bt, "on_gpu", lambda: True)
    assert bt._bucket_budget() == bt.GPU_MAX_BUCKETS
    monkeypatch.setenv("ALIGNTOOLS_MAX_BUCKETS", "5")
    assert bt._bucket_budget() == 5


def test_use_chunked_escape_hatch_and_cpu(cache, monkeypatch):
    assert select.use_chunked(4096, 2048) is False  # CPU backend here
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    assert select.use_chunked(4096, 2048) is True
    monkeypatch.setenv("ALIGNTOOLS_NO_CHUNKED", "1")
    assert select.use_chunked(4096, 2048) is False


def test_chunk_width_knob(monkeypatch):
    """default_chunk(): env override wins; the CPU takes the constant."""
    from aligntools_tpu.engine import chunked as ck

    monkeypatch.delenv("ALIGNTOOLS_CHUNK_WIDTH", raising=False)
    assert ck.default_chunk() == ck.DEFAULT_CHUNK  # CPU backend here
    monkeypatch.setenv("ALIGNTOOLS_CHUNK_WIDTH", "1024")
    assert ck.default_chunk() == 1024
    monkeypatch.setenv("ALIGNTOOLS_CHUNK_WIDTH", "7")  # floored to 128
    assert ck.default_chunk() == 128


def test_chunk_width_from_table_on_gpu(cache, monkeypatch):
    from aligntools_tpu.engine import chunked as ck

    monkeypatch.delenv("ALIGNTOOLS_CHUNK_WIDTH", raising=False)
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    assert ck.default_chunk() == ck.DEFAULT_CHUNK
    autotune._loaded = {"chunked_bmin": 8, "chunked_chunk": 512}
    assert ck.default_chunk() == 512


def test_scan_unroll_by_backend(monkeypatch):
    from aligntools_tpu.engine import scan as sc

    assert sc._unroll() == 1
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    assert sc._unroll() == 8
