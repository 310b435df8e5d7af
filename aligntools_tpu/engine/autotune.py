"""Measured engine crossover and chunk width, cached per device kind.

engine/select.py sends a bucket to the column-chunked engine when its
target fits one chunk or its batch reaches ``chunked_bmin``, and to the
vmapped row-scan engine otherwise; engine/chunked.py fills in columns of
``chunked_chunk``. The defaults here and in
``chunked.DEFAULT_CHUNK`` were measured on an H100 (PERF.md, "Bring-up
findings"). ``aligntools calibrate`` measures the first two on the
attached GPU and caches them as JSON beside the compile cache
(backend.cache_dir()), keyed by device kind:

  * ``chunked_bmin``: local scores at 8192^2 (four chunks), chunked vs
    vmap at batch 32/64/128/256; the smallest batch where the chunked
    engine wins.
  * ``chunked_chunk``: chunk width 512/1024/2048 at the clustered
    short-read bucket (640 x 320 x 3072) and at 256 x 2048^2; the width
    with the least summed time ratio to each shape's best.

Every probe runs in this process. The cache never invalidates itself:
recalibrate with ``--force`` after a driver or toolchain change.
"""

from __future__ import annotations

import json
import os
import re
import time

# chunked_bmin: local scores at 8192^2, the vmap engine wins at batch 32,
# 64 and 128 and the chunked engine at 256 (`aligntools calibrate` on an
# H100 80GB HBM3 at 400 W; PERF.md, "Bring-up findings")
_DEFAULTS = {"chunked_bmin": 256}
_loaded: dict | None = None

CROSSOVER_BATCHES = (32, 64, 128, 256)
CHUNK_WIDTHS = (512, 1024, 2048)
CHUNK_SHAPES = ((640, 320, 3072), (256, 2048, 2048))


def _cache_path() -> str:
    import jax

    from aligntools_tpu.backend import cache_dir

    kind = jax.devices()[0].device_kind
    slug = re.sub(r"[^A-Za-z0-9._-]+", "_", kind)
    return os.path.join(cache_dir(), f"autotune_{slug}.json")


def table() -> dict:
    """The active table: the cached measurement for this device kind if
    present, else the defaults."""
    global _loaded
    if _loaded is None:
        try:
            with open(_cache_path()) as f:
                _loaded = {**_DEFAULTS, **json.load(f)}
        except (OSError, ValueError):
            _loaded = dict(_DEFAULTS)
    return _loaded


def bench(engine: str, batch: int, m: int, n: int, chunk: int | None = None,
          reps: int = 3, seed: int = 0) -> tuple[float, float]:
    """(first-call seconds, best warm seconds) of one local score fill of
    ``batch`` random DNA pairs of m x n on ``engine`` ("chunked" at
    ``chunk`` columns, or "vmap"). The first call includes tracing and
    compilation; every timing ends in ``block_until_ready``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from aligntools_tpu import batch as bt
    from aligntools_tpu.engine import chunked as ck
    from aligntools_tpu.params import AlignParams

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    q = rng.choice(alpha, (batch, m))
    t = rng.choice(alpha, (batch, n))
    ps = bt._params_mat(AlignParams(), np.full(batch, m, np.int32))
    ns = jnp.asarray(np.full(batch, n, np.int32))
    if engine == "chunked":
        qi = jnp.asarray(q.astype(np.int32))
        ti = jnp.asarray(t.astype(np.int32))
        width = chunk or ck.default_chunk()

        def fill():
            return ck.chunked_scores("local", qi, ti, ns, width, params=ps,
                                     decaying_params=True)
    elif engine == "vmap":
        qu, tu = jnp.asarray(q), jnp.asarray(t)

        def fill():
            return bt._vfill(qu, tu, "local", n, False, ns, ps)[0]
    else:
        raise ValueError(f"unknown engine {engine!r}")
    t0 = time.perf_counter()
    jax.block_until_ready(fill())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fill())
        best = min(best, time.perf_counter() - t0)
    return first, best


def calibrate(force: bool = False, log=print) -> dict:
    """Measure the table on the attached GPU and cache it. Returns the
    table; a no-op unless ``force`` or no cache entry exists."""
    global _loaded
    import jax

    from aligntools_tpu.backend import require_device

    if require_device() != "gpu":
        raise RuntimeError("calibrate measures the GPU; no GPU is attached")
    path = _cache_path()
    if not force and os.path.exists(path):
        _loaded = None
        return table()
    result = {"device_kind": jax.devices()[0].device_kind, "measured": {}}
    # 1. chunked-vs-vmap batch crossover at 8192^2 (several chunks)
    bmin = None
    for batch in CROSSOVER_BATCHES:
        tc = bench("chunked", batch, 8192, 8192)[1]
        tv = bench("vmap", batch, 8192, 8192)[1]
        result["measured"][f"b{batch}_n8192"] = {"chunked": tc, "vmap": tv}
        log(f"  batch {batch:4d} x 8192^2: chunked {tc * 1e3:8.2f} ms  "
            f"vmap {tv * 1e3:8.2f} ms")
        if tc < tv and bmin is None:
            bmin = batch
    result["chunked_bmin"] = int(bmin if bmin is not None else 1 << 30)
    # 2. chunk width, judged over both shapes (each weighted equally)
    secs = {
        w: {sh: bench("chunked", *sh, chunk=w)[1] for sh in CHUNK_SHAPES}
        for w in CHUNK_WIDTHS
    }
    for w, per in secs.items():
        for (b_, m_, n_), s in per.items():
            log(f"  chunk width {w:5d} @{b_}x{m_}x{n_}: {s * 1e3:8.2f} ms")
    best = {sh: min(per[sh] for per in secs.values()) for sh in CHUNK_SHAPES}
    score = {w: sum(per[sh] / best[sh] for sh in CHUNK_SHAPES)
             for w, per in secs.items()}
    result["measured"]["chunked_chunk"] = {
        str(w): {"x".join(map(str, sh)): s for sh, s in per.items()}
        for w, per in secs.items()
    }
    result["chunked_chunk"] = int(min(score, key=score.get))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1)
    os.replace(tmp, path)
    _loaded = None
    log(f"calibrated {result['device_kind']}: chunked engine from batch "
        f"{result['chunked_bmin']}, chunk width {result['chunked_chunk']} "
        f"-> {path}")
    return table()
