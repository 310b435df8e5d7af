"""Engine measurements that set the GPU routing defaults.

Each stage times one engine choice at fixed shapes on the attached GPU
and prints one JSON line per measurement (``{"stage": ..., ...}``);
``--out FILE`` also appends them to FILE. Times are the best of
``--reps`` warm runs, each ending in ``block_until_ready``; the first
call's wall time is reported as ``compile_s`` (trace + compile + one run).

Stages (``--stages``, comma separated):

  env        card name and power limit, toolchain for the native oracle
  chunk      chunked-engine column width 512 / 1024 / 2048 at the clustered
             short-read bucket shape (B=640, 320 x 3072) and 256 x 2048^2,
             local scores (the shapes ``aligntools calibrate`` uses)
  crossover  chunked vs vmap engine at batch 1..512 on 2048^2, at the
             clustered bucket 640 x 320 x 3072, at 32 and 256 x 8192^2 and
             at 1 x 1328 x 114688, local scores
  unroll     row-scan unroll 1 vs 8 for both engines
  walk       rows path: device walk vs pointer pull + host walk, global,
             at the clustered short-read bucket shape
  regimes    the XLA engine that owns each former hand-kernel regime:
             fit -s 1024 x (257 x 33733), fit -s 1 x (1327 x 114491) rows,
             local 32 x 8192^2 scores, banded global 64 x 4096 W=128 rows

Run: ``python benchmarks/bringup.py --stages chunk,crossover``. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

_OUT = None


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if _OUT:
        with open(_OUT, "a") as f:
            f.write(line + "\n")


def timed(fn, reps):
    """(first-call seconds, best warm seconds) of ``fn()``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return first, best


def rand_planes(rng, B, m, n):
    alpha = np.frombuffer(b"ACGT", np.uint8)
    return rng.choice(alpha, (B, m)), rng.choice(alpha, (B, n))


def _bench(stage, engine, B, m, n, reps, chunk=None, **extra):
    from aligntools_tpu.engine.autotune import bench

    c, s = bench(engine, B, m, n, chunk=chunk, reps=reps)
    emit({"stage": stage, "engine": engine, "B": B, "m": m, "n": n,
          "chunk": chunk, **extra, "compile_s": c, "s": s,
          "gcups": B * m * n / s / 1e9})


def stage_env(_):
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    tools = {}
    for exe in ("g++", "make", "nvcc"):
        r = subprocess.run(["which", exe], capture_output=True, text=True)
        tools[exe] = r.stdout.strip() or None
    z = subprocess.run(["g++", "-x", "c++", "-E", "-"],
                       input="#include <zlib.h>\n", capture_output=True,
                       text=True)
    mods = {}
    for mod in ("pytest", "xdist", "hypothesis"):
        try:
            __import__(mod)
            mods[mod] = True
        except ImportError:
            mods[mod] = False
    emit({"stage": "env", "nvidia_smi": smi, "tools": tools,
          "zlib_h": z.returncode == 0, "modules": mods,
          "jax": jax.__version__, "device": str(jax.devices()[0]),
          "kind": jax.devices()[0].device_kind,
          "memory_stats": {k: v for k, v in
                           (jax.devices()[0].memory_stats() or {}).items()
                           if k in ("bytes_limit", "bytes_in_use")}})


def stage_chunk(reps):
    from aligntools_tpu.engine.autotune import CHUNK_SHAPES, CHUNK_WIDTHS

    for B, m, n in CHUNK_SHAPES:
        for w in CHUNK_WIDTHS:
            _bench("chunk", "chunked", B, m, n, reps, chunk=w)


def stage_crossover(reps):
    """Chunked vs vmap by batch at 2048^2, and at the two long-row
    shapes that once had hand kernels (32 x 8192^2, 1 x 1327 x 114688)."""
    shapes = [(B, 2048, 2048) for B in (1, 8, 32, 64, 128, 256, 512)]
    shapes += [(640, 320, 3072), (32, 8192, 8192), (256, 8192, 8192),
               (1, 1328, 114688)]
    for B, m, n in shapes:
        for engine in ("chunked", "vmap"):
            _bench("crossover", engine, B, m, n, reps)


def stage_unroll(reps):
    import jax

    from aligntools_tpu.engine import scan as sc

    orig = sc._unroll
    try:
        for u in (1, 8):
            sc._unroll = lambda u=u: u
            jax.clear_caches()
            _bench("unroll", "chunked", 640, 320, 3072, reps, unroll=u)
            _bench("unroll", "vmap", 32, 2048, 2048, reps, unroll=u)
    finally:
        sc._unroll = orig
        jax.clear_caches()


def _pairs(rng, B, m, n):
    q, t = rand_planes(rng, B, m, n)
    return [(bytes(a), bytes(b)) for a, b in zip(q, t)]


def stage_walk(reps):
    """Device walk vs full pointer pull + host walk on one rows bucket of
    the vmap fill (the chunked fill's packed layout has only the device
    walk), plus the production route for reference."""
    from aligntools_tpu import batch as bt

    rng = np.random.default_rng(1)
    pairs = _pairs(rng, 640, 320, 3072)
    orig = bt._walk_on_device
    try:
        for walk, engine in (("device", "xla"), ("host", "xla"),
                             ("device", "auto")):
            bt._walk_on_device = lambda w=walk: w == "device"
            c, s = timed(lambda: bt.align_batch("global", pairs,
                                                engine=engine), reps)
            emit({"stage": "walk", "walk": walk, "engine": engine,
                  "B": 640, "m": 320, "n": 3072, "compile_s": c, "s": s})
    finally:
        bt._walk_on_device = orig


def stage_regimes(reps):
    from aligntools_tpu import batch as bt
    from aligntools_tpu.engine.banded import banded_align_batch
    from aligntools_tpu.params import AlignParams

    rng = np.random.default_rng(2)
    p = AlignParams()
    fit = AlignParams(match=2, mismatch=-2)
    sites4 = [[5000, 12000, 20000, 30000]]
    cases = []
    reads = _pairs(rng, 1024, 257, 33733)
    gene = reads[0][1]
    reads = [(q, gene) for q, _ in reads]
    cases.append(("fit_s_rows_1024x257x33733", 1024 * 257 * 33733,
                  lambda: bt.align_batch("fit", reads, fit,
                                         sites_list=sites4 * 1024)))
    big = _pairs(rng, 1, 1327, 114491)
    sites28 = [list(range(3000, 114491, 4000))[:28]]
    cases.append(("fit_s_rows_1x1327x114491", 1327 * 114491,
                  lambda: bt.align_batch("fit", big, fit,
                                         sites_list=sites28)))
    sq = _pairs(rng, 32, 8192, 8192)
    cases.append(("local_scores_32x8192", 32 * 8192 * 8192,
                  lambda: bt.batch_scores("local", sq, p)))
    bd = _pairs(rng, 64, 4096, 4096)
    cases.append(("banded_rows_64x4096_w128", 64 * 4096 * 257,
                  lambda: banded_align_batch("global", bd, 128, p)))
    for name, cells, fn in cases:
        c, s = timed(fn, reps)
        emit({"stage": "regimes", "case": name, "compile_s": c, "s": s,
              "gcups": cells / s / 1e9})


STAGES = {"env": stage_env, "chunk": stage_chunk,
          "crossover": stage_crossover, "unroll": stage_unroll,
          "walk": stage_walk, "regimes": stage_regimes}


def main(argv=None) -> int:
    global _OUT
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stages", default="env,chunk,crossover,unroll")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ns = ap.parse_args(argv)
    _OUT = ns.out
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bringup: needs a GPU, JAX backend is "
                 f"{jax.default_backend()!r}")
    for st in ns.stages.split(","):
        t0 = time.perf_counter()
        STAGES[st](ns.reps)
        print(f"# stage {st}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
