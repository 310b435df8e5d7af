"""Benchmark: batched Smith-Waterman (local, affine) GCUPS on the GPU.

Prints ONE JSON line:
  {"metric": "sw_affine_gcups", "value": N, "unit": "GCUPS", ...}

Workload: B x (m=n=L) random DNA pairs (default 256 x 2048^2, env
BENCH_BATCH / BENCH_LEN), local mode, score-only, on the engine that
engine/select.py routes the bucket to. The time is the best of three warm
fills, each ending in ``block_until_ready``. The line names the device it
ran on and the bucketing pad efficiency of the clustered read workload.
Exits non-zero, printing no result, when JAX finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np


def main() -> int:
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench: needs a GPU, JAX backend is "
                 f"{jax.default_backend()!r}")
    from aligntools_tpu.batch import _bucket_keys, bucket_len
    from aligntools_tpu.engine import autotune
    from aligntools_tpu.engine.select import use_chunked

    B = int(os.environ.get("BENCH_BATCH", "256"))
    L = int(os.environ.get("BENCH_LEN", "2048"))
    eng = "chunked" if use_chunked(B, L) else "vmap"
    first, per_fill = autotune.bench(eng, B, L, L)
    gcups = B * L * L / per_fill / 1e9

    # bucketing pad efficiency on the length-clustered read workload
    # (m ~ 300 +- 20%, n ~ 3000 +- 25%): true cells / padded cells under
    # the greedy partition, with the pow2 ladder's ratio alongside
    rng = np.random.default_rng(0)
    wms = np.exp(rng.normal(np.log(300), 0.2, 512)).astype(int)
    wns = np.exp(rng.normal(np.log(3000), 0.25, 512)).astype(int)
    wl = [(b"A" * int(a), b"A" * int(bb)) for a, bb in zip(wms, wns)]
    true_cells = sum(len(q) * len(t) for q, t in wl)
    pad_fine = sum(mp * np_ for mp, np_ in _bucket_keys(wl, 64, 128))
    pad_pow2 = sum(
        bucket_len(len(q), 64, 1) * bucket_len(len(t), 128, 1)
        for q, t in wl
    )
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "sw_affine_gcups",
        "value": round(gcups, 2),
        "unit": "GCUPS",
        "pairs_per_sec": round(B / per_fill, 1),
        "fill_ms": round(per_fill * 1e3, 3),
        "first_call_s": round(first, 3),
        "batch": B,
        "shape": [L, L],
        "engine": eng,
        "pad_efficiency": round(true_cells / pad_fine, 3),
        "pad_efficiency_pow2": round(true_cells / pad_pow2, 3),
        "platform": dev.platform,
        "device": dev.device_kind,
        "count": len(jax.devices()),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"[bench] {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
