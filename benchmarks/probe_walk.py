"""Probe the device-walk cost model: per-step scan cost, cols-pull cost,
and the collect protocol's round trips, on the live backend.

    python benchmarks/probe_walk.py

Prints one JSON line per (B, m_pad, n_pad, n_steps) point:
  walk_s    — dispatch _walk_affine + pull ONLY the scalar block (count/err/
              fi/fj/fstate): walk compute + one small round trip
  pull_s    — additional wall to pull the stacked (n_steps, B) cols pair
  per_step_us, pull_gbps — derived

Every timing below ends in an np.asarray pull; warm call only (the
first call compiles), best of 3.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from aligntools_tpu.engine.device_tb import _walk_affine

    rng = np.random.default_rng(0)
    cases = [
        # (B, m_pad, n_pad) — local e2e bucket, fit long-target bucket
        (512, 384, 4096),
        (64, 512, 32768),
        (256, 2048, 2048),
    ]
    for B, m_pad, n_pad in cases:
        ptrs = jnp.asarray(
            rng.integers(0, 256, (B, m_pad, n_pad + 1), dtype=np.uint8)
        )
        qs = jnp.asarray(rng.integers(65, 69, (B, m_pad), dtype=np.int32))
        ts = jnp.asarray(rng.integers(65, 69, (B, n_pad), dtype=np.int32))
        state0 = jnp.ones(B, jnp.int32)
        i0 = jnp.full(B, m_pad, jnp.int32)
        j0 = jnp.full(B, n_pad, jnp.int32)
        full = m_pad + n_pad + 1
        for n_steps in sorted({256, 1024, 4096, full}):
            if n_steps > full:
                continue
            walk_best = pull_best = float("inf")
            for it in range(4):  # iter 0 = compile, discarded
                t0 = time.perf_counter()
                res = _walk_affine(
                    True, n_steps, 0, False, True, 0, ptrs, qs, ts,
                    state0, i0, j0,
                )
                c1, c2, cnt, fi, fj, fst, err = res
                sc = np.asarray(jnp.stack(
                    [x.astype(jnp.int32) for x in (cnt, fi, fj, fst)]
                ))
                t1 = time.perf_counter()
                both = np.asarray(jnp.stack([c1, c2]))
                t2 = time.perf_counter()
                if it:
                    walk_best = min(walk_best, t1 - t0)
                    pull_best = min(pull_best, t2 - t1)
            nbytes = 2 * n_steps * B
            print(json.dumps({
                "B": B, "m_pad": m_pad, "n_pad": n_pad,
                "n_steps": n_steps,
                "walk_s": round(walk_best, 4),
                "pull_s": round(pull_best, 4),
                "per_step_us": round(walk_best / n_steps * 1e6, 2),
                "pull_mb": round(nbytes / 1e6, 2),
                "pull_gbps": round(nbytes / pull_best / 1e9, 3),
                "backend": jax.devices()[0].platform,
            }), flush=True)


if __name__ == "__main__":
    main()
