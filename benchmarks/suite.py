"""Benchmark suite: GCUPS across modes x engines x shapes on the GPU.

Writes one JSON object per case to stdout and, unless ``--no-write``, a
markdown table to benchmarks/RESULTS.md (its head table; sections after
the first ``## `` heading are kept). Every case runs in this one process,
so one process holds the card. Fixed-shape cases time score-only fills
(best of three warm calls, each ending in ``block_until_ready``); rows and
clustered cases time the production ``align_batch``/``batch_scores``
calls end to end. Exits non-zero when JAX finds no GPU. Run:

    python benchmarks/suite.py [--only=flat|fit|banded|rows]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def _best(fn, reps=3):
    jax.block_until_ready(fn())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def _params(B, m):
    ps = np.zeros((B, 6), np.float32)
    ps[:, :5] = [1, -2, -5, -1, -10]
    ps[:, 5] = m
    return jnp.asarray(ps)


def bench_flat(mode, engine, B, L, rng):
    from aligntools_tpu import batch as bt
    from aligntools_tpu.engine import chunked as ck

    q = rng.choice(ALPHA, (B, L))
    t = rng.choice(ALPHA, (B, L))
    ns, ps = jnp.asarray(np.full(B, L, np.int32)), _params(B, L)
    if engine == "chunked":
        qi, ti = jnp.asarray(q.astype(np.int32)), jnp.asarray(
            t.astype(np.int32))

        def fn():
            return ck.chunked_scores(mode, qi, ti, ns, ck.default_chunk(),
                                     params=ps, decaying_params=True)
    else:
        qu, tu = jnp.asarray(q), jnp.asarray(t)

        def fn():
            out = bt._vfill(qu, tu, mode, L, False, ns, ps)
            return out if mode == "edit" else out[0]
    per = _best(fn)
    return B * L * L / per / 1e9, per


def bench_fit_jump(engine, B, m, L, rng):
    from aligntools_tpu import batch as bt
    from aligntools_tpu.engine import chunked as ck

    q = rng.choice(ALPHA, (B, m))
    t = rng.choice(ALPHA, (B, L))
    allow = np.ones((B, L), bool)
    allow[:, :: max(L // 16, 1)] = False  # some junction columns
    allow = jnp.asarray(allow)
    ns, ps = jnp.asarray(np.full(B, L, np.int32)), _params(B, m)
    if engine == "chunked":
        qi, ti = jnp.asarray(q.astype(np.int32)), jnp.asarray(
            t.astype(np.int32))

        def fn():
            return ck.chunked_fit_scores(True, qi, ti, allow, ns,
                                         ck.default_chunk(), params=ps)
    else:
        qu, tu = jnp.asarray(q), jnp.asarray(t)

        def fn():
            return bt._vfill_fit(qu, tu, allow, L, True, False, ns, ps)[0]
    per = _best(fn)
    return B * m * L / per / 1e9, per


def bench_banded(mode, B, L, W, rng):
    """GCUPS over band cells only (B * L * (2W+1)), the work done."""
    from aligntools_tpu.engine.banded import banded_fill

    V = 2 * W + 1
    qs = jnp.asarray(rng.choice(ALPHA, (B, L)).astype(np.int32))
    te = np.full((B, W + L + V + 1), -2, np.int32)
    te[:, W: W + L] = rng.choice(ALPHA, (B, L))
    te = jnp.asarray(te)
    ns = jnp.asarray(np.full(B, L, np.int32))
    ps = np.zeros((B, 8), np.float32)
    ps[:, :5] = [1, -2, -5, -1, -10]
    ps[:, 5] = L
    ps = jnp.asarray(ps)
    fill = jax.jit(jax.vmap(
        lambda q, t, n, p: banded_fill(mode, q, t, n, W, p)[0]))
    per = _best(lambda: fill(qs, te, ns, ps))
    return B * L * V / per / 1e9, per


def _pairs(rng, B, m, n):
    return [(rng.choice(ALPHA, m).tobytes(), rng.choice(ALPHA, n).tobytes())
            for _ in range(B)]


def bench_rows(mode, B, m, n, rng):
    """align_batch with rows, end to end; spec-checked on a sample."""
    from aligntools_tpu.batch import align_batch
    from aligntools_tpu.params import AlignParams
    from aligntools_tpu.spec import engine as spec

    pairs = _pairs(rng, B, m, n)
    p = AlignParams()
    res = align_batch(mode, pairs, p)
    per = _best(lambda: align_batch(mode, pairs, p))
    fn = getattr(spec, f"spec_{mode}")
    for k in (0, B - 1):
        w = fn(*pairs[k], p)
        assert (res[k].score, res[k].row1, res[k].row2) == (
            w.score, w.row1, w.row2), k
    return B * m * n / per / 1e9, per


def bench_clustered(mode, P, rng):
    """batch_scores on the clustered read set, true cells / wall seconds."""
    from aligntools_tpu.batch import batch_scores
    from aligntools_tpu.params import AlignParams
    from aligntools_tpu.utils.synth import clustered_pairs

    pairs = clustered_pairs(P, seed=int(rng.integers(1 << 30)))
    p = AlignParams()
    per = _best(lambda: batch_scores(mode, pairs, p))
    return sum(len(q) * len(t) for q, t in pairs) / per / 1e9, per


def cases(only):
    out = []
    if only in (None, "flat"):
        for mode in ("local", "global", "overlap", "edit"):
            for B, L in ((256, 2048), (32, 8192)):
                for eng in ("chunked", "vmap"):
                    out.append((f"{mode} {B}x{L}^2", eng,
                                lambda r, a=(mode, eng, B, L):
                                bench_flat(*a, r)))
    if only in (None, "fit"):
        for eng, B, m, L in (("chunked", 128, 512, 32768),
                             ("vmap", 128, 512, 32768),
                             ("vmap", 8, 2048, 131072)):
            out.append((f"fit+jump {B}x({m}x{L})", eng,
                        lambda r, a=(eng, B, m, L): bench_fit_jump(*a, r)))
    if only in (None, "banded"):
        for mode in ("global", "edit"):
            for B, L, W in ((64, 4096, 128), (256, 1024, 64)):
                out.append((f"banded {mode} {B}x{L} W={W}", "vmap",
                            lambda r, a=(mode, B, L, W): bench_banded(*a, r)))
    if only in (None, "rows"):
        for mode, B, m, n in (("global", 256, 2048, 2048),
                              ("local", 256, 2048, 2048),
                              ("overlap", 256, 2048, 2048),
                              ("global", 64, 8192, 8192),
                              ("fit", 64, 512, 32768)):
            out.append((f"FULL rows {mode} {B}x({m}x{n})", "auto",
                        lambda r, a=(mode, B, m, n): bench_rows(*a, r)))
        for mode, P in (("local", 512), ("global", 2048)):
            out.append((f"clustered scores {mode} P={P} (true cells)",
                        "auto", lambda r, a=(mode, P): bench_clustered(*a, r)))
    return out


def main():
    only = None
    for a in sys.argv[1:]:
        if a.startswith("--only="):
            only = a.split("=", 1)[1]
            if only not in ("flat", "fit", "banded", "rows"):
                sys.exit(f"unknown --only={only}")
    if jax.default_backend() != "gpu":
        sys.exit(f"suite: needs a GPU, JAX backend is "
                 f"{jax.default_backend()!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    rng = np.random.default_rng(0)
    rows = []
    for name, eng, run in cases(only):
        try:
            g, per = run(rng)
            row = {"case": name, "engine": eng, "gcups": round(g, 2),
                   "ms": round(per * 1e3, 2)}
        except Exception as err:  # one failed case must not lose the rest
            row = {"case": name, "engine": eng,
                   "error": f"{type(err).__name__}: {str(err)[:200]}"}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if "--no-write" in sys.argv:
        return
    lines = [
        "# Benchmark results",
        "",
        f"Card: `{card}` (name, power limit); written by "
        "benchmarks/suite.py. Fixed-shape cases time score-only fills; "
        "FULL rows and clustered cases time the production calls end to "
        "end (clustered counts true cells). Banded GCUPS count band cells.",
        "",
        "| case | engine | GCUPS | ms |",
        "|---|---|---|---|",
    ]
    for r in rows:
        lines.append(f"| {r['case']} | {r['engine']} | "
                     f"{r.get('gcups', 'ERR')} | {r.get('ms', '-')} |")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "RESULTS.md")
    tail = ""
    if os.path.exists(out):
        with open(out) as f:
            old = f.read()
        k = old.find("\n## ")
        if k >= 0:
            tail = old[k:]
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n" + tail)


if __name__ == "__main__":
    main()
