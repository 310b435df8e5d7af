#!/usr/bin/env python3
"""Smoke run of aligntools on the GPU, checked against the oracles.

Drives the user entry points once at deployment sizes, in one process:
``aligntools batch`` through ``cli.main([...])`` (an explicit argv, so the
single-pair native exec never fires) and ``serve.serve(stream_in,
stream_out)``. Every input is generated from ``--seed`` into a temporary
directory. Each phase prints its pairs, cells, seconds, compilations, the
engine each bucket was routed to, and its oracle comparison; any failure
exits non-zero. Oracles, at zero tolerance (scores equal, rows
byte-identical): the native C++ CLI (``native/aligntools_cli``, built
here by ``make -C native``) and the NumPy spec engine (spec/engine.py).

One card (the default):

  1. clustered short reads: 20,000 pairs, m ~ 300 +-20%, n ~ 3,000 +-25%;
     ``batch local --scores-only``, then ``batch global`` with rows
  2. the reference's deployment: 1,024 reads of ~257 bp fitted into one
     33,733-column gene with 4 junctions, ``batch fit -m 2 -u -2 -s``
  3. one tmp.fa-shaped pair, 1,327 x 114,491 with 28 junctions, fit -s
  4. small batch, long rows: 32 pairs of 8,192^2, local scores
  5. banded rows: ``--band 128`` on 64 global pairs of 4,096
  6. ``serve``: scores, rows and fit-with-sites requests
  7. the tests marked ``gpu`` (pytest, in this process)

``--cards 4``: only the multi-card paths, on four cards: phase 1's scores
with ``batch --sharded`` (against the same engine on one card and the
native oracle), phase 3's pair through ``seqpar_align`` on a 4-card
("seq",) mesh, and a 2x2 ("data", "seq") mesh (against one card).

Before the last line it prints the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``. With no GPU, or outside the
repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NATIVE = os.path.join(REPO, "native", "aligntools_cli")
ALPHA = np.frombuffer(b"ACGT", np.uint8)
FIT_OPTS = ["-m", "2", "-u", "-2"]


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- preflight


def preflight(cards: int):
    """The jax module and the devices, or exit non-zero without a result."""
    if not os.path.isdir(os.path.join(REPO, "aligntools_tpu")):
        sys.exit("chip_smoke: the aligntools package is not beside this "
                 "script; run it from a checkout of the repository")
    sys.path.insert(0, REPO)
    import jax

    try:
        devs = jax.devices()
    except RuntimeError as err:
        sys.exit(f"chip_smoke: JAX finds no accelerator: {err}")
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX finds no GPU (platform "
                 f"{devs[0].platform!r}); this script measures the card")
    if len(devs) < cards:
        sys.exit(f"chip_smoke: --cards {cards} needs {cards} GPUs, JAX "
                 f"sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    )
    for line in smi.stdout.strip().splitlines()[:cards]:
        log(f"card: {line}")
    r = subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0 or not os.access(NATIVE, os.X_OK):
        sys.exit(f"chip_smoke: native oracle build failed:\n"
                 f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    return jax


class CompileCounter:
    """JAX compile-cache events and backend compile time, per phase."""

    def __init__(self, jax):
        from jax import monitoring

        self.ev = {}
        self.secs = 0.0
        monitoring.register_event_listener(self._event)
        monitoring.register_event_duration_secs_listener(self._dur)

    def _event(self, name, **_):
        self.ev[name] = self.ev.get(name, 0) + 1

    def _dur(self, name, secs, **_):
        if name.endswith("backend_compile_duration"):
            self.secs += secs

    def snapshot(self):
        return dict(self.ev), self.secs

    def since(self, snap):
        ev0, s0 = snap
        d = {k.rsplit("/", 1)[-1]: v - ev0.get(k, 0)
             for k, v in self.ev.items() if v - ev0.get(k, 0)}
        return {"compiles": d.get("compile_requests_use_cache", 0),
                "cache_hits": d.get("cache_hits", 0),
                "cache_misses": d.get("cache_misses", 0),
                "compile_s": round(self.secs - s0, 3)}


# ---------------------------------------------------------------- inputs


def rand_seq(rng, n):
    return rng.choice(ALPHA, n)


def mutate(rng, s, sub, indels):
    """Substitutions at rate ``sub`` plus ``indels`` single-base indels."""
    s = s.copy()
    k = rng.random(len(s)) < sub
    s[k] = rng.choice(ALPHA, int(k.sum()))
    for _ in range(indels):
        pos = int(rng.integers(0, len(s)))
        if rng.random() < 0.5 and len(s) > 1:
            s = np.delete(s, pos)
        else:
            s = np.insert(s, pos, rng.choice(ALPHA))
    return s


def clustered(rng, count):
    """Short reads in windows: m ~ lognormal(300, 0.2), n ~ lognormal(3000,
    0.25); each read is a mutated slice of its window when it fits."""
    ms = np.exp(rng.normal(np.log(300), 0.2, count)).astype(int)
    ns = np.exp(rng.normal(np.log(3000), 0.25, count)).astype(int)
    pairs = []
    for m, n in zip(ms, ns):
        t = rand_seq(rng, max(1, int(n)))
        m = max(1, int(m))
        if m < len(t):
            a = int(rng.integers(0, len(t) - m + 1))
            q = mutate(rng, t[a:a + m], 0.03, 2)
        else:
            q = rand_seq(rng, m)
        pairs.append((q.tobytes(), t.tobytes()))
    return pairs


def gene_reads(rng, count, read_len, gene_len, n_sites):
    """A gene with ``n_sites`` junctions and reads drawn from it, some
    spliced across an intron (exon tail + next exon head)."""
    gene = rand_seq(rng, gene_len)
    sites = sorted(int(x) for x in rng.choice(
        np.arange(read_len * 2, gene_len - read_len * 2), n_sites,
        replace=False))
    reads = []
    for _ in range(count):
        m = max(50, int(rng.normal(read_len, read_len * 0.05)))
        if rng.random() < 0.5:
            k = int(rng.integers(0, n_sites - 1))
            cut = int(rng.integers(10, m - 10))
            seg = np.concatenate([gene[sites[k] - cut:sites[k]],
                                  gene[sites[k + 1]:sites[k + 1] + m - cut]])
        else:
            a = int(rng.integers(0, gene_len - m))
            seg = gene[a:a + m]
        reads.append(mutate(rng, seg, 0.02, 1).tobytes())
    return gene.tobytes(), sites, reads


def similar_pairs(rng, count, length, sub, indels):
    out = []
    for _ in range(count):
        t = rand_seq(rng, length)
        out.append((mutate(rng, t, sub, indels).tobytes(), t.tobytes()))
    return out


def write_pairs(path, pairs, comment=None):
    with open(path, "wb") as f:
        for k, (q, t) in enumerate(pairs):
            tc = b" " + comment if comment else b""
            f.write(b">q%d\n%s\n>t%d%s\n%s\n" % (k, q, k, tc, t))


def sites_comment(sites):
    return "|".join(str(s) for s in sites).encode()


# ---------------------------------------------------------------- running


def run_batch(argv):
    """``aligntools batch ARGV`` in this process; (stderr report, secs)."""
    from aligntools_tpu.cli import main

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = main(["aligntools", "batch", *argv])
    secs = time.perf_counter() - t0
    check(rc == 0, f"batch {' '.join(argv)} exited {rc}: "
                   f"{err.getvalue()[-1500:]}")
    return err.getvalue(), secs


def read_tsv(path, with_rows):
    rows = []
    with open(path, "rb") as f:
        for line in f:
            parts = line.rstrip(b"\n").split(b"\t")
            rows.append((parts[2].decode(), parts[3], parts[4]) if with_rows
                        else (parts[2].decode(),))
    return rows


def routes(report):
    m = re.search(r"routes ([^,)]+)", report)
    return m.group(1) if m else "none"


def native_one(tmp, mode, opts, q, t, comment, tag):
    path = os.path.join(tmp, f"oracle_{tag}.fa")
    with open(path, "wb") as f:
        tc = b" " + comment if comment else b""
        f.write(b">q\n%s\n>t%s\n%s\n" % (q, tc, t))
    r = subprocess.run([NATIVE, mode, *opts, path], capture_output=True,
                       timeout=900)
    check(r.returncode == 0, f"native {mode} failed: {r.stderr[-300:]}")
    lines = r.stdout.split(b"\n")
    if comment:
        lines = lines[1:]  # fit -s echoes the junction comment first
    score = lines[0].decode().removeprefix("score=")
    return score, lines[1], lines[2]


def native_check(tmp, mode, opts, pairs, got, idx, comment=None,
                 with_rows=True):
    """Native CLI on pairs ``idx`` vs the batch output ``got``."""
    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        want = list(ex.map(
            lambda k: native_one(tmp, mode, opts, *pairs[k], comment, k),
            idx))
    for k, w in zip(idx, want):
        g = got[k]
        check(g[0] == w[0], f"{mode} pair {k}: score {g[0]} != native {w[0]}")
        if with_rows:
            check(g[1:] == w[1:], f"{mode} pair {k}: rows differ from native")
    return len(idx)


def spec_check(mode, params, pairs, got, idx, sites=None, with_rows=True):
    from aligntools_tpu.spec import engine as spec

    fn = getattr(spec, f"spec_{mode}")
    for k in idx:
        q, t = pairs[k]
        w = fn(q, t, params, sites) if mode == "fit" else fn(q, t, params)
        check(f"{w.score:.6f}" == got[k][0],
              f"{mode} pair {k}: score {got[k][0]} != spec {w.score}")
        if with_rows:
            check(got[k][1:] == (w.row1, w.row2),
                  f"{mode} pair {k}: rows differ from spec")
    return len(idx)


def sample(rng, n, k):
    return sorted(int(x) for x in rng.choice(n, min(n, k), replace=False))


def report_phase(name, pairs, secs, report, comp, oracle):
    cells = sum(len(q) * len(t) for q, t in pairs)
    log(json.dumps({"phase": name, "pairs": len(pairs), "cells": cells,
                    "seconds": round(secs, 3),
                    "gcups": round(cells / secs / 1e9, 3),
                    "routes": routes(report), **comp, "oracle": oracle}))


# ---------------------------------------------------------------- phases


def phase_clustered(ctx):
    from aligntools_tpu.params import AlignParams

    pairs = clustered(ctx.rng, 20_000)
    fa = os.path.join(ctx.tmp, "clustered.fa")
    write_pairs(fa, pairs)
    ctx.files["clustered"] = (fa, pairs)
    idx = sample(ctx.rng, len(pairs), 64)
    sidx = idx[:8]
    p = AlignParams()
    out = os.path.join(ctx.tmp, "p1_local.tsv")
    snap = ctx.cc.snapshot()
    # the default --chunk-size: two pipeline chunks of 10,000 pairs
    rep, secs = run_batch(["local", "--scores-only", "--out", out, fa])
    got = read_tsv(out, False)
    check(len(got) == len(pairs), "phase 1 local: row count")
    nat = native_check(ctx.tmp, "local", [], pairs, got, idx,
                       with_rows=False)
    sp = spec_check("local", p, pairs, got, sidx, with_rows=False)
    report_phase("1 local scores", pairs, secs, rep, ctx.cc.since(snap),
                 f"native {nat}/{nat} spec {sp}/{sp} equal")
    ctx.outputs["p1_local"] = got
    out = os.path.join(ctx.tmp, "p1_global.tsv")
    snap = ctx.cc.snapshot()
    rep, secs = run_batch(["global", "--out", out, fa])
    got = read_tsv(out, True)
    check(len(got) == len(pairs), "phase 1 global: row count")
    nat = native_check(ctx.tmp, "global", [], pairs, got, idx)
    sp = spec_check("global", p, pairs, got, sidx)
    report_phase("1 global rows", pairs, secs, rep, ctx.cc.since(snap),
                 f"native {nat}/{nat} spec {sp}/{sp} identical")
    ctx.outputs["p1_global"] = got


def _fit_phase(ctx, name, key, count, read_len, gene_len, n_sites, n_spec):
    from aligntools_tpu.params import AlignParams

    gene, sites, reads = gene_reads(ctx.rng, count, read_len, gene_len,
                                    n_sites)
    pairs = [(r, gene) for r in reads]
    comment = sites_comment(sites)
    fa = os.path.join(ctx.tmp, f"{key}.fa")
    write_pairs(fa, pairs, comment)
    ctx.files[key] = (fa, pairs)
    out = os.path.join(ctx.tmp, f"{key}.tsv")
    snap = ctx.cc.snapshot()
    rep, secs = run_batch(["fit", *FIT_OPTS, "-s", "--out", out, fa])
    got = read_tsv(out, True)
    check(len(got) == len(pairs), f"phase {name}: row count")
    nat = native_check(ctx.tmp, "fit", FIT_OPTS + ["-s"], pairs, got,
                       list(range(len(pairs))), comment)
    sp = spec_check("fit", AlignParams(match=2, mismatch=-2), pairs, got,
                    list(range(n_spec)), sites)
    report_phase(name, pairs, secs, rep, ctx.cc.since(snap),
                 f"native {nat}/{nat} spec {sp}/{sp} identical")
    ctx.outputs[key] = got


def phase_gene(ctx):
    _fit_phase(ctx, "2 fit -s rows, reads into one gene", "gene", 1024, 257,
               33_733, 4, 4)


def phase_tmpfa(ctx):
    _fit_phase(ctx, "3 fit -s rows, tmp.fa-shaped pair", "tmpfa", 1, 1327,
               114_491, 28, 1)


def phase_long(ctx):
    from aligntools_tpu.params import AlignParams

    pairs = similar_pairs(ctx.rng, 32, 8192, 0.1, 20)
    fa = os.path.join(ctx.tmp, "long.fa")
    write_pairs(fa, pairs)
    ctx.files["long"] = (fa, pairs)
    out = os.path.join(ctx.tmp, "long.tsv")
    snap = ctx.cc.snapshot()
    rep, secs = run_batch(["local", "--scores-only", "--out", out, fa])
    got = read_tsv(out, False)
    nat = native_check(ctx.tmp, "local", [], pairs, got,
                       list(range(len(pairs))), with_rows=False)
    sp = spec_check("local", AlignParams(), pairs, got, [0],
                    with_rows=False)
    report_phase("4 local scores, 32 x 8192^2", pairs, secs, rep,
                 ctx.cc.since(snap), f"native {nat}/{nat} spec {sp}/{sp} "
                 f"equal")
    ctx.outputs["long"] = got


def phase_banded(ctx):
    from aligntools_tpu.params import AlignParams

    pairs = similar_pairs(ctx.rng, 64, 4096, 0.05, 16)
    fa = os.path.join(ctx.tmp, "banded.fa")
    write_pairs(fa, pairs)
    ctx.files["banded"] = (fa, pairs)
    out = os.path.join(ctx.tmp, "banded.tsv")
    snap = ctx.cc.snapshot()
    rep, secs = run_batch(["global", "--band", "128", "--out", out, fa])
    got = read_tsv(out, True)
    nat = native_check(ctx.tmp, "global", [], pairs, got,
                       list(range(len(pairs))))
    sp = spec_check("global", AlignParams(), pairs, got, [0, 1])
    report_phase("5 banded global rows, W=128", pairs, secs, rep,
                 ctx.cc.since(snap), f"native {nat}/{nat} spec {sp}/{sp} "
                 f"identical (unbanded oracles)")
    ctx.outputs["banded"] = got


def phase_serve(ctx):
    """Three requests on inputs of phases 2, 4 and 5, whose shapes are
    compiled already; each answer must equal that phase's checked rows
    (phase 5's banded rows equal the unbanded native oracle's)."""
    from aligntools_tpu.serve import serve

    reqs = [
        (f"local {ctx.files['long'][0]} scores_only\n",
         ctx.outputs["long"], False),
        (f"global {ctx.files['banded'][0]}\n", ctx.outputs["banded"], True),
        (f"fit {ctx.files['gene'][0]} m=2 u=-2 sites\n", ctx.outputs["gene"],
         True),
    ]
    stream_in = io.StringIO("".join(r for r, _, _ in reqs) + "quit\n")
    stream_out = io.StringIO()
    snap = ctx.cc.snapshot()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        rc = serve(stream_in, stream_out)
    secs = time.perf_counter() - t0
    check(rc == 0, f"serve returned {rc}")
    blocks, cur = [], []
    for line in stream_out.getvalue().split("\n"):
        if line.startswith("#error"):
            raise SmokeError(f"serve: {line}")
        if line.startswith("#done"):
            blocks.append((cur, line))
            cur = []
        elif line:
            cur.append(line)
    check(len(blocks) == len(reqs), f"serve: {len(blocks)} #done lines for "
                                    f"{len(reqs)} requests")
    for (req, want, with_rows), (rows, done) in zip(reqs, blocks):
        check(f"pairs={len(want)}" in done, f"serve: {done!r}")
        for k, (line, w) in enumerate(zip(rows, want)):
            f = line.encode("latin-1").split(b"\t")
            got = (f[2].decode(), f[3], f[4]) if with_rows else \
                (f[2].decode(),)
            check(got == w, f"serve {req.split()[0]} pair {k}: differs "
                            f"from the batch output")
        check(len(rows) == len(want), f"serve {req.split()[0]}: row count")
    pairs = [p for key in ("long", "banded", "gene")
             for p in ctx.files[key][1]]
    report_phase("6 serve: scores, rows, fit with sites", pairs, secs, "",
                 ctx.cc.since(snap),
                 "3/3 requests #done, identical to the oracle-checked rows")


def phase_gpu_tests(ctx):
    import pytest

    os.environ["ALIGNTOOLS_TEST_GPU"] = "1"

    class Count:
        def __init__(self):
            self.n = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.n[report.outcome] = self.n.get(report.outcome, 0) + 1

    cnt = Count()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = pytest.main(["-q", "-p", "no:xdist", "-p", "no:cacheprovider",
                          "-o", "addopts=", "-m", "gpu",
                          os.path.join(REPO, "tests")], plugins=[cnt])
    secs = time.perf_counter() - t0
    check(rc == 0 and cnt.n["failed"] == 0 and cnt.n["skipped"] == 0
          and cnt.n["passed"] > 0,
          f"gpu tests: rc {rc} {cnt.n}\n{out.getvalue()[-3000:]}")
    log(json.dumps({"phase": "7 tests marked gpu", "seconds": round(secs, 3),
                    **cnt.n}))


PHASES = {"1": phase_clustered, "2": phase_gene, "3": phase_tmpfa,
          "4": phase_long, "5": phase_banded, "6": phase_serve,
          "7": phase_gpu_tests}


# ---------------------------------------------------------------- 4 cards


def cards4(ctx, jax):
    from jax.sharding import Mesh

    from aligntools_tpu.batch import batch_scores
    from aligntools_tpu.parallel.mesh import batch_scores_sharded, make_mesh
    from aligntools_tpu.parallel.seqpar import (seqpar_align,
                                                seqpar_batch_scores)
    from aligntools_tpu.params import AlignParams

    p = AlignParams()
    pairs = clustered(ctx.rng, 20_000)
    fa = os.path.join(ctx.tmp, "clustered.fa")
    write_pairs(fa, pairs)
    out = os.path.join(ctx.tmp, "sharded.tsv")
    snap = ctx.cc.snapshot()
    rep, secs = run_batch(["local", "--scores-only", "--sharded", "--out",
                           out, fa])
    comp = ctx.cc.since(snap)
    got = read_tsv(out, False)
    check(len(got) == len(pairs), "sharded: row count")
    one = batch_scores_sharded("local", pairs, p, make_mesh(1))
    check([f"{s:.6f}" for s in one] == [g[0] for g in got],
          "sharded over 4 cards differs from the same engine on one card")
    nat = native_check(ctx.tmp, "local", [], pairs, got,
                       sample(ctx.rng, len(pairs), 64), with_rows=False)
    report_phase("4-card dp: batch local --scores-only --sharded", pairs,
                 secs, rep, comp, f"== 1-card sharded engine on all "
                 f"{len(pairs)}; native {nat}/{nat} equal")

    gene, sites, reads = gene_reads(ctx.rng, 1, 1327, 114_491, 28)
    q, t = reads[0], gene
    fp = AlignParams(match=2, mismatch=-2)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("seq",))
    snap = ctx.cc.snapshot()
    t0 = time.perf_counter()
    r = seqpar_align("fit", q, t, fp, sites=sites, mesh=mesh)
    secs = time.perf_counter() - t0
    w = native_one(ctx.tmp, "fit", FIT_OPTS + ["-s"], q, t,
                   sites_comment(sites), "seqpar")
    check((f"{r.score:.6f}", r.row1, r.row2) == w,
          "seqpar_align rows differ from native")
    report_phase("4-card sp: seqpar_align fit -s, 1327 x 114491",
                 [(q, t)], secs, "", ctx.cc.since(snap),
                 "native 1/1 identical")

    sub = pairs[:256]
    mesh2 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                 ("data", "seq"))
    snap = ctx.cc.snapshot()
    t0 = time.perf_counter()
    got2 = seqpar_batch_scores("local", sub, p, mesh=mesh2)
    secs = time.perf_counter() - t0
    want2 = batch_scores("local", sub, p)
    check(np.array_equal(got2, want2), "2x2 dp x sp differs from one card")
    report_phase("4-card dp x sp: 2x2 mesh, local scores", sub, secs, "",
                 ctx.cc.since(snap), f"== one card on all {len(sub)}")


# ---------------------------------------------------------------- main


class Ctx:
    def __init__(self, seed, tmp, cc):
        self.rng = np.random.default_rng(seed)
        self.tmp = tmp
        self.cc = cc
        self.files = {}
        self.outputs = {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, choices=[1, 4], default=1)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="one-card phases to run (default: all)")
    ns = ap.parse_args(argv)
    jax = preflight(ns.cards)
    from aligntools_tpu import backend

    backend.enable_compile_cache()
    log(f"compile cache: {backend.cache_dir()} "
        f"({'on' if backend._cache_enabled else 'off'})")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    ctx = Ctx(ns.seed, tmp, CompileCounter(jax))
    t0 = time.perf_counter()
    try:
        if ns.cards == 4:
            cards4(ctx, jax)
        else:
            for ph in ns.phases.split(","):
                PHASES[ph](ctx)
    except SmokeError as err:
        print(f"chip_smoke: FAIL: {err}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"total {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
