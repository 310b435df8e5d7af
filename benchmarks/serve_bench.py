"""Serve-mode benchmark: warm request throughput through the serve loop.

Drives ``aligntools_tpu.serve.handle_request`` (the exact code behind
``aligntools serve``) with repeated requests over the clustered
synthetic read set (same distribution as bench.py's pad-efficiency
workload): one cold request (compiles + warms every cache), then N warm
requests; the number is the best warm request, with the spread across
warm requests reported so run-to-run stability is visible.

    python benchmarks/serve_bench.py [--pairs 20000]
        [--mode local] [--rows] [--warm 3] [--update-results]

Prints one JSON line; --update-results rewrites the "## Serve mode"
section of benchmarks/RESULTS.md from the jsonl sidecar.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.e2e import synth_fasta  # noqa: E402

MARK = "## Serve mode"


class _Null:
    def write(self, s):
        return len(s)

    def flush(self):
        pass


def main():
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"serve_bench: needs a GPU, JAX backend is "
                 f"{jax.default_backend()!r}")
    P, mode, rows, warm = 20_000, "local", False, 3
    update = "--update-results" in sys.argv
    argv = sys.argv[1:]
    for i, a in enumerate(argv):
        if a == "--pairs":
            P = int(argv[i + 1])
        elif a == "--mode":
            mode = argv[i + 1]
        elif a == "--rows":
            rows = True
        elif a == "--warm":
            warm = int(argv[i + 1])

    tmp = tempfile.mkdtemp(prefix="alignserve")
    fa = os.path.join(tmp, "pairs.fa")
    cells = synth_fasta(fa, P)

    from aligntools_tpu.serve import handle_request

    req = f"{mode} {fa}" + ("" if rows else " scores_only")
    out = _Null()

    t0 = time.perf_counter()
    assert handle_request(req, out)
    cold_s = time.perf_counter() - t0

    times = []
    for _ in range(warm):
        t0 = time.perf_counter()
        assert handle_request(req, out)
        times.append(time.perf_counter() - t0)

    best = min(times)
    rec = {
        "bench": "serve",
        "mode": mode,
        "rows": rows,
        "pairs": P,
        "cold_s": round(cold_s, 2),
        "warm_s_best": round(best, 3),
        "warm_s_all": [round(t, 3) for t in times],
        "spread": round((max(times) - min(times)) / best, 3),
        "pairs_per_sec": round(P / best, 1),
        "effective_gcups": round(cells / best / 1e9, 2),
    }
    import jax

    rec["platform"] = jax.devices()[0].platform
    rec["device"] = jax.devices()[0].device_kind
    print(json.dumps(rec), flush=True)
    if update:
        _update_results(rec)


def _update_results(rec):
    here = os.path.dirname(os.path.abspath(__file__))
    side = os.path.join(here, "serve_rows.jsonl")
    with open(side, "a") as f:
        f.write(json.dumps(rec) + "\n")
    latest: dict = {}
    with open(side) as f:
        for ln in f:
            r = json.loads(ln)
            latest[(r["mode"], r["rows"], r["pairs"])] = r
    path = os.path.join(here, "RESULTS.md")
    with open(path) as f:
        text = f.read()
    if MARK in text:
        head, _, tail = text.partition(MARK)
        # section ends at the next "## " heading or EOF
        nxt = tail.find("\n## ")
        text = head.rstrip() + "\n" + (tail[nxt + 1:] if nxt >= 0 else "")
        text = text.rstrip() + "\n"
    lines = [
        "",
        MARK,
        "",
        "`serve.handle_request` (the `aligntools serve` loop) on the "
        "clustered read set (m~300, n~3000): one cold request, then "
        "best of N warm requests (all warm times shown).",
        "",
        "| mode | rows | pairs | cold s | warm s (best) | warm s (all) "
        "| pairs/s | eff GCUPS |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in latest.values():
        lines.append(
            f"| {r['mode']} | {'yes' if r['rows'] else 'score'} | "
            f"{r['pairs']} | {r['cold_s']} | {r['warm_s_best']} | "
            f"{r['warm_s_all']} | {r['pairs_per_sec']} | "
            f"{r['effective_gcups']} |"
        )
    with open(path, "w") as f:
        f.write(text.rstrip() + "\n" + "\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
