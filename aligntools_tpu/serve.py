"""Serving mode: a long-lived process answering alignment requests.

Cold CLI invocations pay per-process XLA compilation for every bucket
shape they touch; a server process pays once and answers later requests
with warm executables (its throughput on the H100 is in PERF.md). The
protocol is deliberately trivial — newline-delimited
requests on stdin, TSV results + a terminator on stdout — so anything
(a shell loop, a socket wrapper, a workflow manager) can drive it:

    <mode> <pairs.fa> [m=INT] [u=INT] [o=INT] [e=INT] [j=INT]
           [chunk=INT] [sites] [scores_only] [cigar] [sharded]

Per request the TSV rows stream out, followed by one line:

    #done pairs=N seconds=S gcups=G

or ``#error <message>`` (the server keeps running; a malformed request
never kills it). EOF or a ``quit`` line ends the loop.
"""

from __future__ import annotations

import shlex
import sys

from aligntools_tpu.params import AlignParams
from aligntools_tpu.pipeline import run_pipeline


def handle_request(line: str, out) -> bool:
    """Process one request line; returns False on quit. Writes results and
    the #done/#error terminator to ``out``."""
    parts = shlex.split(line.strip())
    if not parts:
        return True
    if parts[0] in ("quit", "exit"):
        return False
    try:
        if len(parts) < 2:
            raise ValueError("expected: <mode> <pairs.fa> [options]")
        mode, path = parts[0], parts[1]
        kv = {}
        flags = set()
        for tok in parts[2:]:
            if "=" in tok:
                k, v = tok.split("=", 1)
                kv[k] = int(v)
            else:
                flags.add(tok)
        params = AlignParams(
            match=kv.get("m", 1), mismatch=kv.get("u", -2),
            gap_open=kv.get("o", -5), gap_extend=kv.get("e", -1),
            jump=kv.get("j", -10),
        )
        counters = run_pipeline(
            mode, path, params,
            use_sites="sites" in flags,
            scores_only="scores_only" in flags,
            sharded="sharded" in flags,
            cigar="cigar" in flags,
            chunk_size=kv.get("chunk", 16384),
            out=out,
        )
        out.write(
            f"#done pairs={counters.pairs} "
            f"seconds={counters.seconds:.3f} "
            f"gcups={counters.gcups:.2f}\n"
        )
    except Exception as err:  # a bad request must not kill the server
        out.write(f"#error {err}\n")
    if hasattr(out, "flush"):
        out.flush()
    return True


def serve(stream_in=None, stream_out=None) -> int:
    stream_in = stream_in if stream_in is not None else sys.stdin
    stream_out = stream_out if stream_out is not None else sys.stdout
    sys.stderr.write("[aligntools] serving; one request per line, "
                     "'quit' or EOF ends\n")
    for line in stream_in:
        if not handle_request(line, stream_out):
            break
    return 0
