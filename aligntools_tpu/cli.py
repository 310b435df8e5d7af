"""``aligntools`` CLI — byte-parity result surface over the batched engine.

Mirrors the reference binary's observable stdout exactly (reference:
src/main.c:6-57 and the five main_* entry points in src/alignment.h):

  * ``score=%f`` + two gapped rows for global/local/fit (alignment.h:509);
  * overlap prints a BARE ``%f`` (no prefix; alignment.h:1000);
  * ``edit_distance=%d`` (alignment.h:345);
  * ``fit -s`` echoes the second record's raw header comment before the
    results (alignment.h:249);
  * success epilogue ``[main] Version:`` / ``[main] CMD:`` on stderr
    (main.c:49-55); unknown command -> ``[main] unrecognized command``.

Documented divergences (QUIRKS.md): options work for ``overlap`` (the
reference reads argv[1] as the filename and dies on any option,
alignment.h:994); fit's stray debug line is not printed; ``edit -e`` takes
a value and is ignored (the reference's optstring makes it UB).

POSIX option parsing (options before the file argument) via getopt, like
the reference.
"""

from __future__ import annotations

import getopt
import os
import sys

from aligntools_tpu.params import AlignParams
from aligntools_tpu.version import __version__

_OPTSTRINGS = {
    # reference optstrings: global/local/overlap "m:u:o:e:j:s" with -j/-s
    # falling through to `default: return 1` (alignment.h:481-488) — we
    # reject them with a message instead of silently; fit takes them for
    # real; edit's broken "m:u:o:e" is fixed to take a (dead) -e value.
    "global": "m:u:o:e:",
    "local": "m:u:o:e:",
    "fit": "m:u:o:e:j:s",
    "overlap": "m:u:o:e:",
    "edit": "m:u:o:e:",
}


def _usage() -> int:
    sys.stderr.write(
        "\n"
        "Program: aligntools (batched pairwise sequence alignment)\n"
        f"Version: {__version__}\n\n"
        "Usage:   aligntools <command> [options] <target.fa>\n\n"
        "Command: global     global (Needleman-Wunsch) alignment, affine gap\n"
        "         local      local (Smith-Waterman) alignment, affine gap\n"
        "         fit        fit alignment, affine gap plus junction jump state\n"
        "         overlap    overlap alignment\n"
        "         edit       edit distance\n"
        "         batch      many-pair batched pipeline (TSV output)\n"
        "         serve      long-lived request loop (stdin/stdout)\n"
        "\n"
    )
    return 1


def _sub_usage(mode: str, p: AlignParams) -> int:
    lines = [
        "",
        f"Usage:   aligntools {mode} [options] <target.fa>",
        "",
        f"Options: -m INT   score for a match [{p.match}]",
        f"         -u INT   mismatch penalty [{p.mismatch}]",
        f"         -o INT   gap open penalty [{p.gap_open}]",
        f"         -e INT   gap extension penalty [{p.gap_extend}]",
    ]
    if mode == "fit":
        lines += [
            f"         -j INT   jump penalty [{p.jump}]",
            "         -s       junction sites from 2nd record's comment",
        ]
    sys.stderr.write("\n".join(lines) + "\n\n")
    return 1


def _c_atoi(s: str) -> int:
    from aligntools_tpu.io.fasta import c_atoi

    return c_atoi(s.encode())


def run_subcommand(mode: str, args: list[str]) -> int:
    p = AlignParams()
    try:
        opts, rest = getopt.getopt(args, _OPTSTRINGS[mode])
    except getopt.GetoptError as err:
        sys.stderr.write(f"aligntools {mode}: {err}\n")
        return 1
    use_sites = False
    for flag, val in opts:
        if flag == "-m":
            p = p.replace(match=_c_atoi(val))
        elif flag == "-u":
            p = p.replace(mismatch=_c_atoi(val))
        elif flag == "-o":
            p = p.replace(gap_open=_c_atoi(val))
        elif flag == "-e":
            p = p.replace(gap_extend=_c_atoi(val))
        elif flag == "-j":
            p = p.replace(jump=_c_atoi(val))
        elif flag == "-s":
            use_sites = True
    if not rest:
        return _sub_usage(mode, p)
    path = rest[-1]
    from aligntools_tpu.api import align_file

    try:
        result, pair = align_file(mode, path, p, use_sites)
    except (OSError, ValueError, RuntimeError) as err:
        sys.stderr.write(f"FATAL ERROR: {err}\n")
        return 255  # the reference's die() -> exit(-1) (alignment.h:69-79)
    out = sys.stdout
    if mode == "edit":
        out.write(f"edit_distance={result}\n")
    elif mode == "overlap":
        out.write(f"{result.score:.6f}\n")
        out.write(result.row1.decode("latin-1") + "\n")
        out.write(result.row2.decode("latin-1") + "\n")
    else:
        if mode == "fit" and use_sites and pair.comment2 is not None:
            # junction echo line (alignment.h:249)
            out.write(pair.comment2.decode("latin-1") + "\n")
        out.write(f"score={result.score:.6f}\n")
        out.write(result.row1.decode("latin-1") + "\n")
        out.write(result.row2.decode("latin-1") + "\n")
    return 0


def _select_backend() -> None:
    """Pin the JAX platform to ALIGNTOOLS_DEVICE (default ``cpu``).

    Single-pair runs default to the CPU: one pair is the reference's
    one-pair-per-invocation usage, which the NumPy spec engine (or the
    native binary) answers in milliseconds, while a device costs seconds
    of start-up and compilation. ``batch``/``serve`` call this only when
    ALIGNTOOLS_DEVICE or ``--device`` asks for a platform; otherwise they
    take the GPU (backend.require_device)."""
    want = os.environ.get("ALIGNTOOLS_DEVICE", "cpu")
    if "jax" in sys.modules:
        import jax

        jax.config.update("jax_platforms", want)
    else:
        # pin via the environment so a LATER jax import agrees, without
        # paying the ~2 s import now: the NumPy spec path (the default
        # single-pair route) never imports jax at all
        os.environ["JAX_PLATFORMS"] = want


def run_batch(args: list[str]) -> int:
    """``aligntools batch <mode> [options] <pairs.fa>`` — many-pair
    throughput pipeline (records pair consecutively; TSV to stdout).
    New surface (no reference analog); long options, argparse."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="aligntools batch",
        description="Batched alignment of many pairs on the GPU",
    )
    ap.add_argument("mode", choices=["global", "local", "fit", "overlap",
                                     "edit"])
    ap.add_argument("fasta", help="multi-record FASTA/Q (gz ok); records "
                                  "pair up consecutively (q1,t1,q2,t2,...)")
    ap.add_argument("-m", type=int, default=1, help="match score")
    ap.add_argument("-u", type=int, default=-2, help="mismatch penalty")
    ap.add_argument("-o", type=int, default=-5, help="gap open penalty")
    ap.add_argument("-e", type=int, default=-1, help="gap extension penalty")
    ap.add_argument("-j", type=int, default=-10, help="fit jump penalty")
    ap.add_argument("-s", action="store_true",
                    help="fit: junction sites from each target's comment")
    ap.add_argument("--scores-only", action="store_true",
                    help="skip traceback (fastest)")
    ap.add_argument("--cigar", action="store_true",
                    help="emit CIGAR strings instead of gapped rows")
    ap.add_argument("--band", type=int, default=None, metavar="W",
                    help="banded fill, O(m*W) work: full rows (or scores "
                         "with --scores-only); exact when the optimal "
                         "path stays in band")
    ap.add_argument("--sharded", action="store_true",
                    help="data-parallel over all devices (scores only)")
    ap.add_argument("--chunk-size", type=int, default=16384,
                    help="most pairs per pipeline chunk (the input is "
                         "split into chunks of near-equal size)")
    ap.add_argument("--out", metavar="FILE", default=None,
                    help="output TSV file owned by the pipeline (with "
                         "--resume: crash-atomic chunk checkpointing)")
    ap.add_argument("--resume", metavar="MANIFEST",
                    help="chunk manifest for checkpoint/resume")
    ap.add_argument("--trace", metavar="DIR",
                    help="write a jax.profiler trace to DIR")
    ap.add_argument("--engine", choices=["auto", "xla"], default="auto",
                    help="auto: chunked engine from its batch crossover up; "
                         "xla: always the vmapped row-scan engine")
    ap.add_argument("--device", default=None,
                    help="jax platform, e.g. cpu (default: the GPU)")
    ns = ap.parse_args(args)
    if ns.device:
        os.environ["ALIGNTOOLS_DEVICE"] = ns.device
        _select_backend()
    from aligntools_tpu.params import AlignParams
    from aligntools_tpu.pipeline import run_pipeline

    p = AlignParams(match=ns.m, mismatch=ns.u, gap_open=ns.o,
                    gap_extend=ns.e, jump=ns.j)
    if ns.resume and not ns.out:
        sys.stderr.write(
            "[batch] note: --resume without --out checkpoints chunk "
            "completion only; add --out FILE for crash-atomic output\n"
        )
    try:
        counters = run_pipeline(
            ns.mode, ns.fasta, p, use_sites=ns.s,
            scores_only=ns.scores_only, sharded=ns.sharded,
            chunk_size=ns.chunk_size, manifest_path=ns.resume,
            out_path=ns.out,
            trace_dir=ns.trace, engine=ns.engine, cigar=ns.cigar,
            band=ns.band,
        )
    except (OSError, ValueError, RuntimeError) as err:
        sys.stderr.write(f"FATAL ERROR: {err}\n")
        return 255
    counters.report()
    return 0


def _maybe_exec_native(argv: list[str]) -> None:
    """Single-pair cold-start fast path: replace this process with the
    native C++ CLI (native/aligntools_cli — byte-identical surface,
    differentially tested in tests/test_native_cli.py) when it can be
    (re)built. ~4 ms per invocation vs ~0.4 s through the numpy spec
    engine — the one workload where interpreter start dominates.

    Mirrors native.py's freshness policy: `make -q` first, so a stale
    binary is rebuilt rather than trusted. Any failure (no make, no
    toolchain, installed without the native tree, ALIGNTOOLS_NO_NATIVE)
    falls through silently to the Python engines."""
    if os.environ.get("ALIGNTOOLS_NO_NATIVE"):
        return
    if os.environ.get("ALIGNTOOLS_DEVICE", "cpu") != "cpu":
        return  # explicit device request: route through the jax engines
    ndir = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir, "native"
    )
    binary = os.path.join(ndir, "aligntools_cli")
    if not os.path.isdir(ndir):
        return
    import subprocess

    try:
        q = subprocess.run(
            ["make", "-C", ndir, "-q", "aligntools_cli"],
            capture_output=True, timeout=60,
        )
        if q.returncode != 0:  # out of date (1) — rebuild; errors fall out
            b = subprocess.run(
                ["make", "-C", ndir, "aligntools_cli"],
                capture_output=True, timeout=300,
            )
            if b.returncode != 0:
                return
        if os.access(binary, os.X_OK):
            sys.stderr.flush()
            sys.stdout.flush()
            os.execv(binary, argv)
    except Exception:
        return  # exec itself raising OSError also lands here


def main(argv: list[str] | None = None) -> int:
    # The native exec only fires when we own the process (console-script
    # entry, argv is None); in-process library/test callers pass argv
    # explicitly and must get the Python path, not an execv.
    own_process = argv is None
    argv = list(sys.argv if argv is None else argv)
    if own_process and len(argv) >= 2 and argv[1] in _OPTSTRINGS:
        _maybe_exec_native(argv)
    if len(argv) >= 2 and argv[1] == "serve":
        # long-lived request loop (keeps compiled kernels warm); targets
        # the GPU like `batch`
        if os.environ.get("ALIGNTOOLS_DEVICE"):
            _select_backend()
        from aligntools_tpu.backend import NoDeviceError, require_device

        try:
            require_device()
        except NoDeviceError as err:
            sys.stderr.write(f"FATAL ERROR: {err}\n")
            return 255
        from aligntools_tpu.serve import serve

        return serve()
    if len(argv) >= 2 and argv[1] == "calibrate":
        # one-time engine-crossover measurement on the attached device;
        # cached per device kind next to the compile cache
        from aligntools_tpu.engine.autotune import calibrate

        try:
            calibrate(force="--force" in argv[2:])
        except RuntimeError as err:
            sys.stderr.write(f"FATAL ERROR: {err}\n")
            return 255
        return 0
    if len(argv) >= 2 and argv[1] == "batch":
        # batch targets the GPU; ALIGNTOOLS_DEVICE / --device override
        if os.environ.get("ALIGNTOOLS_DEVICE"):
            _select_backend()
        return run_batch(argv[2:])
    _select_backend()
    if len(argv) < 2:
        return _usage()
    mode = argv[1]
    if mode not in _OPTSTRINGS:
        sys.stderr.write(f"[main] unrecognized command '{mode}'\n")
        return 1
    ret = run_subcommand(mode, argv[2:])
    if ret == 0:
        sys.stderr.write(f"[main] Version: {__version__}\n")
        sys.stderr.write("[main] CMD: " + " ".join(argv) + "\n")
    return ret


if __name__ == "__main__":
    sys.exit(main())
