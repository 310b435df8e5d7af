"""Native C++ single-pair CLI (native/aligntools_cli) — the 7th engine.

Differential surface tests: the binary must be byte-identical on stdout
to BOTH the reference binary (modulo its stray fit debug line) and the
Python CLI, across fixtures, randomized micro pairs (tie-heavy alphabets
and degenerate params included), junction-site cases, and the error
surfaces. Also covers the exec fast path in cli.main().
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDIR = os.path.join(REPO, "native")
BINARY = os.path.join(NDIR, "aligntools_cli")


@pytest.fixture(scope="session")
def native_cli():
    r = subprocess.run(["make", "-C", NDIR, "aligntools_cli"],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        pytest.skip(f"native CLI build failed: {r.stderr[-300:]}")
    return BINARY


def run_native(native_cli, args, timeout=300):
    r = subprocess.run([native_cli, *args], capture_output=True,
                       text=True, timeout=timeout)
    return r.stdout, r.stderr, r.returncode


def run_python_cli(args, timeout=600):
    env = dict(os.environ)
    env["ALIGNTOOLS_NO_NATIVE"] = "1"  # force the Python engines
    code = (
        "from aligntools_tpu.cli import main; import sys\n"
        f"sys.exit(main({['aligntools', *args]!r}))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=REPO)
    return r.stdout, r.stderr, r.returncode


STRAY = "asDAsdaSDAsdasDAsdaSD"


@pytest.mark.parametrize("args,fixture", [
    (["global"], "global"),
    (["local"], "local"),
    (["edit"], "edit"),
    (["edit", "-u", "1"], "edit"),
    (["overlap"], "global"),
    (["fit", "-m", "2", "-u", "-2", "-s"], "fit"),
    (["global", "-m", "3", "-u", "-1", "-o", "-2", "-e", "-2"], "global"),
])
def test_fixture_parity_vs_reference(native_cli, ref_run, fixtures,
                                     args, fixture):
    fa = fixtures[fixture]
    ref_lines, ref_rc = ref_run(*args, fa)
    ref_lines = [ln for ln in ref_lines if ln != STRAY]
    out, err, rc = run_native(native_cli, [*args, fa])
    assert rc == 0 == ref_rc
    assert out.splitlines() == ref_lines
    assert "[main] Version:" in err and "[main] CMD:" in err


def _write_pair(tmp_path, q, t, comment2=None):
    fa = tmp_path / "p.fa"
    hdr2 = ">t" if comment2 is None else f">t {comment2}"
    fa.write_text(f">q\n{q}\n{hdr2}\n{t}\n")
    return str(fa)


def test_micro_differential_vs_reference_and_python(
        native_cli, ref_binary, tmp_path):
    """Randomized micros: tie-heavy binary alphabet, homopolymers, and
    degenerate params — native == reference (sane rows) == python CLI."""
    rng = np.random.default_rng(11)
    alphabets = ["ACGT", "AB", "AAAB"]
    params = [[], ["-m", "1", "-u", "1", "-o", "-1", "-e", "-1"],
              ["-m", "2", "-u", "-3", "-o", "-4", "-e", "-2"]]
    checked = 0
    for k in range(36):
        al = alphabets[k % 3]
        pa = params[k % len(params)]
        mode = ["global", "local", "fit", "overlap", "edit"][k % 5]
        ql = int(rng.integers(1, 30))
        tl = int(rng.integers(ql if mode == "fit" else 1, 40))
        q = "".join(rng.choice(list(al), ql))
        t = "".join(rng.choice(list(al), max(tl, ql if mode == "fit" else 1)))
        fa = _write_pair(tmp_path, q, t)
        args = [mode, *([] if mode == "overlap" else pa), fa]
        r = subprocess.run([ref_binary, mode,
                            *([] if mode == "overlap" else pa), fa],
                           capture_output=True, text=True, timeout=60)
        if r.returncode != 0:
            continue  # reference strrev crash: QUIRKS.md policy
        ref_lines = [ln for ln in r.stdout.splitlines() if ln != STRAY]
        nout, _, nrc = run_native(native_cli, args)
        pout, _, prc = run_python_cli(args)
        assert nrc == prc == 0, (mode, k, q, t)
        # native vs python CLI: ALWAYS byte-identical
        assert nout == pout, (mode, k, q, t, pa)
        # vs reference: score line always; rows when self-consistent
        assert nout.splitlines()[0] == ref_lines[0], (mode, k, q, t)
        checked += 1
    assert checked >= 25


def test_fit_sites_parity(native_cli, ref_run, tmp_path):
    """Junction echo + inverted enum-bool gating through the native path."""
    q = "ACGTACGTAC"
    t = "TTTTACGTACGTACTTTTTACGTACGTACTTT"
    fa = _write_pair(tmp_path, q, t, comment2="4|14|19")
    ref_lines, rc0 = ref_run("fit", "-s", fa)
    ref_lines = [ln for ln in ref_lines if ln != STRAY]
    out, _, rc = run_native(native_cli, ["fit", "-s", fa])
    assert rc == 0 == rc0
    assert out.splitlines() == ref_lines
    assert out.splitlines()[0] == "4|14|19"  # raw comment echo


def test_error_surfaces(native_cli, tmp_path):
    # missing file
    out, err, rc = run_native(native_cli, ["global", "/nonexistent/x.fa"])
    assert rc == 255 and "FATAL ERROR" in err
    # >2 records
    fa3 = tmp_path / "three.fa"
    fa3.write_text(">a\nAC\n>b\nGT\n>c\nAA\n")
    out, err, rc = run_native(native_cli, ["local", str(fa3)])
    assert rc == 255 and "more than 2 sequences" in err
    # <2 records
    fa1 = tmp_path / "one.fa"
    fa1.write_text(">a\nAC\n")
    out, err, rc = run_native(native_cli, ["local", str(fa1)])
    assert rc == 255 and "fail to read sequence" in err
    # fit with longer first sequence
    fa = _write_pair(tmp_path, "ACGTACGT", "ACG")
    out, err, rc = run_native(native_cli, ["fit", str(fa)])
    assert rc == 255 and "shorter than the second" in err
    # -s without a comment on record 2
    fa = _write_pair(tmp_path, "ACG", "ACGT")
    out, err, rc = run_native(native_cli, ["fit", "-s", str(fa)])
    assert rc == 255 and "junction sites" in err
    # usage: no args / no file / unknown command
    out, err, rc = run_native(native_cli, [])
    assert rc == 1 and "Usage:" in err
    out, err, rc = run_native(native_cli, ["global"])
    assert rc == 1 and "Options:" in err
    out, err, rc = run_native(native_cli, ["bogus"])
    assert rc == 1 and "unrecognized command 'bogus'" in err
    # unknown option
    out, err, rc = run_native(native_cli, ["global", "-z", "x.fa"])
    assert rc == 1


def test_exec_fast_path_fires(native_cli, tmp_path):
    """cli.main() with argv=None (the console-script entry) execs the
    native binary for single-pair modes; library callers passing argv
    explicitly never do."""
    fa = _write_pair(tmp_path, "ACGTAC", "ACGTTAC")
    env = dict(os.environ)
    env["ALIGNTOOLS_NATIVE_CLI_MARK"] = "1"
    env.pop("ALIGNTOOLS_NO_NATIVE", None)
    code = (
        "import sys\n"
        f"sys.argv = ['aligntools', 'global', {str(fa)!r}]\n"
        "from aligntools_tpu.cli import main\n"
        "sys.exit(main())\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-500:]
    assert "[native-cli]" in r.stderr  # the exec actually happened
    assert r.stdout.startswith("score=")
    # explicit argv: Python path, no exec marker
    code2 = (
        "from aligntools_tpu.cli import main\n"
        f"rc = main(['aligntools', 'global', {str(fa)!r}])\n"
        "import sys; sys.exit(rc)\n"
    )
    r2 = subprocess.run([sys.executable, "-c", code2], capture_output=True,
                        text=True, timeout=300, env=env, cwd=REPO)
    assert r2.returncode == 0
    assert "[native-cli]" not in r2.stderr
    assert r2.stdout == r.stdout  # same bytes either way


def test_exec_skipped_on_device_override(native_cli, tmp_path):
    """ALIGNTOOLS_DEVICE=gpu requests the jax engines for a single pair;
    the native CPU fast path must step aside."""
    fa = _write_pair(tmp_path, "ACGTAC", "ACGTTAC")
    env = dict(os.environ)
    env["ALIGNTOOLS_NATIVE_CLI_MARK"] = "1"
    env["ALIGNTOOLS_DEVICE"] = "cpu"  # explicit cpu: exec is fine
    code = (
        "import sys\n"
        f"sys.argv = ['aligntools', 'global', {str(fa)!r}]\n"
        "from aligntools_tpu.cli import main\n"
        "sys.exit(main())\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0 and "[native-cli]" in r.stderr
    env["ALIGNTOOLS_DEVICE"] = "gpu"  # device request: no exec (the jax
    env["JAX_PLATFORMS"] = "cpu"      # engines then find no GPU here)
    r2 = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=300, env=env, cwd=REPO)
    assert "[native-cli]" not in r2.stderr


def test_gz_and_fastq_inputs(native_cli, tmp_path):
    """gz + FASTQ pairs flow through the native parser identically to the
    Python CLI (kseq.h accepted both; alignment scores only use seq)."""
    import gzip

    gz = tmp_path / "p.fa.gz"
    with gzip.open(gz, "wt") as f:
        f.write(">q\nACGTAC\nGT\n>t\nACGTTACGT\n")
    nout, _, nrc = run_native(native_cli, ["global", str(gz)])
    pout, _, prc = run_python_cli(["global", str(gz)])
    assert nrc == prc == 0
    assert nout == pout and nout.startswith("score=")

    fq = tmp_path / "p.fq"
    fq.write_text("@q\nACGTAC\n+\nIIIIII\n@t\nACGTTACGT\n+\nIIIIIIIII\n")
    nout, _, nrc = run_native(native_cli, ["local", str(fq)])
    pout, _, prc = run_python_cli(["local", str(fq)])
    assert nrc == prc == 0
    assert nout == pout


def test_empty_seq1_edge(native_cli, ref_binary, tmp_path):
    """2 records with an empty first sequence: the reference accepts it
    (read_kstring only dies on <2 records), yielding score=-9 global /
    -inf local / 0 overlap / 4 edit on this input — all three
    implementations must agree, including the '%f' of -inf."""
    fa = tmp_path / "e.fa"
    fa.write_text(">q\n>t\nACGT\n")
    for mode, first in (("global", "score=-9.000000"),
                        ("local", "score=-inf"),
                        ("overlap", "0.000000"),
                        ("edit", "edit_distance=4")):
        r = subprocess.run([ref_binary, mode, str(fa)], capture_output=True,
                           text=True, timeout=60)
        nout, _, nrc = run_native(native_cli, [mode, str(fa)])
        pout, _, prc = run_python_cli([mode, str(fa)])
        assert nrc == prc == r.returncode == 0, mode
        assert nout == pout, mode
        assert nout.splitlines()[0] == first == r.stdout.splitlines()[0], mode
