"""CLI byte-parity: `aligntools` stdout vs the reference binary's stdout
on the shipped fixtures and micro cases (SURVEY.md §4 golden table).

The reference's stray fit debug line (alignment.h:602) is a documented
divergence (QUIRKS.md) and is stripped from the reference output before
comparison; overlap is invoked on the reference WITHOUT options (its
argv[1] bug makes any option fatal)."""

import pytest

from aligntools_tpu.cli import main

DEBUG_LINE = "asDAsdaSDAsdasDAsdaSD"


def _ours(capsys, *args):
    rc = main(["aligntools", *args])
    out = capsys.readouterr().out
    return out.splitlines(), rc


def _theirs(ref_run, *args):
    lines, rc = ref_run(*args)
    return [ln for ln in lines if ln != DEBUG_LINE], rc


@pytest.mark.parametrize(
    "args",
    [
        ("global", "{d}/test_global.fa"),
        ("global", "-m", "1", "-u", "-1", "-o", "-4", "-e", "-1", "{d}/test_global.fa"),
        ("local", "{d}/test_local.fa"),
        ("local", "-m", "2", "-u", "-2", "-o", "-5", "-e", "-2", "{d}/test_local.fa"),
        ("edit", "{d}/test_edit.fa"),
        ("edit", "-u", "1", "{d}/test_edit.fa"),
        ("overlap", "{d}/test_global.fa"),
        ("fit", "{d}/test_fit.fa"),
    ],
)
def test_fixture_parity(capsys, ref_run, fixtures, args):
    d = fixtures["global"].rsplit("/", 1)[0]
    args = [a.format(d=d) for a in args]
    ours, rc_o = _ours(capsys, *args)
    theirs, rc_t = _theirs(ref_run, *args)
    assert rc_o == rc_t == 0
    assert ours == theirs


def test_fit_sites_parity(capsys, ref_run, fixtures):
    args = ["fit", "-m", "2", "-u", "-2", "-s", fixtures["fit"]]
    ours, rc_o = _ours(capsys, *args)
    theirs, rc_t = _theirs(ref_run, *args)
    assert rc_o == rc_t == 0
    assert ours == theirs
    assert ours[0] == "1036|3395|23045|24611"  # junction echo line
    assert ours[1] == "score=494.000000"


def test_micro_parity(capsys, ref_run, tmp_path):
    cases = [
        ("global", "ACGT", "ACGT"),
        ("global", "ACGT", "AGT"),
        ("local", "GATTACA", "GCATGCU"),
        ("overlap", "ACGT", "AGT"),  # empty-alignment j_max=0 case
    ]
    for k, (mode, q, t) in enumerate(cases):
        fa = tmp_path / f"m{k}.fa"
        fa.write_text(f">q\n{q}\n>t\n{t}\n")
        ours, rc_o = _ours(capsys, mode, str(fa))
        theirs, rc_t = _theirs(ref_run, mode, str(fa))
        assert rc_o == rc_t == 0, (mode, q, t)
        assert ours == theirs, (mode, q, t)


def test_edit_micro(capsys, ref_run, tmp_path):
    fa = tmp_path / "e.fa"
    fa.write_text(">q\nGATTACA\n>t\nGCATGCU\n")
    ours, _ = _ours(capsys, "edit", "-u", "1", str(fa))
    theirs, _ = _theirs(ref_run, "edit", "-u", "1", str(fa))
    assert ours == theirs == ["edit_distance=4"]


def test_unknown_command(capsys):
    rc = main(["aligntools", "bogus"])
    assert rc == 1
    assert "unrecognized command" in capsys.readouterr().err


def test_usage(capsys):
    assert main(["aligntools"]) == 1
    assert "Usage" in capsys.readouterr().err


def test_missing_file(capsys):
    rc = main(["aligntools", "global", "/nonexistent/x.fa"])
    assert rc == 255
    assert "FATAL ERROR" in capsys.readouterr().err


def test_overlap_options_divergence(capsys, tmp_path):
    """Documented divergence: options WORK for overlap in our CLI."""
    fa = tmp_path / "o.fa"
    fa.write_text(">q\nAAAA\n>t\nGGAAAA\n")
    ours, rc = _ours(capsys, "overlap", "-m", "3", str(fa))
    assert rc == 0
    # AAAA vs GGAA: 2 mismatches (-2 each) + 2 matches (+3 each) = 2; matches
    # spec_overlap (overlap has no free t-prefix: row0 is -inf, only col0=0).
    assert ours[0] == "2.000000"


def test_cold_single_pair_cli_is_jax_free(tmp_path):
    """The spec-routed single-pair CLI must never import jax (the import
    costs ~2.2 s; cold floor now ~0.4 s). Run in a fresh interpreter,
    then assert jax was never pulled in."""
    import os
    import subprocess
    import sys

    fa = tmp_path / "p.fa"
    fa.write_text(">q\nACGTACGT\n>t\nACGTTACGT\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    code = (
        "import sys\n"
        "from aligntools_tpu.cli import main\n"
        f"rc = main(['aligntools', 'global', {str(fa)!r}])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax imported on the spec path'\n"
        "print('JAXFREE OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-800:]
    assert "JAXFREE OK" in r.stdout
    assert "score=" in r.stdout
