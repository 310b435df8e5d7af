"""Native C++ runtime vs the pure-Python implementations: FASTA parsing and
packed-pointer traceback must agree byte-for-byte."""

import gzip

import numpy as np
import pytest

from aligntools_tpu import native
from aligntools_tpu.io import fasta
from aligntools_tpu.params import AlignParams
from aligntools_tpu.spec import engine as spec


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no toolchain)"
)


def test_parse_matches_python(tmp_path):
    content = (
        b">r1 first comment here\nACGT\nACGT\n\n"
        b"@fq2\nAACC\nGGTT\n+\nIIII\nJJJJ\n"
        b">r3\nTTTT\r\nGG\n"
    )
    path = tmp_path / "x.fa"
    path.write_bytes(content)
    native_recs = native.parse_records_native(str(path))
    py_recs = list(fasta.parse_records(iter(content.splitlines(keepends=True))))
    assert len(native_recs) == len(py_recs) == 3
    for a, b in zip(native_recs, py_recs):
        assert (a.name, a.comment, a.seq, a.qual) == (
            b.name, b.comment, b.seq, b.qual,
        )


def test_parse_gzip(tmp_path):
    path = tmp_path / "x.fa.gz"
    with gzip.open(path, "wb") as f:
        f.write(b">a c1\nACGT\n>b c2|3|4\nGGCC\n")
    recs = native.parse_records_native(str(path))
    assert [r.seq for r in recs] == [b"ACGT", b"GGCC"]
    assert recs[1].comment == b"c2|3|4"


def test_parse_missing_file():
    with pytest.raises(OSError):
        native.parse_records_native("/nonexistent/zzz.fa")


def test_parse_reference_fixtures(fixtures):
    for key in ("global", "local", "edit", "fit"):
        native_recs = native.parse_records_native(fixtures[key])
        py_recs = list(
            fasta.parse_records(open(fixtures[key], "rb"))
        )
        assert len(native_recs) == len(py_recs)
        for a, b in zip(native_recs, py_recs):
            assert (a.name, a.comment, a.seq, a.qual) == (
                b.name, b.comment, b.seq, b.qual,
            )


def test_traceback_native_parity():
    """scan_align (uses native walks when available) vs the spec oracle."""
    from aligntools_tpu.engine.scan import scan_align

    rng = np.random.default_rng(41)
    alpha = list(b"ACGT")
    for i in range(15):
        q = bytes(rng.choice(alpha, int(rng.integers(1, 80))).tolist())
        t = bytes(rng.choice(alpha, int(rng.integers(1, 80))).tolist())
        p = AlignParams(match=2, mismatch=-1, gap_open=-4, gap_extend=-1)
        for mode in ("global", "local", "overlap"):
            want = getattr(spec, f"spec_{mode}")(q, t, p)
            got = scan_align(mode, q, t, p)
            assert (got.score, got.row1, got.row2) == (
                want.score, want.row1, want.row2,
            ), (mode, i)
        qf = q[: min(len(q), len(t))]
        want = spec.spec_fit(qf, t, p, [3, 7])
        got = scan_align("fit", qf, t, p, [3, 7])
        assert (got.row1, got.row2) == (want.row1, want.row2), i


def test_parser_fuzz_no_crash(tmp_path):
    """Random junk (binary noise, truncated records, giant headers, CRLF,
    '+' lines in FASTA) must parse without crashing and must agree with the
    pure-Python parser."""
    rng = np.random.default_rng(81)
    for i in range(30):
        n = int(rng.integers(0, 400))
        blob = bytes(rng.integers(0, 256, n, dtype=np.uint8).tolist())
        # bias half the cases toward FASTA-looking content
        if i % 2:
            blob = b">" + blob.replace(b"\x00", b"A")
        path = tmp_path / f"fuzz{i}.fa"
        path.write_bytes(blob)
        native_recs = native.parse_records_native(str(path))
        py_recs = list(fasta.parse_records(open(path, "rb")))
        assert len(native_recs) == len(py_recs), i
        for a, b in zip(native_recs, py_recs):
            assert (a.name, a.comment, a.seq, a.qual) == (
                b.name, b.comment, b.seq, b.qual,
            ), i


def test_sanitizer_job(tmp_path):
    """The ASan+UBSan corpus run (native/Makefile `sanitize`): parser fuzz
    + walk corpus under -fno-sanitize-recover. Caught a real OOB read in
    round 2 (commit fcd2545); running it in every CI pass keeps the
    untrusted-gz-input parser honest."""
    import shutil
    import subprocess

    if not shutil.which("g++"):
        pytest.skip("no g++")
    import os

    mk = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    # probe: ASan runtime present? (some minimal toolchains lack it)
    probe = tmp_path / "asan_probe.cpp"
    probe.write_text("int main(){return 0;}\n")
    r = subprocess.run(
        ["g++", "-fsanitize=address", "-o", str(tmp_path / "probe"),
         str(probe)], capture_output=True)
    if r.returncode != 0:
        pytest.skip("ASan runtime unavailable")
    r = subprocess.run(["make", "-C", mk, "sanitize"],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
