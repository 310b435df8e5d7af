"""Batch pipeline + `aligntools batch` CLI: TSV output parity with the spec
oracle, checkpoint/resume, error paths."""

import io

import numpy as np
import pytest

from aligntools_tpu.cli import main
from aligntools_tpu.params import AlignParams
from aligntools_tpu.pipeline import run_pipeline
from aligntools_tpu.spec import engine as spec

ALPHA = list(b"ACGT")


def _make_fasta(tmp_path, n_pairs, seed=0, sites=False, name="pairs.fa"):
    rng = np.random.default_rng(seed)
    lines = []
    pairs = []
    site_lists = []
    for k in range(n_pairs):
        q = bytes(rng.choice(ALPHA, int(rng.integers(5, 60))).tolist())
        t = bytes(rng.choice(ALPHA, int(rng.integers(len(q), 150))).tolist())
        pairs.append((q, t))
        lines.append(f">q{k}\n{q.decode()}")
        if sites:
            sl = sorted(int(x) for x in rng.integers(0, len(t), 3))
            site_lists.append(sl)
            lines.append(f">t{k} {'|'.join(map(str, sl))}\n{t.decode()}")
        else:
            site_lists.append(None)
            lines.append(f">t{k}\n{t.decode()}")
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path), pairs, site_lists


def test_pipeline_global_rows(tmp_path):
    path, pairs, _ = _make_fasta(tmp_path, 7)
    buf = io.StringIO()
    p = AlignParams()
    c = run_pipeline("global", path, p, out=buf, chunk_size=3)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 7 and c.pairs == 7
    for k, ln in enumerate(lines):
        name1, name2, score, r1, r2 = ln.split("\t")
        want = spec.spec_global(*pairs[k], p)
        assert (name1, name2) == (f"q{k}", f"t{k}")
        assert float(score) == want.score
        assert r1 == want.row1.decode() and r2 == want.row2.decode()


@pytest.mark.parametrize("n,chunk_size", [
    (0, 4), (1, 4), (7, 3), (8, 2), (20_000, 16_384), (100_000, 16_384),
])
def test_chunk_bounds_near_equal(n, chunk_size):
    from aligntools_tpu.pipeline import chunk_bounds

    b = chunk_bounds(n, chunk_size)
    assert len(b) == -(-n // chunk_size)
    if b:
        assert [lo for lo, _ in b] == [0] + [hi for _, hi in b[:-1]]
        assert b[-1][1] == n
        sizes = [hi - lo for lo, hi in b]
        assert max(sizes) <= chunk_size and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("rows", [False, True])
def test_pipeline_chunks_share_batch_rungs(tmp_path, monkeypatch, rows):
    """Every chunk fills each bucket shape at one batch rung, however
    many of its pairs the chunk holds, so a second chunk compiles
    nothing new; the outputs stay those of the spec."""
    from aligntools_tpu import batch as bt

    path, pairs, _ = _make_fasta(tmp_path, 60, seed=31)
    seen = []
    pad_rows = bt._pad_rows

    def spy(b):
        out = pad_rows(b)
        seen.append((b.m_pad, b.n_pad, len(out[0])))
        return out

    monkeypatch.setattr(bt, "_pad_rows", spy)
    buf = io.StringIO()
    p = AlignParams()
    run_pipeline("global", path, p, out=buf, chunk_size=25,
                 scores_only=not rows)
    rungs = {}
    for m_pad, n_pad, bp in seen:
        rungs.setdefault((m_pad, n_pad), set()).add(bp)
    assert len(seen) > len(rungs)  # shapes recur across the 3 chunks
    assert all(len(v) == 1 for v in rungs.values()), rungs
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 60
    for k, ln in enumerate(lines):
        f = ln.split("\t")
        want = spec.spec_global(*pairs[k], p)
        assert float(f[2]) == want.score
        if rows:
            assert (f[3], f[4]) == (want.row1.decode(), want.row2.decode())


def test_pipeline_fit_sites(tmp_path):
    path, pairs, site_lists = _make_fasta(tmp_path, 5, seed=3, sites=True)
    buf = io.StringIO()
    p = AlignParams(match=2, mismatch=-2)
    run_pipeline("fit", path, p, use_sites=True, out=buf)
    lines = buf.getvalue().strip().splitlines()
    for k, ln in enumerate(lines):
        _, _, score, r1, r2 = ln.split("\t")
        want = spec.spec_fit(*pairs[k], p, site_lists[k])
        assert float(score) == want.score and r1 == want.row1.decode()


def test_pipeline_resume(tmp_path):
    path, pairs, _ = _make_fasta(tmp_path, 8, seed=5)
    manifest = str(tmp_path / "m.json")
    p = AlignParams()
    buf1 = io.StringIO()
    # first run completes chunks 0..3 (chunk_size=2 -> 4 chunks)
    run_pipeline("edit", path, p, out=buf1, chunk_size=2,
                 manifest_path=manifest)
    assert len(buf1.getvalue().strip().splitlines()) == 8
    # re-run: everything done -> no new output
    buf2 = io.StringIO()
    c = run_pipeline("edit", path, p, out=buf2, chunk_size=2,
                     manifest_path=manifest)
    assert buf2.getvalue() == "" and c.pairs == 0
    # mismatched config errors
    with pytest.raises(ValueError):
        run_pipeline("edit", path, p, out=io.StringIO(), chunk_size=3,
                     manifest_path=manifest)


def test_pipeline_owned_out_atomic_resume(tmp_path):
    """out_path + manifest is crash-atomic: a run killed mid-chunk (torn
    bytes past the watermark) or right before mark_done resumes to the
    exact same output a clean run produces."""
    import json

    path, pairs, _ = _make_fasta(tmp_path, 8, seed=11)
    p = AlignParams()
    clean_out = str(tmp_path / "clean.tsv")
    run_pipeline("edit", path, p, out_path=clean_out, chunk_size=2)
    clean = open(clean_out, "rb").read()
    assert clean.count(b"\n") == 8

    # simulate a run killed after chunk 0 completed and chunk 1 was
    # half-written (torn) with mark_done never reached
    manifest = str(tmp_path / "m.json")
    out = str(tmp_path / "resumed.tsv")
    run_pipeline("edit", path, p, out_path=out, chunk_size=2,
                 manifest_path=manifest)
    mdata = json.load(open(manifest))
    wm = mdata["chunk_ends"]["0"]
    mdata["done_chunks"] = [0]
    mdata["chunk_ends"] = {"0": wm}
    json.dump(mdata, open(manifest, "w"))
    with open(out, "r+b") as f:
        f.truncate(wm)
        f.seek(wm)
        f.write(b"torn-half-chunk-without-newline")
    c = run_pipeline("edit", path, p, out_path=out, chunk_size=2,
                     manifest_path=manifest)
    assert open(out, "rb").read() == clean
    assert c.pairs == 6  # chunk 0 skipped


def test_pipeline_out_path_without_manifest_overwrites(tmp_path):
    path, _, _ = _make_fasta(tmp_path, 4, seed=3)
    out = str(tmp_path / "o.tsv")
    open(out, "w").write("stale previous contents\n" * 50)
    run_pipeline("edit", path, AlignParams(), out_path=out, chunk_size=4)
    data = open(out).read()
    assert "stale" not in data and len(data.strip().splitlines()) == 4
    with pytest.raises(ValueError):
        run_pipeline("edit", path, AlignParams(), out=io.StringIO(),
                     out_path=out)


def test_pipeline_odd_records(tmp_path):
    path = tmp_path / "odd.fa"
    path.write_text(">a\nACGT\n>b\nGG\n>c\nTT\n")
    with pytest.raises(ValueError):
        run_pipeline("global", str(path), AlignParams(), out=io.StringIO())


def test_batch_cli(tmp_path, capsys):
    path, pairs, _ = _make_fasta(tmp_path, 4, seed=7)
    rc = main(["aligntools", "batch", "local", "-m", "2", "--scores-only",
               path])
    cap = capsys.readouterr()
    assert rc == 0
    lines = cap.out.strip().splitlines()
    p = AlignParams(match=2)
    for k, ln in enumerate(lines):
        assert float(ln.split("\t")[2]) == spec.spec_local(*pairs[k], p).score
    assert "GCUPS" in cap.err


def test_batch_cli_sharded(tmp_path, capsys):
    path, pairs, _ = _make_fasta(tmp_path, 9, seed=9)
    rc = main(["aligntools", "batch", "global", "--sharded", path])
    cap = capsys.readouterr()
    assert rc == 0
    lines = cap.out.strip().splitlines()
    p = AlignParams()
    for k, ln in enumerate(lines):
        assert float(ln.split("\t")[2]) == spec.spec_global(*pairs[k], p).score


def test_batch_cli_matches_reference_binary(tmp_path, capsys, ref_run):
    """End-to-end integration: `aligntools batch` TSV scores+rows vs the
    reference binary run pair-by-pair on the same inputs."""
    path, pairs, _ = _make_fasta(tmp_path, 6, seed=13)
    rc = main(["aligntools", "batch", "global", path])
    cap = capsys.readouterr()
    assert rc == 0
    lines = cap.out.strip().splitlines()
    for k, ln in enumerate(lines):
        _, _, score, r1, r2 = ln.split("\t")
        fa = tmp_path / f"single{k}.fa"
        q, t = pairs[k]
        fa.write_text(f">q\n{q.decode()}\n>t\n{t.decode()}\n")
        ref_lines, ref_rc = ref_run("global", str(fa))
        assert ref_rc == 0
        assert f"score={float(score):.6f}" == ref_lines[0], k
        # rows comparable when the reference's strrev bug didn't corrupt them
        if (len(ref_lines[1]) == len(ref_lines[2])
                and ref_lines[1].replace("-", "") == q.decode()
                and ref_lines[2].replace("-", "") == t.decode()):
            assert (r1, r2) == (ref_lines[1], ref_lines[2]), k


def test_cigar_output(tmp_path, capsys):
    from aligntools_tpu.utils.cigar import rows_to_cigar

    assert rows_to_cigar(b"AC-GT", b"ACAG-") == "2M1D1M1I"
    assert rows_to_cigar(b"ACGT", b"AGGT", extended=True) == "1=1X2="
    assert rows_to_cigar(b"", b"") == ""
    path, pairs, _ = _make_fasta(tmp_path, 3, seed=21)
    rc = main(["aligntools", "batch", "global", "--cigar", path])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    p = AlignParams()
    for k, ln in enumerate(out):
        _, _, score, cg = ln.split("\t")
        w = spec.spec_global(*pairs[k], p)
        assert float(score) == w.score
        assert cg == rows_to_cigar(w.row1, w.row2)


def test_serve_loop(tmp_path):
    import io

    from aligntools_tpu.serve import serve

    path, pairs, _ = _make_fasta(tmp_path, 3, seed=23)
    req = io.StringIO(
        f"local {path} m=2 scores_only\n"
        "bogus_mode_line\n"
        f"edit {path}\n"
        "quit\n"
        f"local {path}\n"  # after quit: never processed
    )
    out = io.StringIO()
    assert serve(req, out) == 0
    lines = out.getvalue().splitlines()
    dones = [ln for ln in lines if ln.startswith("#done")]
    errs = [ln for ln in lines if ln.startswith("#error")]
    assert len(dones) == 2 and len(errs) == 1
    p2 = AlignParams(match=2)
    tsv = [ln for ln in lines if not ln.startswith("#")]
    assert float(tsv[0].split("\t")[2]) == spec.spec_local(*pairs[0], p2).score
    # requests after quit are not processed
    assert len(tsv) == 6  # 3 local scores + 3 edit distances


def test_batch_cli_band(tmp_path, capsys):
    path, pairs, _ = _make_fasta(tmp_path, 4, seed=29)
    band = max(max(len(q), len(t)) for q, t in pairs)  # full band: exact
    # full rows by default (banded_align_batch)
    rc = main(["aligntools", "batch", "local", "--band", str(band), path])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    p = AlignParams()
    for k, ln in enumerate(out):
        f = ln.split("\t")
        w = spec.spec_local(*pairs[k], p)
        assert float(f[2]) == w.score
        assert f[3].encode() == w.row1 and f[4].encode() == w.row2
    # --scores-only keeps the TSV-of-scores surface
    rc = main(["aligntools", "batch", "local", "--band", str(band),
               "--scores-only", path])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    for k, ln in enumerate(out):
        assert len(ln.split("\t")) == 3
        assert float(ln.split("\t")[2]) == spec.spec_local(*pairs[k], p).score
