"""Large randomized differential validation campaign (one-off, not CI).

Runs thousands of randomized pairs — uniform DNA, tie-heavy binary
alphabets, homopolymer runs, protein alphabet, degenerate parameter sets
(match == mismatch, o == e) — through:

  reference binary  <->  spec oracle  <->  scan engine  <->  batch path

and asserts score equality everywhere plus alignment-row equality wherever
the reference's own output is self-consistent (its strrev heap overflow
can corrupt printed rows; see QUIRKS.md). Writes a summary to stdout.

Usage: ALIGNTOOLS_REFERENCE=DIR python tools/validate.py [n_per_case]
       [--section S]   (DIR: a checkout of the reference C sources)

Sections: main (spec/scan/batch vs reference), banded-full, rescan,
banded-auto, seqpar. With no --section, every section runs in its own
subprocess — XLA:CPU can segfault after ~170 distinct executables in one
process (see pyproject addopts), and the campaign compiles many.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

REF_DIR = os.environ.get("ALIGNTOOLS_REFERENCE", "")


def build_reference(tmp):
    out = os.path.join(tmp, "alignTools")
    subprocess.run(
        ["cc", "-g", "-O2", f"{REF_DIR}/src/main.c", f"{REF_DIR}/src/kstring.c",
         f"-I{REF_DIR}/src", "-lz", "-o", out],
        check=True, capture_output=True,
    )
    return out


def gen_seq(rng, kind, lo, hi):
    n = int(rng.integers(lo, hi + 1))
    if kind == "dna":
        return bytes(rng.choice(list(b"ACGT"), n).tolist())
    if kind == "binary":
        return bytes(rng.choice(list(b"AB"), n).tolist())
    if kind == "protein":
        return bytes(rng.choice(list(b"ACDEFGHIKLMNPQRSTVWY"), n).tolist())
    if kind == "homopolymer":
        out = bytearray()
        while len(out) < n:
            out += bytes([rng.choice(list(b"ACGT"))]) * int(
                rng.integers(1, 12)
            )
        return bytes(out[:n])
    raise ValueError(kind)


PARAM_SETS = [
    dict(match=1, mismatch=-2, gap_open=-5, gap_extend=-1),   # defaults
    dict(match=2, mismatch=-3, gap_open=-4, gap_extend=-2),
    dict(match=1, mismatch=1, gap_open=-1, gap_extend=-1),    # m == u: ties
    dict(match=3, mismatch=0, gap_open=-2, gap_extend=-2),    # o == e
    dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1),   # everything -1
]


def rows_sane(r1, r2, q, t, mode):
    if len(r1) != len(r2):
        return False
    u1, u2 = r1.replace("-", ""), r2.replace("-", "")
    if mode == "global":
        return u1 == q and u2 == t
    if mode == "fit":
        return u1 == q and u2 in t
    return u1 in q and u2 in t


KINDS = ["dna", "binary", "homopolymer", "protein"]


def make_ref_runner(binary):
    def run_ref(args):
        # bytes + latin-1: the reference's strrev heap overflow can emit
        # arbitrary garbage bytes (QUIRKS.md), which is not valid UTF-8
        r = subprocess.run([binary, *args], capture_output=True, timeout=120)
        lines = [ln for ln in r.stdout.decode("latin-1").splitlines()
                 if ln != "asDAsdaSDAsdasDAsdaSD"]
        return lines, r.returncode

    return run_ref


def gen_case(rng, mode, k, tmp, max_m=100, max_n=140, sites_ok=True):
    """One randomized case: (q, t, params, sites, fa_path, ref_cmd)."""
    from aligntools_tpu.params import AlignParams

    kind = KINDS[k % len(KINDS)]
    pd = PARAM_SETS[k % len(PARAM_SETS)]
    p = AlignParams(**pd)
    q = gen_seq(rng, kind, 1, max_m)
    t = gen_seq(rng, kind, len(q) if mode == "fit" else 1, max_n)
    if mode == "fit" and len(t) < len(q):
        t = t + gen_seq(rng, kind, len(q) - len(t), len(q) - len(t))
    sites = None
    fa = os.path.join(tmp, "pair.fa")
    hdr2 = ">t"
    args = []
    if mode == "fit" and k % 2 and sites_ok:
        sites = sorted(int(x) for x in rng.integers(0, len(t), 4))
        hdr2 = ">t " + "|".join(map(str, sites))
        args = ["-s"]
    with open(fa, "w") as f:
        f.write(f">q\n{q.decode()}\n{hdr2}\n{t.decode()}\n")
    if mode == "overlap":
        cmd = [mode, fa]  # argv[1] bug: no options possible
        p = AlignParams()
    elif mode == "edit":
        cmd = [mode, "-m", str(p.match), "-u", str(p.mismatch), fa]
    else:
        cmd = [mode, "-m", str(p.match), "-u", str(p.mismatch),
               "-o", str(p.gap_open), "-e", str(p.gap_extend), *args, fa]
    return q, t, p, sites, fa, cmd


def ref_score_rows(lines, mode):
    """(score, row1, row2 | None, None) from reference stdout lines."""
    if mode == "edit":
        return float(lines[-1].split("=")[-1]), None, None
    score_line = (lines[0] if mode == "overlap" else
                  next(ln for ln in lines if ln.startswith("score=")))
    idx = lines.index(score_line)
    return (float(score_line.split("=")[-1]),
            lines[idx + 1], lines[idx + 2])


def section_main(n_per, tmp, binary):
    from aligntools_tpu.batch import batch_scores
    from aligntools_tpu.engine.scan import scan_align
    from aligntools_tpu.params import AlignParams
    from aligntools_tpu.spec import engine as spec

    rng = np.random.default_rng(2026)
    stats = {"cases": 0, "ref_crash": 0, "rows_insane": 0}
    run_ref = make_ref_runner(binary)

    kinds = KINDS
    for mode in ("global", "local", "edit", "fit", "overlap"):
        batch_cases = []
        for k in range(n_per):
            kind = kinds[k % len(kinds)]
            pd = PARAM_SETS[k % len(PARAM_SETS)]
            p = AlignParams(**pd)
            q = gen_seq(rng, kind, 1, 100)
            t = gen_seq(rng, kind, len(q) if mode == "fit" else 1, 140)
            if mode == "fit" and len(t) < len(q):
                t = t + gen_seq(rng, kind, len(q) - len(t), len(q) - len(t))
            sites = None
            fa = os.path.join(tmp, "pair.fa")
            hdr2 = ">t"
            args = []
            if mode == "fit" and k % 2:
                sites = sorted(int(x) for x in rng.integers(0, len(t), 4))
                hdr2 = ">t " + "|".join(map(str, sites))
                args = ["-s"]
            with open(fa, "w") as f:
                f.write(f">q\n{q.decode()}\n{hdr2}\n{t.decode()}\n")
            if mode == "overlap":
                cmd = [mode, fa]  # argv[1] bug: no options possible
                p = AlignParams()
            elif mode == "edit":
                cmd = [mode, "-m", str(p.match), "-u", str(p.mismatch), fa]
            else:
                cmd = [mode, "-m", str(p.match), "-u", str(p.mismatch),
                       "-o", str(p.gap_open), "-e", str(p.gap_extend),
                       *args, fa]
            lines, rc = run_ref(cmd)
            if rc != 0:
                stats["ref_crash"] += 1  # reference strrev abort etc.
                continue
            stats["cases"] += 1
            # spec oracle vs reference
            if mode == "edit":
                want = spec.spec_edit(q, t, p)
                assert lines[-1] == f"edit_distance={want}", (mode, k, q, t)
                got = scan_align("edit", q, t, p)
                assert got == want, (mode, k)
                batch_cases.append((q, t, p, want, None))
                continue
            if mode == "fit":
                w = spec.spec_fit(q, t, p, sites)
            else:
                w = getattr(spec, f"spec_{mode}")(q, t, p)
            score_line = next(
                ln for ln in lines if ln.startswith("score=")
            ) if mode != "overlap" else lines[0]
            ref_score = float(score_line.split("=")[-1])
            assert w.score == ref_score, (mode, k, q, t, pd, sites)
            idx = lines.index(score_line)
            rr1, rr2 = lines[idx + 1], lines[idx + 2]
            if rows_sane(rr1, rr2, q.decode(), t.decode(), mode):
                assert (w.row1.decode(), w.row2.decode()) == (rr1, rr2), (
                    mode, k, q, t, pd, sites,
                )
            else:
                stats["rows_insane"] += 1
            # device scan engine vs spec (scores AND rows)
            g = scan_align(mode, q, t, p, sites)
            assert (g.score, g.row1, g.row2) == (w.score, w.row1, w.row2), (
                mode, k,
            )
            batch_cases.append((q, t, p, w.score, sites))
        # the batched path on a subset, grouped by param set —
        # and, for fit, by jump-state usage (use_jump applies per batch:
        # a sites=None pair means NO jump state, not an all-permitted one)
        for pi, pd in enumerate(PARAM_SETS):
            p = AlignParams(**pd)
            for with_sites in (False, True):
                sub = [
                    x for x in batch_cases[:60]
                    if x[2] == p and (mode != "fit"
                                      or (x[4] is not None) == with_sites)
                ]
                if not sub or (with_sites and mode != "fit"):
                    continue
                prs = [(q, t) for q, t, *_ in sub]
                sl = [x[4] for x in sub] if with_sites else None
                got = batch_scores(mode, prs, p, sites_list=sl)
                want = np.asarray([x[3] for x in sub], dtype=np.float64)
                assert np.array_equal(got.astype(np.float64), want), (
                    mode, pi, with_sites,
                )
        print(f"{mode}: OK ({n_per} cases)", flush=True)
    print(
        f"[main] {stats['cases']} reference comparisons, "
        f"{stats['ref_crash']} reference crashes skipped (its strrev "
        f"overflow), {stats['rows_insane']} reference row outputs "
        f"corrupt/skipped; every score matched and every self-consistent "
        f"reference alignment matched byte-for-byte across spec, scan "
        f"engine, and the batched path.", flush=True,
    )
    return stats


def section_banded_full(n_per, tmp, binary):
    # banded engine at FULL band (band >= max(m, n) covers the whole
    # matrix, so rows must be byte-identical to the spec — including all
    # window-coordinate tie-breaks); tie-heavy binary alphabet included
    from aligntools_tpu.engine.banded import banded_align_batch
    from aligntools_tpu.params import AlignParams
    from aligntools_tpu.spec import engine as spec

    kinds = KINDS

    rng2 = np.random.default_rng(77)
    for mode in ("global", "local", "fit", "overlap"):
        p = AlignParams(match=2, mismatch=-2, gap_open=-4, gap_extend=-1)
        prs = []
        for k in range(max(20, n_per // 4)):
            kind = kinds[k % len(kinds)]
            q = gen_seq(rng2, kind, 1, 80)
            t = gen_seq(rng2, kind, 1, 100)
            if mode == "fit" and len(q) > len(t):
                q, t = t, q
            prs.append((q, t))
        band = max(max(len(q), len(t)) for q, t in prs)
        res, _ = banded_align_batch(mode, prs, band, p)
        for (q, t), r in zip(prs, res):
            w = (spec.spec_fit(q, t, p) if mode == "fit"
                 else getattr(spec, f"spec_{mode}")(q, t, p))
            assert (r.score, r.row1, r.row2) == (
                w.score, w.row1, w.row2,
            ), ("banded", mode, q, t)
        print(f"banded {mode} rows: OK ({len(prs)} cases)", flush=True)


def section_rescan(n_per, tmp, binary):
    """Checkpoint-rescan traceback vs the live reference binary AND the
    spec oracle. Small strides force multiple row blocks, exercising the
    checkpoint/rescan machinery (engine/rescan.py) on every case."""
    from aligntools_tpu.engine.rescan import rescan_align
    from aligntools_tpu.spec import engine as spec

    rng = np.random.default_rng(31)
    run_ref = make_ref_runner(binary)
    n = max(12, n_per // 8)
    for mode in ("global", "local", "fit", "overlap"):
        checked = 0
        for k in range(n):
            q, t, p, sites, fa, cmd = gen_case(rng, mode, k, tmp)
            lines, rc = run_ref(cmd)
            if rc != 0:
                continue
            ref_s, rr1, rr2 = ref_score_rows(lines, mode)
            w = (spec.spec_fit(q, t, p, sites) if mode == "fit"
                 else getattr(spec, f"spec_{mode}")(q, t, p))
            stride = (8, 16, 24)[k % 3]
            g = rescan_align(mode, q, t, p, sites, stride=stride)
            assert g.score == ref_s == w.score, ("rescan", mode, k, q, t)
            if rows_sane(rr1, rr2, q.decode(), t.decode(), mode):
                assert (g.row1.decode(), g.row2.decode()) == (rr1, rr2), (
                    "rescan", mode, k, q, t, stride)
            assert (g.row1, g.row2) == (w.row1, w.row2), (
                "rescan-vs-spec", mode, k, q, t, stride)
            checked += 1
        print(f"rescan {mode}: OK ({checked}/{n} cases, strides 8/16/24)",
              flush=True)


def section_banded_auto(n_per, tmp, binary):
    """Certificate-driven auto-banded scores vs the live reference binary.

    banded_score_auto doubles the band until the certificate discharges
    (or the band covers the matrix), so its score must equal the exact
    unbanded score on EVERY input — including the tie-heavy alphabets
    that defeat plateau heuristics (tests/test_banded.py)."""
    from aligntools_tpu.engine.banded import banded_score_auto

    rng = np.random.default_rng(47)
    run_ref = make_ref_runner(binary)
    n = max(12, n_per // 8)
    for mode in ("global", "local", "fit", "overlap", "edit"):
        checked = 0
        bands = []
        for k in range(n):
            # the banded engine has no fit jump state (pipeline.py:87
            # rejects --band with -s), so sites are never generated here
            q, t, p, sites, fa, cmd = gen_case(rng, mode, k, tmp,
                                               sites_ok=False)
            lines, rc = run_ref(cmd)
            if rc != 0:
                continue
            ref_s, _, _ = ref_score_rows(lines, mode)
            score, band, cert = banded_score_auto(mode, q, t, p)
            assert cert, ("banded-auto-uncertified", mode, k)
            assert float(score) == ref_s, (
                "banded-auto", mode, k, q, t, band)
            bands.append(band)
            checked += 1
        print(f"banded-auto {mode}: OK ({checked}/{n} cases, "
              f"final bands {min(bands)}-{max(bands)})", flush=True)


def section_seqpar(n_per, tmp, binary):
    """Sequence-parallel FULL alignments (target sharded over the mesh)
    vs the live reference binary and the spec oracle. Runs on whatever
    devices the process sees — the wrapper re-execs with 8 virtual CPU
    devices so the shard_map path is real, not degenerate."""
    import jax

    from aligntools_tpu.parallel.seqpar import seqpar_align
    from aligntools_tpu.spec import engine as spec

    print(f"[seqpar] devices: {jax.device_count()}", flush=True)
    rng = np.random.default_rng(59)
    run_ref = make_ref_runner(binary)
    n = max(8, n_per // 15)
    for mode in ("global", "local", "fit", "overlap"):
        checked = 0
        for k in range(n):
            q, t, p, sites, fa, cmd = gen_case(rng, mode, k, tmp,
                                               max_m=60, max_n=120)
            lines, rc = run_ref(cmd)
            if rc != 0:
                continue
            ref_s, rr1, rr2 = ref_score_rows(lines, mode)
            w = (spec.spec_fit(q, t, p, sites) if mode == "fit"
                 else getattr(spec, f"spec_{mode}")(q, t, p))
            g = seqpar_align(mode, q, t, p, sites)
            assert g.score == ref_s == w.score, ("seqpar", mode, k, q, t)
            if rows_sane(rr1, rr2, q.decode(), t.decode(), mode):
                assert (g.row1.decode(), g.row2.decode()) == (rr1, rr2), (
                    "seqpar", mode, k, q, t)
            assert (g.row1, g.row2) == (w.row1, w.row2), (
                "seqpar-vs-spec", mode, k, q, t)
            checked += 1
        print(f"seqpar {mode}: OK ({checked}/{n} cases)", flush=True)


def section_native_cli(n_per, tmp, binary):
    """The native C++ single-pair CLI (native/aligntools_cli) vs the live
    reference binary on the full randomized distribution: stdout score
    lines always equal; full stdout equal when the reference's own rows
    are self-consistent (its strrev overflow corrupts some)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ndir = os.path.join(repo, "native")
    r = subprocess.run(["make", "-C", ndir, "aligntools_cli"],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        print(f"[native-cli] build failed, section skipped: "
              f"{r.stderr[-200:]}", flush=True)
        return
    ncli = os.path.join(ndir, "aligntools_cli")
    rng = np.random.default_rng(83)
    run_ref = make_ref_runner(binary)
    n = max(24, n_per // 2)
    for mode in ("global", "local", "edit", "fit", "overlap"):
        checked = rows_checked = 0
        for k in range(n):
            q, t, p, sites, fa, cmd = gen_case(rng, mode, k, tmp)
            lines, rc = run_ref(cmd)
            if rc != 0:
                continue
            rn = subprocess.run([ncli, *cmd], capture_output=True,
                                timeout=120)
            nlines = rn.stdout.decode("latin-1").splitlines()
            assert rn.returncode == 0, ("native-cli", mode, k, rn.stderr)
            if mode == "edit":
                assert nlines == lines, ("native-cli", mode, k, q, t)
            else:
                score_line = (lines[0] if mode == "overlap" else
                              next(ln for ln in lines
                                   if ln.startswith("score=")))
                idx = lines.index(score_line)
                assert nlines[idx] == score_line, (
                    "native-cli", mode, k, q, t)
                rr1, rr2 = lines[idx + 1], lines[idx + 2]
                if rows_sane(rr1, rr2, q.decode(), t.decode(), mode):
                    assert nlines == lines, ("native-cli", mode, k, q, t)
                    rows_checked += 1
            checked += 1
        print(f"native-cli {mode}: OK ({checked}/{n} cases, "
              f"{rows_checked} full-stdout)", flush=True)


def section_chunked(n_per, tmp, binary):
    """Column-chunked XLA engine scores vs the live reference binary.

    Cases are grouped per param set into padded buckets (the engine takes
    one scoring-param set per batch, like the production bucket path) and
    filled with chunk=128 so every target crosses at least one chunk
    boundary; ragged true lengths sit before/on/after the edges."""
    import jax.numpy as jnp

    from aligntools_tpu.engine import chunked as ck
    from aligntools_tpu.spec import engine as spec

    rng = np.random.default_rng(47)
    run_ref = make_ref_runner(binary)
    n = max(16, n_per // 4)
    m_pad, n_pad = 128, 256
    for mode in ("global", "local", "edit", "fit", "overlap"):
        groups = {}
        for k in range(n):
            q, t, p, sites, fa, cmd = gen_case(rng, mode, k, tmp)
            lines, rc = run_ref(cmd)
            if rc != 0:
                continue
            ref_s = ref_score_rows(lines, mode)[0]
            # jump and no-jump fit are DIFFERENT DPs (use_jump is one
            # flag per batch): group by it alongside the param set
            groups.setdefault(
                (p.match, p.mismatch, p.gap_open, p.gap_extend, p.jump,
                 sites is not None),
                [],
            ).append((q, t, sites, ref_s))
        checked = 0
        for key, cases in groups.items():
            B = len(cases)
            qs = np.full((B, m_pad), -1, np.int32)
            ts = np.full((B, n_pad), -2, np.int32)
            allow = np.ones((B, n_pad), bool)
            ps = np.zeros((B, 6), np.float32)
            ps[:, :5] = key[:5]
            ns = np.zeros(B, np.int32)
            use_jump = key[-1] if mode == "fit" else False
            for r, (q, t, sites, _) in enumerate(cases):
                qs[r, : len(q)] = np.frombuffer(q, np.uint8)
                ts[r, : len(t)] = np.frombuffer(t, np.uint8)
                ps[r, 5] = len(q)
                ns[r] = len(t)
                if sites is not None:
                    allow[r, [s for s in sites if 0 <= s < n_pad]] = False
            a = (jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(ns),
                 jnp.asarray(ps))
            if mode == "fit":
                got = np.asarray(ck.chunked_fit_scores(
                    use_jump, a[0], a[1], jnp.asarray(allow), a[2], 128,
                    params=a[3]))
            else:
                got = np.asarray(ck.chunked_scores(
                    mode, a[0], a[1], a[2], 128, params=a[3]))
            for r, (q, t, sites, ref_s) in enumerate(cases):
                g = int(got[r]) if mode == "edit" else float(got[r])
                assert g == ref_s, ("chunked", mode, key, q, t, g, ref_s)
                checked += 1
        print(f"chunked {mode}: OK ({checked}/{n} cases, chunk=128)",
              flush=True)


SECTIONS = {
    "main": section_main,
    "chunked": section_chunked,
    "banded-full": section_banded_full,
    "rescan": section_rescan,
    "banded-auto": section_banded_auto,
    "seqpar": section_seqpar,
    "native-cli": section_native_cli,
}


def main():
    args = [a for a in sys.argv[1:]]
    section = None
    if "--section" in args:
        i = args.index("--section")
        section = args[i + 1]
        del args[i:i + 2]
    n_per = int(args[0]) if args else 120

    if section is not None:
        tmp = tempfile.mkdtemp(prefix="validate")
        binary = build_reference(tmp)
        SECTIONS[section](n_per, tmp, binary)
        return

    # no section: run each in its own subprocess (executable-count
    # isolation); seqpar additionally gets 8 virtual CPU devices
    failed = []
    for name in SECTIONS:
        env = dict(os.environ)
        if name == "seqpar":
            env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                                " --xla_force_host_platform_device_count=8"
                                ).strip()
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), str(n_per),
             "--section", name], env=env)
        if r.returncode != 0:
            failed.append(name)
            print(f"SECTION FAILED: {name}", flush=True)
    if failed:
        print(f"VALIDATION FAILED: sections {failed}")
        sys.exit(1)
    print(
        "VALIDATION PASSED: spec/scan/batch (vs reference binary), "
        "banded-full rows, rescan rows, certificate-driven banded-auto "
        "scores, and seqpar full rows all byte/score-identical."
    )


if __name__ == "__main__":
    main()
