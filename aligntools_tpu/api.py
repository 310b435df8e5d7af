"""High-level alignment API.

``align_pair`` is the single-pair entry point used by the CLI;
``align_batch`` (aligntools_tpu.batch) is the batched/throughput path.
Engine selection:

  * ``"scan"``  — JAX row-scan engine (engine/scan.py): jitted, runs on
    the GPU or the CPU.
  * ``"spec"``  — NumPy oracle (spec/engine.py): host-only reference
    semantics, also used for differential testing.
  * ``"auto"``  — scan on an accelerator backend; spec on CPU. A single
    pair on CPU is jit-dominated: cold CLI measured 0.95 s (scan,
    compile included) vs 0.13 s (spec) at 500x2000, and the reference's
    own fit stress fixture (384x33792) is ~60x faster through spec than
    a cold scan compile. Warm they are equal (~0.11 s), so the batched
    paths keep the jitted engines. Out-of-f32-range (params x length)
    combinations route to spec on every backend (exactness).
"""

from __future__ import annotations

from typing import Sequence

from aligntools_tpu.params import MODES, AlignParams
from aligntools_tpu.spec.engine import AlignResult


def align_pair(
    mode: str,
    seq1: bytes,
    seq2: bytes,
    params: AlignParams = AlignParams(),
    sites: Sequence[int] | None = None,
    engine: str = "auto",
):
    """Align one pair; returns AlignResult (or int for mode='edit').

    ``sites`` (fit mode only): junction positions on seq2 — enables the
    jump state exactly as the reference's ``-s`` flag does
    (reference: src/alignment.h:635-666, incl. the inverted enum-bool
    gating documented in QUIRKS.md).
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if sites is not None and mode != "fit":
        raise ValueError("junction sites are only meaningful in fit mode")
    if engine == "auto":
        from aligntools_tpu.backend import backend_name as _backend_name

        # On the CPU backend a lone pair is compile-dominated — spec wins
        # cold by 7-60x and ties warm (module docstring). Checked FIRST,
        # before anything that imports jax: the cold single-pair CLI stays
        # numpy-only (~0.4 s vs ~2.6 s with the jax import).
        if _backend_name() == "cpu":
            engine = "spec"
        else:
            from aligntools_tpu.engine.scan import f32_exact

            # The device engine is f32; out-of-range (params x length)
            # combinations would lose integer exactness, so auto routes
            # them to the double-precision spec oracle (ADVICE r1).
            if not f32_exact(params, len(seq1), len(seq2), mode):
                engine = "spec"
    if engine in ("auto", "scan"):
        from aligntools_tpu.engine.scan import scan_align

        return scan_align(mode, seq1, seq2, params, sites)
    if engine == "spec":
        from aligntools_tpu.spec import engine as spec

        if mode == "edit":
            return spec.spec_edit(seq1, seq2, params)
        if mode == "fit":
            return spec.spec_fit(seq1, seq2, params, sites)
        return getattr(spec, f"spec_{mode}")(seq1, seq2, params)
    raise ValueError(f"unknown engine {engine!r}")


def align_file(
    mode: str,
    path: str,
    params: AlignParams = AlignParams(),
    use_sites: bool = False,
    engine: str = "auto",
):
    """Read a 2-record FASTA/Q (gz ok) and align — the reference's
    per-subcommand flow (alignment.h:503-510). Returns (result, pair)."""
    from aligntools_tpu.io.fasta import read_pair

    pair = read_pair(path, want_sites=use_sites)
    sites = pair.sites if use_sites else None
    return align_pair(mode, pair.seq1, pair.seq2, params, sites, engine), pair
