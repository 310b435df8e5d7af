"""NumPy "spec engine" — the exact behavioral oracle for all five modes.

This module is the readable source of truth for the reference semantics; the
JAX device engines are differentially tested against it, and it is
itself differentially tested against the compiled reference binary.

It reproduces, bit-for-bit:
  * strictly-greater / earliest-argument tie-breaking of ``max5``
    (reference: src/alignment.h:90-100) at every call site's argument order;
  * per-mode border initialization, including local mode's calloc-zero
    borders (alignment.h:805-847 performs NO border init) and overlap's
    "row0=-INF then col0=0" overwrite order (alignment.h:937-938);
  * traceback start rules: global's L,M,U tie order at (m,n)
    (alignment.h:466-469); local's strictly-greater running argmax in
    row-major fill order (alignment.h:830-833); fit's and overlap's bottom-row
    scan over j ∈ [0, n-1] — the LAST COLUMN j=n IS EXCLUDED
    (alignment.h:677, 684, 954) — with M beating L on ties in fit;
  * traceback walks and emission, including global's un-scored leftover
    prefix padding (alignment.h:398-407) and fit's suppressed target prefix
    (trace stops at i==0: alignment.h:562);
  * edit distance's hardcoded indel cost 1 (``-o`` parsed but dead,
    alignment.h:306-309) and match cost 0 / mismatch cost u (295).

Scores are float64 (the reference uses double) holding exact integers; all
row fills are vectorized with max-plus / min-plus prefix scans so even the
257×114,491 stress fixture is fast.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from aligntools_tpu.params import (
    AlignParams,
    PTR_DIAG,
    PTR_HOME,
    PTR_JUMP,
    PTR_LEFT,
    PTR_LOW,
    PTR_MID,
    PTR_RIGHT,
    PTR_UNSET,
    PTR_UPP,
)

NEG = -np.inf


@dataclasses.dataclass
class AlignResult:
    score: float
    row1: bytes  # gapped query row (reference r1)
    row2: bytes  # gapped target row (reference r2)


def _seq(x) -> np.ndarray:
    if isinstance(x, (bytes, bytearray)):
        return np.frombuffer(bytes(x), dtype=np.uint8)
    if isinstance(x, str):
        return np.frombuffer(x.encode(), dtype=np.uint8)
    return np.asarray(x, dtype=np.uint8)


def _sub_row(qc: int, t: np.ndarray, match: float, mismatch: float) -> np.ndarray:
    """Score of query char qc vs every target char — raw byte equality
    (reference: ``(s1->s[i-1] - s2->s[j-1]) == 0`` at alignment.h:449)."""
    return np.where(t == qc, float(match), float(mismatch))


def _mstep(prevs: Sequence[np.ndarray], sub: np.ndarray, ptr_codes: Sequence[int]):
    """M-state step: max over diag predecessors (+sub), earliest-arg ties.

    ``prevs`` are the previous row's state vectors at columns 0..n-1 (the
    diagonal predecessors of columns 1..n), in the reference's max5 argument
    order. Returns (M row values for j=1..n, pointer row uint8).
    np.argmax returns the FIRST maximal index == earliest-argument tie-break.
    """
    vals = np.stack(prevs, axis=0)
    best = vals.max(axis=0)
    idx = vals.argmax(axis=0)
    codes = np.asarray(ptr_codes, dtype=np.uint8)
    ptr = np.where(best > NEG, codes[idx], np.uint8(PTR_UNSET))
    return best + sub, ptr.astype(np.uint8)


def _lstep(l_prev: np.ndarray, m_prev: np.ndarray, e: float, o: float):
    """L-state step (gap in target): max(L[i-1,j]+e, M[i-1,j]+o); tie → LOW
    (max5 arg order L,M at alignment.h:456/648/835)."""
    a = l_prev + e
    b = m_prev + o
    val = np.maximum(a, b)
    ptr = np.where(
        val > NEG,
        np.where(a >= b, np.uint8(PTR_LOW), np.uint8(PTR_MID)),
        np.uint8(PTR_UNSET),
    )
    return val, ptr.astype(np.uint8)


def _uscan(m_row: np.ndarray, u0: float, e: float, o: float):
    """U-state row scan: U[j] = max(M[j-1]+o, U[j-1]+e), U[0]=u0.

    Closed form via max-plus prefix scan (exact for integer-valued doubles):
    U[j] = max(u0 + e*j, max_{0<=k<j} (M[k] + o + e*(j-1-k))).
    Tie → MID (max5 arg order -INF, M+o, U+e at alignment.h:460/653/839).
    """
    n = m_row.shape[0] - 1  # m_row has columns 0..n
    j = np.arange(1, n + 1, dtype=np.float64)
    k = np.arange(0, n, dtype=np.float64)
    cand = m_row[:-1] + o - e * (k + 1.0)  # normalized so U'[j] = U[j] - e*j
    acc = np.maximum.accumulate(cand)
    u = np.empty(n + 1, dtype=np.float64)
    u[0] = u0
    with np.errstate(invalid="ignore"):
        u[1:] = np.maximum(u0 + e * j, acc + e * j)
    # NaN guard: -inf + finite stays -inf; e*j finite; acc may be -inf → fine.
    a = m_row[:-1] + o
    b = u[:-1] + e
    val = np.maximum(a, b)
    ptr = np.where(
        val > NEG,
        np.where(a >= b, np.uint8(PTR_MID), np.uint8(PTR_UPP)),
        np.uint8(PTR_UNSET),
    )
    return u, ptr.astype(np.uint8)


def _jscan(m_row: np.ndarray, entry_mask: np.ndarray, jp: float):
    """Fit-mode J-state row scan (alignment.h:657-667).

    CRITICAL INVERSION QUIRK: the reference defines
    ``typedef enum {true, false} bool`` (alignment.h:24), so true==0 and
    ``isvalueinarray`` returns 0 ("true") on found. The caller tests it with
    plain truthiness (``if(isvalueinarray(j-1, ...))`` at :659), so the
    branches are INVERTED relative to the doc comment: jump ENTRY
    (J[j] = max(M[j-1]+jump, J[j-1]), ties → MID per arg order at :660) is
    taken at columns where (j-1) is NOT a junction site, and at junction
    columns J only extends freely (J[j] = J[j-1], :664). Verified against the
    compiled binary (score 494 on test_fit.fa requires the inverted gating).

    ``entry_mask[k]`` = True where entry is allowed at column j=k+1, i.e.
    where (j-1) is NOT in sites. J[0] = -INF (border).
    Closed form: J[j] = max over entry columns k<j of (M[k]+jump).
    """
    n = m_row.shape[0] - 1
    cand = np.where(entry_mask, m_row[:-1] + jp, NEG)
    acc = np.maximum.accumulate(cand)
    j_row = np.empty(n + 1, dtype=np.float64)
    j_row[0] = NEG
    j_row[1:] = acc
    a = np.where(entry_mask, m_row[:-1] + jp, NEG)  # MID candidate at entry cols
    b = j_row[:-1]  # JUMP candidate (carried)
    ptr = np.where(
        a > NEG,
        np.where(a >= b, np.uint8(PTR_MID), np.uint8(PTR_JUMP)),
        np.where(b > NEG, np.uint8(PTR_JUMP), np.uint8(PTR_UNSET)),
    )
    return j_row, ptr.astype(np.uint8)


# ---------------------------------------------------------------------------
# global (Needleman-Wunsch, affine): reference align_gla, alignment.h:417-473
# ---------------------------------------------------------------------------


def spec_global(q, t, p: AlignParams = AlignParams()) -> AlignResult:
    q, t = _seq(q), _seq(t)
    m, n = len(q), len(t)
    o, e = float(p.gap_open), float(p.gap_extend)
    pM = np.zeros((m + 1, n + 1), dtype=np.uint8)
    pL = np.zeros((m + 1, n + 1), dtype=np.uint8)
    pU = np.zeros((m + 1, n + 1), dtype=np.uint8)
    # Border init (alignment.h:428-441): M(0,0)=0, L(0,0)=U(0,0)=o;
    # col0: L(i,0)=o+e*i, M/U=-INF; row0: U(0,j)=o+e*j, M/L=-INF.
    jj = np.arange(n + 1, dtype=np.float64)
    Mrow = np.full(n + 1, NEG)
    Mrow[0] = 0.0
    Lrow = np.full(n + 1, NEG)
    Lrow[0] = o
    Urow = o + e * jj
    for i in range(1, m + 1):
        sub = _sub_row(q[i - 1], t, p.match, p.mismatch)
        Mp, Lp, Up = Mrow, Lrow, Urow
        Mrow = np.empty(n + 1)
        Lrow = np.empty(n + 1)
        # arg order L, M, U (alignment.h:451)
        Mrow[1:], pM[i, 1:] = _mstep(
            (Lp[:-1], Mp[:-1], Up[:-1]), sub, (PTR_LOW, PTR_MID, PTR_UPP)
        )
        Mrow[0] = NEG
        Lrow[1:], pL[i, 1:] = _lstep(Lp[1:], Mp[1:], e, o)
        Lrow[0] = o + e * i
        Urow, pU[i, 1:] = _uscan(Mrow, NEG, e, o)
    # Final cell, tie order L, M, U (alignment.h:466-469).
    finals = (Lrow[n], Mrow[n], Urow[n])
    score = max(finals)
    state = (PTR_LOW, PTR_MID, PTR_UPP)[int(np.argmax(finals))]
    r1, r2 = _traceback_global(q, t, pM, pL, pU, state, m, n)
    return AlignResult(float(score), r1, r2)


def _traceback_global(q, t, pM, pL, pU, state, i, j):
    """trace_back_gla (alignment.h:372-412): walk while i>0 and j>0, then pad
    the un-consumed prefix of either sequence with gaps (un-scored)."""
    r1, r2 = bytearray(), bytearray()
    while i > 0 and j > 0:
        if state == PTR_LOW:
            state = pL[i, j]
            i -= 1
            r1.append(q[i])
            r2.append(ord("-"))
        elif state == PTR_MID:
            state = pM[i, j]
            i -= 1
            j -= 1
            r1.append(q[i])
            r2.append(t[j])
        elif state == PTR_UPP:
            state = pU[i, j]
            j -= 1
            r1.append(ord("-"))
            r2.append(t[j])
        else:  # unreachable on finite paths (C would spin: default no-op)
            raise RuntimeError(f"global traceback hit unset pointer at {i},{j}")
    while j > 0:
        j -= 1
        r1.append(ord("-"))
        r2.append(t[j])
    while i > 0:
        i -= 1
        r1.append(q[i])
        r2.append(ord("-"))
    return bytes(reversed(r1)), bytes(reversed(r2))


# ---------------------------------------------------------------------------
# local (Smith-Waterman, affine): reference align_local_affine, :805-847
# ---------------------------------------------------------------------------


def spec_local(q, t, p: AlignParams = AlignParams()) -> AlignResult:
    q, t = _seq(q), _seq(t)
    m, n = len(q), len(t)
    o, e = float(p.gap_open), float(p.gap_extend)
    pM = np.zeros((m + 1, n + 1), dtype=np.uint8)
    pL = np.zeros((m + 1, n + 1), dtype=np.uint8)
    pU = np.zeros((m + 1, n + 1), dtype=np.uint8)
    # NO border init — all matrices are calloc-zero (alignment.h:805-847;
    # the doc comment at 754-755 claiming -INF borders is wrong).
    Mrow = np.zeros(n + 1)
    Lrow = np.zeros(n + 1)
    Urow = np.zeros(n + 1)
    best = NEG
    i_max = j_max = 0
    for i in range(1, m + 1):
        sub = _sub_row(q[i - 1], t, p.match, p.mismatch)
        Mp, Lp, Up = Mrow, Lrow, Urow
        zeros = np.zeros(n, dtype=np.float64)
        Mrow = np.empty(n + 1)
        Lrow = np.empty(n + 1)
        # arg order L+s, M+s, U+s, 0.0 (alignment.h:825); note the HOME
        # candidate is 0.0 WITHOUT +sub, so fold sub into the first three.
        vals = np.stack((Lp[:-1] + sub, Mp[:-1] + sub, Up[:-1] + sub, zeros))
        mbest = vals.max(axis=0)
        idx = vals.argmax(axis=0)
        codes = np.asarray((PTR_LOW, PTR_MID, PTR_UPP, PTR_HOME), dtype=np.uint8)
        Mrow[1:] = mbest
        Mrow[0] = 0.0
        pM[i, 1:] = codes[idx]  # 0.0 arg is always finite → pointer always set
        # Running argmax, strictly greater, row-major order (alignment.h:830).
        rb = float(mbest.max())
        if rb > best:
            best = rb
            i_max = i
            j_max = int(mbest.argmax()) + 1
        Lrow[1:], pL[i, 1:] = _lstep(Lp[1:], Mp[1:], e, o)
        Lrow[0] = 0.0
        Urow, pU[i, 1:] = _uscan(Mrow, 0.0, e, o)
    r1, r2 = _traceback_local(q, t, pM, pL, pU, i_max, j_max)
    return AlignResult(float(best), r1, r2)


def _traceback_local(q, t, pM, pL, pU, i, j):
    """trace_back_local_affine (alignment.h:766-800): start state MID at the
    argmax cell; stop on HOME pointer or on hitting i==0 / j==0."""
    r1, r2 = bytearray(), bytearray()
    state = PTR_MID
    while i > 0 and j > 0:
        if state == PTR_LOW:
            state = pL[i, j]
            i -= 1
            r1.append(q[i])
            r2.append(ord("-"))
        elif state == PTR_MID:
            state = pM[i, j]
            i -= 1
            j -= 1
            r1.append(q[i])
            r2.append(t[j])
        elif state == PTR_UPP:
            state = pU[i, j]
            j -= 1
            r1.append(ord("-"))
            r2.append(t[j])
        elif state == PTR_HOME:
            break
        else:
            raise RuntimeError(f"local traceback hit unset pointer at {i},{j}")
    return bytes(reversed(r1)), bytes(reversed(r2))


# ---------------------------------------------------------------------------
# fit (semi-global with optional junction jump): align_fit_affine_jump, :596-694
# ---------------------------------------------------------------------------


def spec_fit(
    q, t, p: AlignParams = AlignParams(), sites: Sequence[int] | None = None
) -> AlignResult:
    """``sites is None`` ⇔ reference run without ``-s`` (no J state)."""
    q, t = _seq(q), _seq(t)
    m, n = len(q), len(t)
    if m > n:
        raise ValueError("first sequence must be shorter than the second")  # :599
    o, e, jp = float(p.gap_open), float(p.gap_extend), float(p.jump)
    use_jump = sites is not None
    pM = np.zeros((m + 1, n + 1), dtype=np.uint8)
    pL = np.zeros((m + 1, n + 1), dtype=np.uint8)
    pU = np.zeros((m + 1, n + 1), dtype=np.uint8)
    pJ = np.zeros((m + 1, n + 1), dtype=np.uint8)
    # Junction membership of target position (j-1) (alignment.h:659). NOTE
    # the enum-bool inversion (see _jscan): jump ENTRY happens at columns
    # whose target position is NOT a listed site.
    jmask = np.zeros(n, dtype=bool)
    if use_jump:
        for s in sites:
            if 0 <= s < n:
                jmask[s] = True
    entry_mask = ~jmask
    # Borders (alignment.h:612-624): col0 all -INF; row0 M=U=0, L=J=-INF
    # (row0 loop starts at j=0, overwriting col0 at (0,0) → M(0,0)=U(0,0)=0).
    Mrow = np.zeros(n + 1)
    Urow = np.zeros(n + 1)
    Lrow = np.full(n + 1, NEG)
    Jrow = np.full(n + 1, NEG)
    lastM = lastL = None
    for i in range(1, m + 1):
        sub = _sub_row(q[i - 1], t, p.match, p.mismatch)
        Mp, Lp, Up, Jp = Mrow, Lrow, Urow, Jrow
        Mrow = np.empty(n + 1)
        Lrow = np.empty(n + 1)
        if use_jump:  # arg order L,M,U,J (alignment.h:635)
            Mrow[1:], pM[i, 1:] = _mstep(
                (Lp[:-1], Mp[:-1], Up[:-1], Jp[:-1]),
                sub,
                (PTR_LOW, PTR_MID, PTR_UPP, PTR_JUMP),
            )
        else:  # arg order L,M,U (alignment.h:641)
            Mrow[1:], pM[i, 1:] = _mstep(
                (Lp[:-1], Mp[:-1], Up[:-1]), sub, (PTR_LOW, PTR_MID, PTR_UPP)
            )
        Mrow[0] = NEG
        Lrow[1:], pL[i, 1:] = _lstep(Lp[1:], Mp[1:], e, o)
        Lrow[0] = NEG
        Urow, pU[i, 1:] = _uscan(Mrow, NEG, e, o)
        if use_jump:
            Jrow, pJ[i, 1:] = _jscan(Mrow, entry_mask, jp)
        lastM, lastL = Mrow, Lrow
    # Traceback start (alignment.h:672-690): scan row m over j ∈ [0, n-1]
    # (LAST COLUMN EXCLUDED); M first then L, strictly-greater, so M beats L
    # on ties and the smallest j wins within each matrix.
    best = NEG
    j_max = 0
    state = PTR_MID
    if m == 0:
        raise ValueError("fit: empty query")
    for vec, st in ((lastM[:n], PTR_MID), (lastL[:n], PTR_LOW)):
        vbest = float(vec.max())
        if vbest > best:
            best = vbest
            j_max = int(vec.argmax())
            state = st
    if best == NEG:
        raise RuntimeError("fit: no finite traceback start (reference UB)")
    r1, r2 = _traceback_fit(q, t, pM, pL, pU, pJ, state, m, j_max)
    return AlignResult(float(best), r1, r2)


def _traceback_fit(q, t, pM, pL, pU, pJ, state, i, j):
    """trace_back_fit_affine_jump (alignment.h:558-592): walk while i>0 only;
    the un-consumed target prefix is NOT emitted. JUMP emits '-' over target."""
    r1, r2 = bytearray(), bytearray()
    while i > 0:
        if state == PTR_LOW:
            state = pL[i, j]
            i -= 1
            r1.append(q[i])
            r2.append(ord("-"))
        elif state == PTR_MID:
            state = pM[i, j]
            i -= 1
            j -= 1
            r1.append(q[i])
            r2.append(t[j])
        elif state == PTR_UPP:
            state = pU[i, j]
            j -= 1
            r1.append(ord("-"))
            r2.append(t[j])
        elif state == PTR_JUMP:
            state = pJ[i, j]
            j -= 1
            r1.append(ord("-"))
            r2.append(t[j])
        else:
            raise RuntimeError(f"fit traceback hit unset pointer at {i},{j}")
    return bytes(reversed(r1)), bytes(reversed(r2))


# ---------------------------------------------------------------------------
# overlap (single matrix, linear gap): align_overlap, alignment.h:926-964
# ---------------------------------------------------------------------------


def spec_overlap(q, t, p: AlignParams = AlignParams()) -> AlignResult:
    q, t = _seq(q), _seq(t)
    m, n = len(q), len(t)
    o = float(p.gap_open)  # linear gap; -e is parsed but DEAD (alignment.h:944)
    pM = np.zeros((m + 1, n + 1), dtype=np.uint8)
    # Init order matters (alignment.h:937-938): row0=-INF ∀j, THEN col0=0 ∀i,
    # so M(0,0)=0.
    Mrow = np.full(n + 1, NEG)
    Mrow[0] = 0.0
    for i in range(1, m + 1):
        sub = _sub_row(q[i - 1], t, p.match, p.mismatch)
        Mp = Mrow
        Mrow = np.empty(n + 1)
        Mrow[0] = 0.0
        # arg order LEFT, DIAGONAL, RIGHT (alignment.h:944): LEFT is a
        # same-row scan term → max-plus prefix scan with gap slope.
        diag_right = np.maximum(Mp[:-1] + sub, Mp[1:] + o)  # DIAG beats RIGHT ties
        k = np.arange(n, dtype=np.float64)
        cand = diag_right - o * (k + 1.0)
        acc = np.maximum.accumulate(cand)
        jv = np.arange(1, n + 1, dtype=np.float64)
        left_base = Mrow[0] - 0.0  # M[i,0] = 0, candidate via LEFT chain
        Mrow[1:] = np.maximum(left_base + o * jv, acc + o * jv)
        # Pointers: LEFT iff M[i,j-1]+o >= others (earliest arg wins ties).
        a, b, c = Mrow[:-1] + o, Mp[:-1] + sub, Mp[1:] + o
        val = np.maximum(np.maximum(a, b), c)
        ptr = np.where(
            val > NEG,
            np.where(
                a >= val,
                np.uint8(PTR_LEFT),
                np.where(b >= val, np.uint8(PTR_DIAG), np.uint8(PTR_RIGHT)),
            ),
            np.uint8(PTR_UNSET),
        )
        pM[i, 1:] = ptr
    # Start scan: row m, j ∈ [0, n-1] (last column excluded; j=0's 0.0 is a
    # valid start → possibly empty alignment) (alignment.h:950-959).
    row = np.empty(n)
    row[0] = 0.0
    row[1:] = Mrow[1:n]
    j_max = int(row.argmax())
    best = float(row[j_max])
    r1, r2 = _traceback_overlap(q, t, pM, m, j_max)
    return AlignResult(best, r1, r2)


def _traceback_overlap(q, t, pM, i, j):
    """trace_back_overlap (alignment.h:896-922): walk while j>0."""
    r1, r2 = bytearray(), bytearray()
    while j > 0:
        s = pM[i, j]
        if s == PTR_LEFT:
            j -= 1
            r1.append(ord("-"))
            r2.append(t[j])
        elif s == PTR_DIAG:
            i -= 1
            j -= 1
            r1.append(q[i])
            r2.append(t[j])
        elif s == PTR_RIGHT:
            i -= 1
            r1.append(q[i])
            r2.append(ord("-"))
        else:  # C infinite-loop hazard (alignment.h:913-914); we fail fast
            raise RuntimeError(f"overlap traceback hit unset pointer at {i},{j}")
    return bytes(reversed(r1)), bytes(reversed(r2))


# ---------------------------------------------------------------------------
# edit distance: edit_dist, alignment.h:291-315
# ---------------------------------------------------------------------------


def spec_edit(q, t, p: AlignParams = AlignParams()) -> int:
    """min-DP; indel cost hardcoded 1 (``-o`` dead: alignment.h:306-309);
    match costs 0, mismatch costs opt->u (which is NEGATIVE by default — the
    reference quirk where substitutions reduce "distance")."""
    q, t = _seq(q), _seq(t)
    m, n = len(q), len(t)
    u = float(p.mismatch)
    row = np.arange(n + 1, dtype=np.float64)  # M[0,j] = j
    for i in range(1, m + 1):
        sub = np.where(t == q[i - 1], 0.0, u)
        prev = row
        row = np.empty(n + 1)
        row[0] = float(i)  # M[i,0] = i
        cand = np.minimum(prev[:-1] + sub, prev[1:] + 1.0)
        k = np.arange(1, n + 1, dtype=np.float64)
        norm = np.minimum.accumulate(np.concatenate(([row[0]], cand - k)))
        row[1:] = norm[1:] + k
    return int(row[n])  # (int) cast truncation (alignment.h:312)
