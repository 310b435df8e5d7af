"""JAX row-scan device engine — all five alignment modes, single pair.

Data-parallel formulation of the reference's DP recurrences (reference:
src/alignment.h — align_gla:417-473, align_local_affine:805-847,
align_fit_affine_jump:596-694, align_overlap:926-964, edit_dist:291-315):
instead of the reference's scalar ``for i / for j`` loops, each query row is
filled as one wide vector step —

  * L (gap-in-target) and M (diagonal) depend only on the previous row →
    pure elementwise ops on shifted row vectors;
  * U (gap-in-query), fit's J (jump) and overlap's LEFT chain have an
    in-row left-to-right dependency → resolved exactly with a max-plus
    prefix scan: ``U[j] = max(M[j-1]+o, U[j-1]+e)`` becomes, after
    normalizing out the slope (``V[j] = U[j] - e*j``), a running max
    (``lax.cummax``), which XLA lowers to a log-depth scan;
  * edit distance is the min-plus mirror (``lax.cummin``).

The sequential dependency is therefore O(m) ``lax.scan`` steps of O(n)
vector work — for fit's skinny workloads (257 x 33,733) this is 257 wide
steps, not 34k wavefronts.

Numerics: scores are float32 holding exact integers. All inputs are integer
scoring params and the DP value magnitude is bounded by
``max|param| * (m+n) << 2^24``, so f32 arithmetic is EXACT, and true ``-inf``
is used as the border sentinel exactly like the reference's ``-INFINITY``
doubles (``-inf + finite = -inf``; ``-inf >= -inf`` is true so the
earliest-argument tie-break below matches C's strict-``>`` argmax).

Tie-breaking replicates the reference's ``max5`` (alignment.h:90-100):
strictly-greater comparison means the EARLIEST argument (per call-site
order) wins ties; every ``jnp.argmax`` here returns the first maximal index
and every two-way ``jnp.where(a >= b, first, second)`` keeps the earlier
argument on ties.

Pointer matrices are emitted one packed uint8 per cell (vs the reference's
four full int matrices) and walked on the host (engine/traceback.py).

Packed pointer byte layout (PACK_* constants):
  bits 0-2  pM: which predecessor state fed M       (0=LOW 1=MID 2=UPP
            3=JUMP 4=HOME 7=unset)
  bit  3    pL: 1 if L came from MID (gap open) else from LOW (extend)
  bit  4    pU: 1 if U came from UPP (extend) else from MID (open)
  bit  5    pJ: 1 if J came from JUMP (carry) else from MID (entry)
Overlap mode uses bits 0-1: 0=LEFT 1=DIAG 2=RIGHT 3=unset.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -jnp.inf

# f32 holds integers exactly up to 2^24; DP magnitudes are bounded by
# max|param| * (path length <= m+n+1), so the engine is exact iff that
# bound stays below the limit (module docstring "Numerics").
F32_EXACT_LIMIT = 1 << 24


def f32_exact(p, m: int, n: int, mode: str = "global") -> bool:
    """True when every DP value for this (params, lengths) combination is
    an integer representable exactly in float32."""
    if mode == "edit":
        mx = max(1, abs(p.mismatch))
    else:
        mx = max(abs(p.match), abs(p.mismatch), abs(p.gap_open),
                 abs(p.gap_extend), abs(p.jump))
    return mx * (m + n + 1) < F32_EXACT_LIMIT


def check_f32_exact(p, m: int, n: int, mode: str = "global") -> None:
    """Raise when the f32 engine would lose integer exactness — the
    reference computes in double (alignment.h:37-48), so silently
    diverging here is unacceptable; callers route to the spec engine."""
    if not f32_exact(p, m, n, mode):
        raise ValueError(
            f"scoring params x sequence lengths exceed the float32 "
            f"exact-integer range (max|param| * (m+n+1) >= 2^24 for "
            f"m={m}, n={n}); use engine='spec' for double-precision "
            f"reference semantics"
        )


def _unroll() -> int:
    """lax.scan unroll factor: 8 on the GPU, where each scan step pays a
    fixed launch cost that unrolling amortizes (PERF.md, "Bring-up
    findings"); 1 on the CPU keeps test compile times sane."""
    from aligntools_tpu.backend import on_gpu

    return 8 if on_gpu() else 1

# --- packed pointer-byte fields (see module docstring) ---
PK_M_LOW, PK_M_MID, PK_M_UPP, PK_M_JUMP, PK_M_HOME, PK_M_UNSET = 0, 1, 2, 3, 4, 7
PK_L_IS_MID = 1 << 3
PK_U_IS_UPP = 1 << 4
PK_J_IS_JUMP = 1 << 5
PK_OV_LEFT, PK_OV_DIAG, PK_OV_RIGHT, PK_OV_UNSET = 0, 1, 2, 3


def _m_candidates(prevs, sub, codes):
    """M-state step: max over diagonal predecessors (+sub), earliest-arg tie.

    ``prevs``: previous-row state vectors (columns 0..n-1, i.e. the diagonal
    predecessors of columns 1..n) in the reference max5 argument order
    (alignment.h:451/635/825). Returns (M values cols 1..n, 3-bit pM code).
    """
    vals = jnp.stack(prevs)
    best = vals.max(axis=0)
    idx = jnp.argmax(vals, axis=0)  # first max == earliest argument
    code = jnp.asarray(codes, dtype=jnp.uint8)[idx]
    code = jnp.where(best > NEG, code, jnp.uint8(PK_M_UNSET))
    return best + sub, code


def _l_step(l_prev, m_prev, o, e):
    """L[i,j] = max(L[i-1,j]+e, M[i-1,j]+o); tie -> LOW (alignment.h:456)."""
    a = l_prev + e
    b = m_prev + o
    val = jnp.maximum(a, b)
    bit = jnp.where(a >= b, jnp.uint8(0), jnp.uint8(PK_L_IS_MID))
    return val, bit


def _u_scan(m_row, u0, o, e, jidx):
    """U[0]=u0; U[j] = max(M[j-1]+o, U[j-1]+e); tie -> MID (alignment.h:460).

    Exact closed form: with V[j] = U[j] - e*j, V = cummax of
    [u0, M[j-1]+o-e*j], so U = cummax(...) + e*j. Pointer bit from the
    direct two-way comparison once U is known.
    """
    cand = jnp.concatenate([jnp.array([u0]), m_row[:-1] + o - e * jidx[1:]])
    u = jax.lax.cummax(cand) + e * jidx
    a = m_row[:-1] + o  # MID candidate at cols 1..n
    b = u[:-1] + e  # UPP candidate
    bit = jnp.where(a >= b, jnp.uint8(0), jnp.uint8(PK_U_IS_UPP))
    return u, bit


def _j_scan(m_row, entry_allowed, jp):
    """Fit J-state (alignment.h:657-667, with the enum-bool INVERSION —
    see spec.engine._jscan): at columns whose target position (j-1) is NOT a
    junction site, J[j] = max(M[j-1]+jump, J[j-1]) (tie -> MID); at junction
    columns J[j] = J[j-1] only. J[0] = -inf.

    ``entry_allowed``: bool per column 1..n (True where entry permitted).
    """
    cand = jnp.concatenate(
        [jnp.array([NEG]), jnp.where(entry_allowed, m_row[:-1] + jp, NEG)]
    )
    j_row = jax.lax.cummax(cand)
    a = cand[1:]  # MID entry candidate
    b = j_row[:-1]  # JUMP carry candidate
    bit = jnp.where(
        (a > NEG) & (a >= b), jnp.uint8(0), jnp.uint8(PK_J_IS_JUMP)
    )
    return j_row, bit


def _sub_row(qc, t_arr, match, mismatch):
    """Raw byte-equality scoring (alignment.h:449) against padded target."""
    return jnp.where(t_arr == qc, match, mismatch)


# ---------------------------------------------------------------------------
# Mode machines: (init carry, row step, finish) triples.
#
# Each mode's DP is packaged as a "machine" so that every consumer — the
# whole-matrix fills below, and the checkpoint-rescan engine
# (engine/rescan.py) that re-runs row blocks from saved carries — shares
# ONE implementation of the recurrences and tie-breaks. The carry layout
# places the resumable state rows FIRST (M, L, U[, J] — what rescan
# checkpoints), followed by mode-specific latches and the row counter i.
# ---------------------------------------------------------------------------


def global_machine(t_arr, n, params, n_pad, emit_ptrs):
    """align_gla (alignment.h:417-473). Carry: (M, L, U, fin(3,), i)."""
    match, mismatch, o, e = params[0], params[1], params[2], params[3]
    m = params[5].astype(jnp.int32)
    jidx = jnp.arange(n_pad + 1, dtype=jnp.float32)
    eq_n = jnp.arange(n_pad + 1) == n  # final-column mask (hoisted: a
    # dynamic row[n] gather per scan step costs ~2.5x fill throughput)
    # Row 0 borders (alignment.h:428-441): M(0,0)=0, L(0,0)=U(0,0)=o,
    # row0: U(0,j)=o+e*j, M/L=-inf.
    m0 = jnp.full(n_pad + 1, NEG).at[0].set(0.0)
    l0 = jnp.full(n_pad + 1, NEG).at[0].set(o)
    u0 = o + e * jidx

    def step(carry, qc_i):
        mp, lp, up, fin, i = carry
        qc, _ = qc_i
        i = i + 1
        sub = _sub_row(qc, t_arr, match, mismatch)
        # arg order L, M, U (alignment.h:451)
        mv, pm = _m_candidates(
            (lp[:-1], mp[:-1], up[:-1]), sub, (PK_M_LOW, PK_M_MID, PK_M_UPP)
        )
        m_row = jnp.concatenate([jnp.array([NEG]), mv])
        lv, plbit = _l_step(lp[1:], mp[1:], o, e)
        l_row = jnp.concatenate([jnp.array([o]) + e * i, lv])
        u_row, pubit = _u_scan(m_row, NEG, o, e, jidx)
        if emit_ptrs:
            packed = (pm | plbit | pubit).astype(jnp.uint8)
            packed = jnp.concatenate([jnp.zeros(1, jnp.uint8), packed])
        else:
            packed = None
        # Latch the (L,M,U) values at (m, n) when this is row m.
        here = jnp.stack([
            jnp.max(jnp.where(eq_n, l_row, NEG)),
            jnp.max(jnp.where(eq_n, m_row, NEG)),
            jnp.max(jnp.where(eq_n, u_row, NEG)),
        ])
        fin = jnp.where(i == m, here, fin)
        return (m_row, l_row, u_row, fin, i), packed

    fin0 = jnp.stack([l0[n], m0[n], u0[n]])  # m == 0 degenerate
    init = (m0, l0, u0, fin0, jnp.int32(0))

    def finish(carry):
        # Final tie order L, M, U (alignment.h:466-469).
        fin = carry[3]
        return fin.max(), jnp.argmax(fin).astype(jnp.int32)

    return init, step, finish


@functools.partial(jax.jit, static_argnums=(4, 5))
def global_fill(q_arr, t_arr, n, params, n_pad, emit_ptrs=True):
    """Fill the global-mode DP; returns (score, start_state 0/1/2=L/M/U,
    packed pointers [m_pad, n_pad+1]).

    ``q_arr``: int32 [m_pad] query bytes (pad value < 0);
    ``t_arr``: int32 [n_pad] target bytes; ``n``: true target length. The
    true query length m enters via where the caller reads the latched
    finals — here latched at scan step i == m via ``m`` in params[5].
    """
    init, step, finish = global_machine(t_arr, n, params, n_pad, emit_ptrs)
    carry, ptrs = jax.lax.scan(
        step, init, (q_arr.astype(jnp.float32), jnp.zeros(q_arr.shape[0])),
        unroll=_unroll(),
    )
    score, state = finish(carry)
    return score, state, ptrs


# ---------------------------------------------------------------------------
# local (Smith-Waterman affine) — align_local_affine, alignment.h:805-847
# ---------------------------------------------------------------------------


def local_machine(t_arr, n, params, n_pad, emit_ptrs):
    """align_local_affine (alignment.h:805-847).
    Carry: (M, L, U, best, imax, jmax, i)."""
    match, mismatch, o, e = params[0], params[1], params[2], params[3]
    m = params[5].astype(jnp.int32)
    jidx = jnp.arange(n_pad + 1, dtype=jnp.float32)
    col_real = (jnp.arange(n_pad + 1) >= 1) & (jnp.arange(n_pad + 1) <= n)
    zero = jnp.zeros(n_pad + 1)

    def step(carry, qc_i):
        mp, lp, up, best, imax, jmax, i = carry
        qc, _ = qc_i
        i = i + 1
        sub = _sub_row(qc, t_arr, match, mismatch)
        # arg order L+s, M+s, U+s, 0.0 (HOME) — alignment.h:825.
        vals = jnp.stack(
            [lp[:-1] + sub, mp[:-1] + sub, up[:-1] + sub, jnp.zeros(n_pad)]
        )
        mv = vals.max(axis=0)
        codes = jnp.asarray(
            (PK_M_LOW, PK_M_MID, PK_M_UPP, PK_M_HOME), dtype=jnp.uint8
        )
        pm = codes[jnp.argmax(vals, axis=0)]  # HOME always finite -> set
        m_row = jnp.concatenate([jnp.zeros(1), mv])
        lv, plbit = _l_step(lp[1:], mp[1:], o, e)
        l_row = jnp.concatenate([jnp.zeros(1), lv])
        u_row, pubit = _u_scan(m_row, 0.0, o, e, jidx)
        if emit_ptrs:
            packed = (pm | plbit | pubit).astype(jnp.uint8)
            packed = jnp.concatenate([jnp.zeros(1, jnp.uint8), packed])
        else:
            packed = None
        # Running argmax over REAL cells only (i<=m, 1<=j<=n), row-major,
        # strictly greater (alignment.h:830-833).
        masked = jnp.where(col_real, m_row, NEG)
        rb = masked.max()
        rj = jnp.argmax(masked).astype(jnp.int32)
        upd = (rb > best) & (i <= m)
        best = jnp.where(upd, rb, best)
        imax = jnp.where(upd, i, imax)
        jmax = jnp.where(upd, rj, jmax)
        return (m_row, l_row, u_row, best, imax, jmax, i), packed

    init = (zero, zero, zero, NEG, jnp.int32(0), jnp.int32(0), jnp.int32(0))

    def finish(carry):
        return carry[3], carry[4], carry[5]

    return init, step, finish


@functools.partial(jax.jit, static_argnums=(4, 5))
def local_fill(q_arr, t_arr, n, params, n_pad, emit_ptrs=True):
    """Local mode: calloc-zero borders (NOT -inf; alignment.h:805-847), M
    floored by a 0.0 HOME candidate (arg order L,M,U,0 at :825), running
    strictly-greater argmax of M in row-major fill order (:830-833).
    Returns (score, i_max, j_max, packed pointers)."""
    init, step, finish = local_machine(t_arr, n, params, n_pad, emit_ptrs)
    carry, ptrs = jax.lax.scan(
        step, init, (q_arr.astype(jnp.float32), jnp.zeros(q_arr.shape[0])),
        unroll=_unroll(),
    )
    best, imax, jmax = finish(carry)
    return best, imax, jmax, ptrs


# ---------------------------------------------------------------------------
# fit (semi-global + optional junction jump) — align_fit_affine_jump, :596-694
# ---------------------------------------------------------------------------


def fit_machine(t_arr, n, params, entry_allowed, n_pad, use_jump,
                emit_ptrs):
    """align_fit_affine_jump (alignment.h:596-694).
    Carry: (M, L, U, J, latchM, latchL, i)."""
    match, mismatch, o, e, jp = (
        params[0], params[1], params[2], params[3], params[4],
    )
    m = params[5].astype(jnp.int32)
    jidx = jnp.arange(n_pad + 1, dtype=jnp.float32)
    m0 = jnp.zeros(n_pad + 1)
    u0 = jnp.zeros(n_pad + 1)
    l0 = jnp.full(n_pad + 1, NEG)
    j0 = jnp.full(n_pad + 1, NEG)

    def step(carry, qc_i):
        mp, lp, up, jprow, latchM, latchL, i = carry
        qc, _ = qc_i
        i = i + 1
        sub = _sub_row(qc, t_arr, match, mismatch)
        if use_jump:  # arg order L, M, U, J (alignment.h:635)
            mv, pm = _m_candidates(
                (lp[:-1], mp[:-1], up[:-1], jprow[:-1]),
                sub,
                (PK_M_LOW, PK_M_MID, PK_M_UPP, PK_M_JUMP),
            )
        else:  # arg order L, M, U (alignment.h:641)
            mv, pm = _m_candidates(
                (lp[:-1], mp[:-1], up[:-1]), sub, (PK_M_LOW, PK_M_MID, PK_M_UPP)
            )
        m_row = jnp.concatenate([jnp.array([NEG]), mv])
        lv, plbit = _l_step(lp[1:], mp[1:], o, e)
        l_row = jnp.concatenate([jnp.array([NEG]), lv])
        u_row, pubit = _u_scan(m_row, NEG, o, e, jidx)
        if use_jump:
            j_row, pjbit = _j_scan(m_row, entry_allowed, jp)
        else:
            j_row, pjbit = jprow, jnp.zeros(n_pad, jnp.uint8)
        if emit_ptrs:
            packed = (pm | plbit | pubit | pjbit).astype(jnp.uint8)
            packed = jnp.concatenate([jnp.zeros(1, jnp.uint8), packed])
        else:
            packed = None
        latchM = jnp.where(i == m, m_row, latchM)
        latchL = jnp.where(i == m, l_row, latchL)
        return (m_row, l_row, u_row, j_row, latchM, latchL, i), packed

    init = (m0, l0, u0, j0, m0, l0, jnp.int32(0))

    def finish(carry):
        lastM, lastL = carry[4], carry[5]
        # Bottom-row scan over j in [0, n-1]; M beats L on ties (strict >).
        scan_mask = jnp.arange(n_pad + 1) < n
        mrow = jnp.where(scan_mask, lastM, NEG)
        lrow = jnp.where(scan_mask, lastL, NEG)
        mb, lb = mrow.max(), lrow.max()
        use_l = lb > mb
        score = jnp.where(use_l, lb, mb)
        state = jnp.where(use_l, jnp.int32(1), jnp.int32(0))
        j_max = jnp.where(
            use_l, jnp.argmax(lrow), jnp.argmax(mrow)
        ).astype(jnp.int32)
        return score, state, j_max

    return init, step, finish


@functools.partial(jax.jit, static_argnums=(5, 6, 7))
def fit_fill(q_arr, t_arr, n, params, entry_allowed, n_pad, use_jump, emit_ptrs=True):
    """Fit mode. Borders (alignment.h:612-624): col0 all -inf; row0 M=U=0,
    L=J=-inf (free target prefix). Traceback start (:672-690): scan row m
    over columns j in [0, n-1] (LAST COLUMN EXCLUDED), M first then L with
    strict >, so M beats L on ties and the smallest j wins within each.
    Returns (score, start_state 0=MID/1=LOW, j_max, packed pointers)."""
    init, step, finish = fit_machine(
        t_arr, n, params, entry_allowed, n_pad, use_jump, emit_ptrs
    )
    carry, ptrs = jax.lax.scan(
        step, init, (q_arr.astype(jnp.float32), jnp.zeros(q_arr.shape[0])),
        unroll=_unroll(),
    )
    score, state, j_max = finish(carry)
    return score, state, j_max, ptrs


# ---------------------------------------------------------------------------
# overlap (single matrix, linear gap) — align_overlap, alignment.h:926-964
# ---------------------------------------------------------------------------


def overlap_machine(t_arr, n, params, n_pad, emit_ptrs):
    """align_overlap (alignment.h:926-964). Carry: (M, latch, i)."""
    match, mismatch, o = params[0], params[1], params[2]
    m = params[5].astype(jnp.int32)
    jidx = jnp.arange(n_pad + 1, dtype=jnp.float32)
    m0 = jnp.full(n_pad + 1, NEG).at[0].set(0.0)

    def step(carry, qc_i):
        mp, latch, i = carry
        qc, _ = qc_i
        i = i + 1
        sub = _sub_row(qc, t_arr, match, mismatch)
        diag = mp[:-1] + sub
        right = mp[1:] + o
        dr = jnp.maximum(diag, right)  # DIAG beats RIGHT on ties (arg order)
        # M[i,0]=0; M[i,j] = max(M[i,j-1]+o, dr[j]) -> slope-o max-plus scan.
        cand = jnp.concatenate([jnp.zeros(1), dr - o * jidx[1:]])
        m_row = jax.lax.cummax(cand) + o * jidx
        # Pointers, arg order LEFT, DIAGONAL, RIGHT (alignment.h:944).
        a = m_row[:-1] + o
        val = jnp.maximum(a, dr)
        code = jnp.where(
            a >= val,
            jnp.uint8(PK_OV_LEFT),
            jnp.where(diag >= right, jnp.uint8(PK_OV_DIAG), jnp.uint8(PK_OV_RIGHT)),
        )
        if emit_ptrs:
            code = jnp.where(val > NEG, code, jnp.uint8(PK_OV_UNSET))
            packed = jnp.concatenate([jnp.zeros(1, jnp.uint8), code])
        else:
            packed = None
        latch = jnp.where(i == m, m_row, latch)
        return (m_row, latch, i), packed

    init = (m0, m0, jnp.int32(0))

    def finish(carry):
        scan_mask = jnp.arange(n_pad + 1) < n
        row = jnp.where(scan_mask, carry[1], NEG)
        j_max = jnp.argmax(row).astype(jnp.int32)
        return row[j_max], j_max

    return init, step, finish


@functools.partial(jax.jit, static_argnums=(4, 5))
def overlap_fill(q_arr, t_arr, n, params, n_pad, emit_ptrs=True):
    """Overlap mode: one matrix, LINEAR gap (``-e`` dead: alignment.h:944),
    init row0=-inf THEN col0=0 so M(0,0)=0 (:937-938). In-row LEFT chain
    resolved by a max-plus scan with slope o. Start scan: row m over
    j in [0, n-1] (j=0 included -> possibly empty alignment; last column
    excluded) (:950-959). Returns (score, j_max, packed 2-bit pointers)."""
    init, step, finish = overlap_machine(t_arr, n, params, n_pad, emit_ptrs)
    carry, ptrs = jax.lax.scan(
        step, init, (q_arr.astype(jnp.float32), jnp.zeros(q_arr.shape[0])),
        unroll=_unroll(),
    )
    score, j_max = finish(carry)
    return score, j_max, ptrs


# ---------------------------------------------------------------------------
# edit distance — edit_dist, alignment.h:291-315
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(4,))
def edit_fill(q_arr, t_arr, n, params, n_pad):
    """Min-plus DP: M(i,j)=min(M(i,j-1)+1, M(i-1,j-1)+sub, M(i-1,j)+1);
    indel cost HARDCODED 1 (``-o`` dead: alignment.h:306-309); sub = 0 on
    match else opt->u (:295). Returns the float value at (m, n) (caller
    applies the reference's ``(int)`` truncation, :312)."""
    u = params[1]
    m = params[5].astype(jnp.int32)
    jidx = jnp.arange(n_pad + 1, dtype=jnp.float32)
    eq_n = jnp.arange(n_pad + 1) == n  # hoisted final-column mask
    row0 = jidx  # M(0,j) = j

    def step(carry, qc_i):
        prev, latch, i = carry
        qc, _ = qc_i
        i = i + 1
        sub = jnp.where(t_arr == qc, 0.0, u)
        cand = jnp.minimum(prev[:-1] + sub, prev[1:] + 1.0)
        # row[0]=i; row[j]=min(cand[j], row[j-1]+1) -> slope-1 min-plus scan.
        c = jnp.concatenate([jnp.array([i.astype(jnp.float32)]), cand - jidx[1:]])
        row = jax.lax.cummin(c) + jidx
        fin = jnp.min(jnp.where(eq_n, row, jnp.inf))
        latch = jnp.where(i == m, fin, latch)
        return (row, latch, i), None

    init = (row0, row0[n], jnp.int32(0))
    (_, latch, _), _ = jax.lax.scan(
        step, init, (q_arr.astype(jnp.float32), jnp.zeros(q_arr.shape[0])),
        unroll=_unroll(),
    )
    return latch


# ---------------------------------------------------------------------------
# Host-side convenience wrappers (padding + traceback)
# ---------------------------------------------------------------------------


def _pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full(size, fill, dtype=x.dtype)
    out[: len(x)] = x
    return out


def pad_len(n: int, quantum: int = 128) -> int:
    """Round up to the tile quantum (128 columns)."""
    return max(quantum, -(-n // quantum) * quantum)


def _params_vec(p, m: int) -> jnp.ndarray:
    return jnp.array(
        [p.match, p.mismatch, p.gap_open, p.gap_extend, p.jump, m],
        dtype=jnp.float32,
    )


def _encode(seq: bytes, size: int, fill: int) -> jnp.ndarray:
    a = np.frombuffer(seq, dtype=np.uint8).astype(np.int32)
    return jnp.asarray(_pad_to(a, size, fill))


def scan_align(mode, q: bytes, t: bytes, p, sites=None):
    """Single-pair alignment on the device engine; returns
    spec-compatible AlignResult (or int for edit). Test/reference path —
    the batched API in aligntools_tpu.batch is the production path."""
    from aligntools_tpu.engine import traceback as tb
    from aligntools_tpu.spec.engine import AlignResult

    m, n = len(q), len(t)
    check_f32_exact(p, m, n, mode)
    m_pad, n_pad = pad_len(m), pad_len(n)
    qa = _encode(q, m_pad, -1)
    ta = _encode(t, n_pad, -2)
    pv = _params_vec(p, m)
    nn = jnp.int32(n)
    if mode == "global":
        score, state, ptrs = global_fill(qa, ta, nn, pv, n_pad)
        r1, r2 = tb.traceback_global(
            q, t, np.asarray(ptrs), int(state), m, n
        )
        return AlignResult(float(score), r1, r2)
    if mode == "local":
        score, imax, jmax, ptrs = local_fill(qa, ta, nn, pv, n_pad)
        r1, r2 = tb.traceback_local(
            q, t, np.asarray(ptrs), int(imax), int(jmax)
        )
        return AlignResult(float(score), r1, r2)
    if mode == "fit":
        if m > n:
            raise ValueError("first sequence must be shorter than the second")
        use_jump = sites is not None
        allowed = np.ones(n_pad, dtype=bool)
        if use_jump:
            s = np.asarray([x for x in sites if 0 <= x < n_pad], dtype=np.int64)
            allowed[s] = False  # entry allowed where (j-1) NOT a site
        score, state, jmax, ptrs = fit_fill(
            qa, ta, nn, pv, jnp.asarray(allowed), n_pad, use_jump
        )
        if not np.isfinite(float(score)):
            raise RuntimeError("fit: no finite traceback start (reference UB)")
        r1, r2 = tb.traceback_fit(
            q, t, np.asarray(ptrs), int(state), m, int(jmax)
        )
        return AlignResult(float(score), r1, r2)
    if mode == "overlap":
        score, jmax, ptrs = overlap_fill(qa, ta, nn, pv, n_pad)
        r1, r2 = tb.traceback_overlap(q, t, np.asarray(ptrs), m, int(jmax))
        return AlignResult(float(score), r1, r2)
    if mode == "edit":
        return int(edit_fill(qa, ta, nn, pv, n_pad))
    raise ValueError(f"unknown mode {mode!r}")
