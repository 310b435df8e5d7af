"""Banded DP: restrict the fill to a diagonal band |j - i| <= W.

The reference always fills the full O(m*n) table; for similar-length pairs
(read-vs-read, consensus polishing) the optimal path stays near the main
diagonal and a band of half-width W does O(m*W) work instead — here that
is a REAL compute saving, not just masking: DP rows are stored in
window coordinates (k = j - i + W, a (2W+1)-lane vector that slides right
one column per row), so vector width is the band, not the target.

Window-coordinate dependency map (window of row i starts at j0 = i - W):
  * diagonal (i-1, j-1): previous window, SAME k (the slide cancels the
    column shift) — no lane shift at all;
  * vertical (i-1, j): previous window at k+1 — shift left one lane;
  * horizontal (i, j-1): k-1 — the usual in-row max-plus prefix scan.
The target slice for row i is ``t_ext[i-1 : i-1+V]`` where t_ext carries
W pad columns on the left, so no per-row index arithmetic survives.

Semantics: identical to the full engines whenever the optimal path stays
strictly inside the band; out-of-band cells are -inf.

Exactness: score-plateau band doubling (double W until the score stops
changing) is a HEURISTIC — tests/test_banded.py constructs adversarial
pairs where two consecutive bands agree on a wrong score. The sound tool
is ``band_certificate``: a parameter-arithmetic bound on every path that
uses any out-of-band cell (crossing |j - i| = W+1 costs >= W+1 gap
steps for the corner-to-corner modes global/edit; for the free-start
modes local/fit/overlap no crossing is forced, so the bound degrades to
the perfect-score ceiling). ``banded_score_auto`` doubles the band until
the certificate proves exactness (``certified=True``) or the band covers
the whole matrix. ``edge_best`` (the best value ON the band boundary)
remains available as a cheap diagnostic.

Modes: global, local, edit, fit (WITHOUT the jump state — a junction
jump teleports across diagonals, which no band can contain), overlap.
Every mode with a traceback (all but edit) also emits window-coordinate
pointers, so ``banded_align`` returns full rows for global/local/fit/
overlap. Requires |n - m| <= W for global/edit (end cell in band).

Reference recurrences: src/alignment.h:417-473 (global), 805-847 (local),
291-315 (edit), 596-694 (fit, sans jump), 926-964 (overlap).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aligntools_tpu.params import AlignParams

NEG = -jnp.inf


@functools.partial(jax.jit, static_argnums=(0, 4, 6))
def banded_fill(mode, q_arr, t_ext, n, w_pad, params, emit_ptrs=False):
    """One pair, banded. q_arr (m_pad,) i32; t_ext (W + n_pad + V,) i32
    (W left-pad columns then the target); n true length; w_pad = W
    (static); params (8,) f32 [match,mis,o,e,_,m,_,_]. Returns
    (score f32, edge_best f32)."""
    match, mis = params[0], params[1]
    o, e = params[2], params[3]
    m = params[5].astype(jnp.int32)
    V = 2 * w_pad + 1
    kidx = jnp.arange(V, dtype=jnp.int32)  # window lane -> k

    # row 0: window covers j = k - W for k in [0, V)
    j_row0 = kidx - w_pad
    if mode == "edit":
        # min-plus: out-of-band is +inf; M(0,j) = j
        POS = jnp.inf
        m0 = jnp.where(j_row0 >= 0, j_row0.astype(jnp.float32), POS)
        l0 = u0 = jnp.zeros(V)  # unused carries

        def estep(carry, qc):
            mp, lp, up, best, edge, i = carry
            i = i + 1
            i_f = i.astype(jnp.float32)
            jcol = i - w_pad + kidx
            jf = jcol.astype(jnp.float32)
            in_mat = (jcol >= 1) & (jcol <= n) & (i <= m)
            tw = jax.lax.dynamic_slice(t_ext, (i - 1,), (V,))
            sub = jnp.where(tw == qc, 0.0, mis)
            diag = mp  # same k
            vert = jnp.concatenate([mp[1:], jnp.full(1, POS)])  # k+1
            at_j0_diag = jcol == 1
            diag = jnp.where(at_j0_diag, i_f - 1.0, diag)  # M(i-1,0)=i-1
            cand2 = jnp.minimum(diag + sub, vert + 1.0)
            cand2 = jnp.where(in_mat, cand2, POS)
            # horizontal chain, slope 1: D = row - j; border row(i,0)=i
            c = jnp.concatenate([jnp.full(1, POS), cand2[:-1] - jf[:-1]])
            c = jnp.maximum(c, -jnp.inf)
            c = jnp.where(jcol == 0, i_f, jnp.where(
                at_j0_diag, jnp.minimum(cand2 - jf, i_f), cand2 - jf
            ))
            row = jax.lax.cummin(c) + jf
            row = jnp.minimum(row, cand2)
            row = jnp.where(in_mat, row, POS)
            fin = jnp.min(jnp.where(jcol == n, row, POS))
            best = jnp.where(i == m, fin, best)
            edge = jnp.minimum(
                edge, jnp.minimum(row[0], row[V - 1])
            )
            return (row, lp, up, best, edge, i), None

        init = (m0, l0, u0, POS, POS, jnp.int32(0))
        (_, _, _, best, edge, _), _ = jax.lax.scan(
            estep, init, q_arr.astype(jnp.float32), unroll=4
        )
        return best, edge, jnp.int32(0), jnp.int32(0), jnp.zeros(
            (q_arr.shape[0],), jnp.uint8
        )
    if mode == "overlap":
        # single matrix, linear gap o (alignment.h:926-964): row0 = -inf
        # for j >= 1, col0 = 0 for all i; score = max(0, row m over
        # j in [1, n-1]) — the j=0 zero border is an unconditional start
        match, mis, o = params[0], params[1], params[2]
        m0 = jnp.where(j_row0 == 0, 0.0, NEG)

        def ostep(carry, qc):
            mp, best, jmax, edge, i = carry
            i = i + 1
            jcol = i - w_pad + kidx
            jf = jcol.astype(jnp.float32)
            in_mat = (jcol >= 1) & (jcol <= n) & (i <= m)
            tw = jax.lax.dynamic_slice(t_ext, (i - 1,), (V,))
            sub = jnp.where(tw == qc, match, mis)
            diag = mp  # same k
            vert = jnp.concatenate([mp[1:], jnp.full(1, NEG)])  # k+1
            at_j0 = jcol == 0
            at_j0_diag = jcol == 1
            diag = jnp.where(at_j0_diag, 0.0, diag)  # M(i-1, 0) = 0
            vert = jnp.where(at_j0, 0.0, vert)       # M(i-1, 0) = 0
            cand = jnp.maximum(diag + sub, vert + o)
            cand = jnp.where(in_mat, cand, NEG)
            # LEFT chain M(i,j) = max(cand, M(i,j-1)+o): slope-o scan,
            # normalized D = M - o*j with the col0 seed D = 0 at jcol==0
            c = jnp.where(at_j0, 0.0, cand - o * jf)
            row = jax.lax.cummax(c) + o * jf
            row = jnp.where(in_mat, row, NEG)
            # pointer codes in arg order LEFT, DIAGONAL, RIGHT
            # (alignment.h:944; earliest argument wins ties)
            lh = jnp.concatenate([jnp.full(1, NEG), row[:-1]])
            lh = jnp.where(at_j0_diag, 0.0, lh)  # M(i, 0) = 0
            code = jnp.where(
                lh + o >= row, 0,
                jnp.where(diag + sub >= vert + o, 1, 2),
            )
            packed = (
                jnp.where(row > NEG, code, 3).astype(jnp.uint8)
                if emit_ptrs else jnp.zeros((), jnp.uint8)
            )
            # bottom-row start: argmax over j in [0, n-1]; col0's 0.0 (an
            # always-available empty alignment) is scanned FIRST, so it
            # wins unless some j >= 1 is strictly greater
            # (alignment.h:950-959)
            rowmax = jnp.max(jnp.where(jcol <= n - 1, row, NEG))
            hit = (row == rowmax) & (jcol <= n - 1) & in_mat
            jarg = jnp.min(jnp.where(hit, jcol, 1 << 30)).astype(jnp.int32)
            fin = jnp.maximum(rowmax, 0.0)
            jarg = jnp.where(rowmax > 0.0, jarg, 0)
            latch = i == m
            best = jnp.where(latch, fin, best)
            jmax = jnp.where(latch, jarg, jmax)
            edge = jnp.maximum(edge, jnp.maximum(row[0], row[V - 1]))
            return (row, best, jmax, edge, i), packed

        init = (m0, NEG, jnp.int32(0), NEG, jnp.int32(0))
        (_, best, jmax, edge, _), ptrs = jax.lax.scan(
            ostep, init, q_arr.astype(jnp.float32), unroll=4
        )
        return best, edge, jmax, jnp.int32(0), ptrs
    if mode == "global":
        m0 = jnp.where(j_row0 == 0, 0.0, NEG)
        l0 = jnp.where(j_row0 == 0, o, NEG)
        u0 = jnp.where(
            j_row0 >= 0, o + e * j_row0.astype(jnp.float32), NEG
        )
    elif mode == "fit":
        # row 0: M = U = 0 for all j >= 0, L = -inf (alignment.h:619-624)
        valid0 = j_row0 >= 0
        m0 = jnp.where(valid0, 0.0, NEG)
        l0 = jnp.full(V, NEG)
        u0 = jnp.where(valid0, 0.0, NEG)
    else:  # local: zero borders; out-of-range still -inf (outside matrix)
        valid0 = j_row0 >= 0
        m0 = jnp.where(valid0, 0.0, NEG)
        l0 = jnp.where(valid0, 0.0, NEG)
        u0 = jnp.where(valid0, 0.0, NEG)

    def step(carry, xs):
        mp, lp, up, best, edge, aux_prev, i = carry
        qc = xs
        i = i + 1
        i_f = i.astype(jnp.float32)
        jcol = i - w_pad + kidx  # global j of each lane this row
        jf = jcol.astype(jnp.float32)
        in_mat = (jcol >= 1) & (jcol <= n) & (i <= m)
        # lane k holds global column j = i - W + k, i.e. t[j-1] at
        # t_ext[W + j - 1] = t_ext[(i - 1) + k]
        tw = jax.lax.dynamic_slice(t_ext, (i - 1,), (V,))
        sub = jnp.where(tw == qc, match, mis)
        # previous-row views in this row's window coordinates
        diag_m, diag_l, diag_u = mp, lp, up  # same k
        vert_m = jnp.concatenate([mp[1:], jnp.full(1, NEG)])  # k+1
        vert_l = jnp.concatenate([lp[1:], jnp.full(1, NEG)])
        # column-0 borders appear at lane k where jcol == 0
        at_j0 = jcol == 0
        at_j0_diag = jcol == 1  # diag pred (i-1, 0) sits at this row's j==1
        if mode == "global":
            bM_d = jnp.where(i - 1 == 0, 0.0, NEG)  # M(i-1, 0)
            bL_d = o + e * (i_f - 1.0)
            bU_d = jnp.where(i - 1 == 0, o, NEG)
            diag_m = jnp.where(at_j0_diag, bM_d, diag_m)
            diag_l = jnp.where(at_j0_diag, bL_d, diag_l)
            diag_u = jnp.where(at_j0_diag, bU_d, diag_u)
            vert_m = jnp.where(at_j0, NEG, vert_m)  # M(i,0) unused; vert is
            vert_l = jnp.where(at_j0, bL_d, vert_l)  # L(i-1,0)=o+e(i-1)
        elif mode == "fit":
            # col0 all -inf for i >= 1; (0,0) has M = U = 0 (the row-0
            # loop overwrites col0 — alignment.h:612-624)
            bMU_d = jnp.where(i - 1 == 0, 0.0, NEG)
            diag_m = jnp.where(at_j0_diag, bMU_d, diag_m)
            diag_l = jnp.where(at_j0_diag, NEG, diag_l)
            diag_u = jnp.where(at_j0_diag, bMU_d, diag_u)
            vert_m = jnp.where(at_j0, bMU_d, vert_m)
            vert_l = jnp.where(at_j0, NEG, vert_l)
        else:
            diag_m = jnp.where(at_j0_diag, 0.0, diag_m)
            diag_l = jnp.where(at_j0_diag, 0.0, diag_l)
            diag_u = jnp.where(at_j0_diag, 0.0, diag_u)
            vert_m = jnp.where(at_j0, 0.0, vert_m)
            vert_l = jnp.where(at_j0, 0.0, vert_l)
        # earliest-argument tie-break, reference arg order L, M, U (plus
        # the 0.0 HOME candidate for local) — same as engine/scan.py
        cand_l = diag_l + sub
        cand_m = diag_m + sub
        cand_u = diag_u + sub
        best3 = jnp.maximum(jnp.maximum(cand_l, cand_m), cand_u)
        pm = jnp.where(
            cand_l >= best3, 0,
            jnp.where(cand_m >= best3, 1, 2),
        )
        m_row = best3
        if mode == "local":
            # the 0.0 HOME candidate is the LAST max5 argument: it wins
            # only when strictly greater than the first three
            pm = jnp.where(best3 >= 0.0, pm, 4)
            m_row = jnp.maximum(best3, 0.0)
        m_row = jnp.where(in_mat, m_row, NEG)
        pm = jnp.where(m_row > NEG, pm, 7)
        la_, lb_ = vert_l + e, vert_m + o
        l_row = jnp.maximum(la_, lb_)
        pl = jnp.where(la_ >= lb_, 0, 1 << 3)
        l_row = jnp.where(in_mat, l_row, NEG)
        # U scan along the window (horizontal chain): exact within the
        # band because out-of-band predecessors are -inf
        u_seed = 0.0 if mode == "local" else NEG
        cand = jnp.concatenate(
            [jnp.full(1, NEG), m_row[:-1] + o - e * jf[1:]]
        )
        # the j==0 borders enter where the chain crosses column 0: the
        # U(i,0)=0 seed at lane j==0 and the M(i,0)=0 open candidate at
        # lane j==1 (matters when o > e)
        if mode == "local":
            cand = jnp.where(at_j0, 0.0 - e * jf, cand)
            cand = jnp.where(
                at_j0_diag, jnp.maximum(cand, 0.0 + o - e * jf), cand
            )
        u_row = jax.lax.cummax(cand)
        u_row = jnp.maximum(u_row, u_seed) + e * jf
        u_row = jnp.where(in_mat, u_row, NEG)
        # pU bit from the direct comparison (M(i,j-1)+o vs U(i,j-1)+e),
        # honoring the window shift; border values at the j==0 crossing
        mh = jnp.concatenate([jnp.full(1, NEG), m_row[:-1]])
        uh = jnp.concatenate([jnp.full(1, NEG), u_row[:-1]])
        if mode == "local":
            mh = jnp.where(at_j0_diag, 0.0, mh)
            uh = jnp.where(at_j0_diag, 0.0, uh)
        ua_ = mh + o
        ub_ = uh + e
        pu = jnp.where(ua_ >= ub_, 0, 1 << 4)
        packed = (
            (pm | pl | pu).astype(jnp.uint8)
            if emit_ptrs else jnp.zeros((), jnp.uint8)
        )
        # score and traceback-start tracking
        if mode == "fit":
            # bottom-row start scan over j in [0, n-1] (last column
            # excluded); col0 is -inf so only j >= 1 lanes contribute.
            # M is scanned before L so M wins score ties; within each
            # matrix the smallest j wins (strict > scan,
            # alignment.h:672-690)
            lt_n = (jcol <= n - 1) & in_mat
            mb = jnp.max(jnp.where(lt_n, m_row, NEG))
            lb3 = jnp.max(jnp.where(lt_n, l_row, NEG))
            use_l = lb3 > mb
            fin = jnp.maximum(mb, lb3)
            win_row = jnp.where(use_l, l_row, m_row)
            hit = (win_row == fin) & lt_n
            jarg = jnp.min(jnp.where(hit, jcol, 1 << 30)).astype(jnp.int32)
            latch = i == m
            best = jnp.where(latch, fin, best)
            aux = (
                jnp.where(latch, use_l.astype(jnp.int32), aux_prev[0]),
                jnp.where(latch, jarg, aux_prev[1]),
            )
        elif mode == "global":
            at_n = jcol == n
            ln_ = jnp.max(jnp.where(at_n, l_row, NEG))
            mn_ = jnp.max(jnp.where(at_n, m_row, NEG))
            un_ = jnp.max(jnp.where(at_n, u_row, NEG))
            fin = jnp.maximum(jnp.maximum(ln_, mn_), un_)
            st = jnp.where(
                (ln_ >= mn_) & (ln_ >= un_), 0,
                jnp.where(mn_ >= un_, 1, 2),
            ).astype(jnp.int32)
            latch = i == m
            best = jnp.where(latch, fin, best)
            aux = (
                jnp.where(latch, st, aux_prev[0]),
                aux_prev[1],
            )
        else:
            rowmax = jnp.max(m_row)
            hit = (m_row == rowmax) & in_mat
            jarg = jnp.min(jnp.where(hit, jcol, 1 << 30)).astype(jnp.int32)
            upd = rowmax > best
            best = jnp.maximum(best, rowmax)
            aux = (
                jnp.where(upd, i, aux_prev[0]),
                jnp.where(upd, jarg, aux_prev[1]),
            )
        # band-boundary diagnostic (lanes 0 and V-1)
        edge = jnp.maximum(
            edge, jnp.maximum(m_row[0], m_row[V - 1])
        )
        return (m_row, l_row, u_row, best, edge, aux, i), packed

    aux0 = (jnp.int32(0), jnp.int32(0))
    init = (m0, l0, u0, NEG, NEG, aux0, jnp.int32(0))
    (_, _, _, best, edge, aux, _), ptrs = jax.lax.scan(
        step, init, q_arr.astype(jnp.float32), unroll=4
    )
    return best, edge, aux[0], aux[1], ptrs


BANDED_MODES = ("global", "local", "edit", "fit", "overlap")


def band_certificate(
    mode: str, m: int, n: int, band: int, params: AlignParams = AlignParams()
) -> float:
    """Bound on every alignment path that uses ANY cell outside the band.

    Max-plus modes return an UPPER bound: if the banded score >= this
    value, no out-of-band path can strictly beat it, so the banded score
    is provably the exact unbanded score. Edit (min-plus) returns a LOWER
    bound on out-of-band cost: banded distance <= bound certifies.

    Math: a path that touches diagonal offset |j - i| = band+1 must
    contain >= band+1 gap steps (each step changes the offset by at most
    one), and its match/mismatch columns P satisfy P <= min(m, n-band-1)
    (right crossing) / min(n, m-band-1) (left). For the corner-to-corner
    modes (global, edit) EVERY out-of-band path must cross, so the bound
    bites; the free-start modes (local, fit, overlap) admit paths that
    live entirely beyond the band with zero gaps, so the bound degrades
    to the perfect-score ceiling (certifies only a perfect in-band hit).
    Gap params must be non-positive for the max-plus bound (else +inf =
    never certified).
    """
    c = max(params.match, params.mismatch)  # best per aligned column
    cpos = max(c, 0.0)
    if mode == "edit":
        # cost >= I + D + u*P with indel 1, u = params.mismatch quirk
        u_neg = min(params.mismatch, 0.0)
        w1 = band + 1
        sides = []
        if n >= w1:  # right: I >= W+1, D >= I - (n-m), P <= min(m, n-W-1)
            sides.append(
                w1 + max(0.0, w1 - (n - m)) + u_neg * max(min(m, n - w1), 0)
            )
        if m >= w1:  # left: D >= W+1, I = D + (n-m)
            sides.append(
                w1 + max(0.0, w1 + (n - m)) + u_neg * max(min(n, m - w1), 0)
            )
        return min(sides) if sides else float("inf")
    o, e = float(params.gap_open), float(params.gap_extend)
    if mode == "overlap":
        e = 0.0  # linear gap o; -e is dead (alignment.h:944)
    if o > 0 or e > 0:
        return float("inf")
    if mode == "global":
        w1 = band + 1
        sides = []
        if n >= w1:
            sides.append(cpos * max(min(m, n - w1), 0) + o + e * w1)
        if m >= w1:
            sides.append(cpos * max(min(n, m - w1), 0) + o + e * w1)
        return max(sides) if sides else float("-inf")
    if mode == "fit":  # all of q consumed: P <= m, gaps <= 0
        return cpos * m
    return cpos * min(m, n)  # local / overlap


def banded_score(
    mode: str,
    q: bytes,
    t: bytes,
    band: int,
    params: AlignParams = AlignParams(),
):
    """Banded score for one pair; returns (score, edge_best). Raises if the
    end cell cannot be in band (|n - m| > band)."""
    if mode not in BANDED_MODES:
        raise ValueError(f"banded engine covers {BANDED_MODES}")
    m, n = len(q), len(t)
    if mode in ("global", "edit") and abs(n - m) > band:
        raise ValueError(
            f"band {band} cannot contain the end cell (|n-m|={abs(n - m)})"
        )
    if mode == "fit" and m > n:
        raise ValueError("first sequence must be shorter than the second")
    V = 2 * band + 1
    qa = np.full(m, -1, np.int32)
    qa[:] = np.frombuffer(q, np.uint8)
    t_ext = np.full(band + n + V + 1, -2, np.int32)
    t_ext[band : band + n] = np.frombuffer(t, np.uint8)
    pv = np.array(
        [params.match, params.mismatch, params.gap_open, params.gap_extend,
         params.jump, m, 0, 0],
        np.float32,
    )
    score, edge, _, _, _ = banded_fill(
        mode, jnp.asarray(qa), jnp.asarray(t_ext), jnp.int32(n), band,
        jnp.asarray(pv),
    )
    return float(score), float(edge)


def banded_batch_scores(
    mode: str,
    pairs,
    band: int,
    params: AlignParams = AlignParams(),
):
    """Batched banded scores (one vmapped XLA fill); all pairs share one
    band and padded shapes. Returns (scores, edge_best) float arrays."""
    B = len(pairs)
    m_pad = max(len(q) for q, _ in pairs)
    n_max = max(len(t) for _, t in pairs)
    V = 2 * band + 1
    qs = np.full((B, m_pad), -1, np.int32)
    te = np.full((B, band + n_max + V + 1), -2, np.int32)
    ns = np.zeros(B, np.int32)
    ms = np.zeros(B, np.int32)
    ps = np.zeros((B, 8), np.float32)
    ps[:, :4] = [params.match, params.mismatch, params.gap_open,
                 params.gap_extend]
    if mode not in BANDED_MODES:
        raise ValueError(f"banded engine covers {BANDED_MODES}")
    for k, (q, t) in enumerate(pairs):
        if mode in ("global", "edit") and abs(len(t) - len(q)) > band:
            raise ValueError("band cannot contain the end cell")
        if mode == "fit" and len(q) > len(t):
            raise ValueError("first sequence must be shorter than the second")
        qs[k, : len(q)] = np.frombuffer(q, np.uint8)
        te[k, band : band + len(t)] = np.frombuffer(t, np.uint8)
        ns[k] = len(t)
        ms[k] = len(q)
        ps[k, 5] = len(q)
    out = jax.jit(
        jax.vmap(
            lambda q, t, n, p: banded_fill(mode, q, t, n, band, p)[:2]
        ),
    )(jnp.asarray(qs), jnp.asarray(te), jnp.asarray(ns), jnp.asarray(ps))
    return np.asarray(out[0], np.float64), np.asarray(out[1], np.float64)


def banded_score_auto(
    mode: str,
    q: bytes,
    t: bytes,
    params: AlignParams = AlignParams(),
    band0: int | None = None,
):
    """Score with band doubling — returns ``(score, band, certified)``.

    ``certified=True`` means the score is PROVABLY the exact unbanded
    score: either ``band_certificate`` discharged it (no out-of-band
    path can beat the banded optimum) or the band covered the whole
    matrix. While uncertified, the band keeps doubling even when the
    score plateaus — a plateau alone can be wrong (see the adversarial
    pairs in tests/test_banded.py), so it is reported, not trusted.
    """
    m, n = len(q), len(t)
    band = band0 if band0 is not None else max(32, abs(n - m) + 16)
    while True:
        band = min(band, max(m, n))
        score, _ = banded_score(mode, q, t, band, params)
        cert = band_certificate(mode, m, n, band, params)
        if mode == "edit":
            if score <= cert:
                return score, band, True
        elif score >= cert:
            return score, band, True
        if band >= max(m, n):
            return score, band, True  # band covers the whole matrix
        band *= 2


# ---------------------------------------------------------------------------
# Banded traceback (host walk over window-coordinate pointers)
# ---------------------------------------------------------------------------

_GAP = ord("-")


def _walk_banded(q, t, ptrs, band, mode, state, i, j):
    """Host pointer walk in window coordinates: cell (i, j) lives at
    ptrs[i-1, j - i + band]. Same packed-byte decode as the full engines
    (engine/traceback.py); same emission quirks (local HOME emits its
    diagonal pair then stops; global pads unconsumed prefixes; fit walks
    while i > 0 and never emits the target prefix; overlap walks its
    2-bit codes while j > 0)."""
    from aligntools_tpu.engine.traceback import _next_state

    r1, r2 = bytearray(), bytearray()
    if mode == "overlap":
        # linear-gap codes: 0 LEFT, 1 DIAGONAL, 2 RIGHT
        # (alignment.h:896-922); reaching row 0 with j > 0 is the
        # reference's infinite-loop hazard -> fail fast
        while j > 0:
            k = j - i + band
            if i <= 0 or not (0 <= k < ptrs.shape[1]):
                raise RuntimeError("banded overlap traceback hit the "
                                   "reference's unset-pointer hazard")
            code = int(ptrs[i - 1, k])
            if code == 0:  # LEFT
                j -= 1
                r1.append(_GAP)
                r2.append(t[j])
            elif code == 1:  # DIAGONAL
                i -= 1
                j -= 1
                r1.append(q[i])
                r2.append(t[j])
            elif code == 2:  # RIGHT
                i -= 1
                r1.append(q[i])
                r2.append(_GAP)
            else:
                raise RuntimeError("banded overlap traceback hit the "
                                   "reference's unset-pointer hazard")
        return bytes(reversed(r1)), bytes(reversed(r2))
    while i > 0 and (j > 0 or mode == "fit"):
        k = j - i + band
        if not (0 <= k < ptrs.shape[1]):
            raise RuntimeError("banded traceback left the band")
        byte = int(ptrs[i - 1, k])
        nxt = _next_state(byte, state)
        if state == 0:  # LOW
            i -= 1
            r1.append(q[i])
            r2.append(_GAP)
        elif state == 1:  # MID (HOME cells still emit, then stop)
            i -= 1
            j -= 1
            r1.append(q[i])
            r2.append(t[j])
        else:  # UPP
            j -= 1
            r1.append(_GAP)
            r2.append(t[j])
        state = nxt
        if nxt == -1:
            break
    if mode == "global":
        while j > 0:
            j -= 1
            r1.append(_GAP)
            r2.append(t[j])
        while i > 0:
            i -= 1
            r1.append(q[i])
            r2.append(_GAP)
    return bytes(reversed(r1)), bytes(reversed(r2))


def banded_align(
    mode: str,
    q: bytes,
    t: bytes,
    band: int,
    params: AlignParams = AlignParams(),
):
    """Banded alignment WITH rows; returns (AlignResult, edge_best).

    Rows are an optimal in-band alignment; they are byte-identical to the
    full engine whenever the band covers the whole matrix, and match it in
    practice whenever the optimal path is comfortably inside the band (an
    out-of-band candidate can in principle win a tie the band never sees).
    All modes with a traceback: global, local, fit (sans jump), overlap
    (edit has none — alignment.h:291-315).
    """
    results, edges = banded_align_batch(mode, [(q, t)], band, params)
    return results[0], float(edges[0])


def banded_align_batch(
    mode: str,
    pairs,
    band: int,
    params: AlignParams = AlignParams(),
):
    """Batched banded alignments WITH rows: one pointer-emitting vmapped
    XLA fill, then per-pair host walks over the
    (B, m_pad, V) window slabs. Returns ([AlignResult], edge_best
    array). Same in-band semantics as :func:`banded_align`."""
    from aligntools_tpu.spec.engine import AlignResult

    if mode not in ("global", "local", "fit", "overlap"):
        raise ValueError("banded traceback covers global/local/fit/overlap")
    B = len(pairs)
    m_pad = max(len(q) for q, _ in pairs)
    n_max = max(len(t) for _, t in pairs)
    V = 2 * band + 1
    qs = np.full((B, m_pad), -1, np.int32)
    te = np.full((B, band + n_max + V + 1), -2, np.int32)
    ns = np.zeros(B, np.int32)
    ms = np.zeros(B, np.int32)
    ps = np.zeros((B, 8), np.float32)
    ps[:, :4] = [params.match, params.mismatch, params.gap_open,
                 params.gap_extend]
    for k, (q, t) in enumerate(pairs):
        if mode == "global" and abs(len(t) - len(q)) > band:
            raise ValueError("band cannot contain the end cell")
        if mode == "fit" and len(q) > len(t):
            raise ValueError("first sequence must be shorter than the second")
        qs[k, : len(q)] = np.frombuffer(q, np.uint8)
        te[k, band : band + len(t)] = np.frombuffer(t, np.uint8)
        ns[k] = len(t)
        ms[k] = len(q)
        ps[k, 5] = len(q)
    score, edge, a, b, ptrs = jax.jit(
        jax.vmap(
            lambda q, t, n, p: banded_fill(mode, q, t, n, band, p, True)
        ),
    )(jnp.asarray(qs), jnp.asarray(te), jnp.asarray(ns), jnp.asarray(ps))
    score, a, b = np.asarray(score), np.asarray(a), np.asarray(b)
    ptrs = np.asarray(ptrs)
    out = []
    for k, (q, t) in enumerate(pairs):
        m, sk = len(q), float(score[k])
        if mode == "global":
            state, i0, j0 = int(a[k]), m, len(t)
        elif mode == "fit":
            if not np.isfinite(sk):
                raise RuntimeError(
                    "fit: no finite traceback start in band (reference UB)"
                )
            # a = use_l (L beat M) -> walk states LOW=0 / MID=1
            state, i0, j0 = (0 if int(a[k]) else 1), m, int(b[k])
        elif mode == "overlap":
            state, i0, j0 = 0, m, int(a[k])
            if j0 == 0:  # empty alignment (the j=0 zero-border start)
                out.append(AlignResult(sk, b"", b""))
                continue
        else:  # local
            i0, j0 = int(a[k]), int(b[k])
            state = 1  # MID
            if i0 == 0:
                out.append(AlignResult(sk, b"", b""))
                continue
        r1, r2 = _walk_banded(q, t, ptrs[k], band, mode, state, i0, j0)
        out.append(AlignResult(sk, r1, r2))
    return out, np.asarray(edge, np.float64)
