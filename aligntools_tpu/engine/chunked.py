"""Column-chunked XLA engine: the batched row scan in column chunks.

The plain XLA row-scan engine (engine/scan.py) carries (B, n_pad) state
rows through ``lax.scan``, one full-width row per scan step. This engine
fills the matrix in COLUMN CHUNKS of ``n_chunk`` (default_chunk())
columns instead: each chunk is a full ``lax.scan`` over rows with narrow (B, n_chunk) carries,
and the only state crossing chunks is each row's right-edge values —
(B, m_pad) arrays of the states with a horizontal/diagonal dependency:

  * diagonal:   best-of-states at (i-1, c0)     -> feeds M's first column
  * in-row U:   M(i, c0) and U(i, c0)           -> seed the max-plus scan
  * overlap:    M(i, c0)                         (single-matrix LEFT chain)
  * edit:       M(i, c0)                         (min-plus mirror)
  * fit jump:   J(i, c0)                          + the above

L (gap-in-target) is purely vertical and never crosses a chunk edge.
The per-chunk U/J scans stay exact because the max-plus normalization is
translation-invariant: with local column index j', V[j'] = U[c0+j'] -
e*j' and the edge seed enters as V[0] = U(i, c0). Score latches (the
(m, n) finals, local's running argmax, fit/overlap's row-m scans) carry
across chunks as (B,)-sized running values.

On the GPU it wins at large batches of short rows (engine/select.py
routes by the measured batch crossover); the vmap engine wins at small
batches and long rows (PERF.md, "Bring-up findings").

Exact f32 semantics, borders, masks, and tie behavior mirror
engine/scan.py's machines, which are parity-tested against the reference
binary (src/alignment.h:417-473, 805-847, 596-694, 926-964, 291-315).
The score fills need no tie-break handling (max is max); the
POINTER-EMITTING fills below (chunked_ptr_fill / chunked_fit_ptr_fill)
carry the per-state rows separately, reproduce every earliest-argument
tie code bit-for-bit in the machines' packed-byte format (scan.py module
docstring), and reproduce the traceback-start rules — global's L,M,U
final tie order, local's row-major strictly-greater running argmax
(lexicographic (value, i, j) fold across chunks), fit's M-beats-L row-m
scan with the last column excluded, overlap's j=0-inclusive scan — so
downstream walkers (engine/device_tb, engine/traceback) consume them
unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG = -jnp.inf

# widest of 512/1024/2048 won at both probed shapes on an H100 80GB HBM3
# (700 W): 42.0 vs 38.1 vs 28.2 GCUPS at 640 x 320 x 3072, 40.3 vs 26.1
# vs 16.9 at 256 x 2048^2 (PERF.md, "Bring-up findings")
DEFAULT_CHUNK = 2048


def default_chunk() -> int:
    """Production chunk width: env ALIGNTOOLS_CHUNK_WIDTH, then on the GPU
    the per-device calibrate table (``chunked_chunk``), then
    DEFAULT_CHUNK (measured: PERF.md, "Bring-up findings")."""
    import os

    env = os.environ.get("ALIGNTOOLS_CHUNK_WIDTH")
    if env:
        return max(128, int(env))
    from aligntools_tpu.backend import on_gpu

    if on_gpu():
        from aligntools_tpu.engine.autotune import table

        return int(table().get("chunked_chunk", DEFAULT_CHUNK))
    return DEFAULT_CHUNK


def pick_chunk(n_pad: int, n_chunk: int = DEFAULT_CHUNK) -> tuple[int, int]:
    """(nblk, chunk) with nblk*chunk >= n_pad, chunk a multiple of 128 as
    close to ``n_chunk`` as the block count allows (waste < 128*nblk)."""
    nblk = max(1, -(-n_pad // n_chunk))
    chunk = -(-(-(-n_pad // nblk)) // 128) * 128
    return nblk, chunk


def _pad_cols(x, total, fill):
    B, n = x.shape
    if n == total:
        return x
    return jnp.concatenate(
        [x, jnp.full((B, total - n), fill, x.dtype)], axis=1
    )


def _unroll() -> int:
    import os

    env = os.environ.get("ALIGNTOOLS_CHUNK_UNROLL")
    if env:
        return int(env)
    from aligntools_tpu.engine.scan import _unroll as u

    return u()


def _row_xs(q, *edges):
    """Per-row scan inputs: the row's query char + this row's edge seeds
    and the PREVIOUS row's diagonal edge (shifted down one row; the row-0
    value is supplied by the caller as ``edges[0]``'s first element)."""
    return tuple(a.T for a in (q,) + edges)  # (m_pad, B) each


def _shift_rows(edge, row0_val):
    """edge (B, m_pad) -> (B, m_pad) where row i holds edge[i-1]; row 0
    gets ``row0_val`` (scalar or (B,))."""
    B = edge.shape[0]
    first = jnp.broadcast_to(jnp.asarray(row0_val, edge.dtype), (B, 1))
    return jnp.concatenate([first, edge[:, :-1]], axis=1)


# ---------------------------------------------------------------------------
# global / local (3-state affine)  — alignment.h:417-473 / 805-847
# ---------------------------------------------------------------------------


def _affine_chunk(mode, q, t_blk, gj, m_col, n_col, params, carry,
                  lat_unmasked=False):
    """One chunk of the global/local fill. gj: (chunk,) global column
    indices (1-based) of this block. carry: (edge_best, edge_m, edge_u,
    fin(B,3)|best(B,)) — edges at the column just left of this block.

    ``lat_unmasked`` (local only): skip the per-row ``i <= m`` latch mask.
    Exact when mismatch/gap_open/gap_extend <= 0 and m >= 1: pad-row
    values are then bounded by the real running max — row m+1 satisfies
    M(m+1,j) = max(best(m,j-1)+mis, 0) <= max(Mmax+mis, 0) <= Mmax (the
    real Mmax is >= 0 with m,n >= 1, and L/U are M-prefix maxes plus
    non-positive gaps), and induction carries the bound through later
    pad rows and across chunk edges. The caller guards the params
    statically and fixes m == 0 pairs after the fold."""
    match, mis, o, e = params
    B, m_pad = q.shape
    chunk = t_blk.shape[1]
    gjf = gj.astype(jnp.float32)
    if mode == "global":
        # row-0 values at these global columns (alignment.h:437-441)
        m_init = jnp.full((B, chunk), NEG)
        l_init = jnp.full((B, chunk), NEG)
        u_init = o + e * jnp.broadcast_to(gjf, (B, chunk))
        best_init = u_init
        eq_n = gj[None, :] == n_col  # (B, chunk) final-column mask
        contains_n = (gj[0] <= n_col) & (n_col <= gj[-1])  # (B, 1)
    else:  # local: calloc-zero borders (alignment.h:805-847)
        m_init = jnp.zeros((B, chunk))
        l_init = jnp.zeros((B, chunk))
        u_init = jnp.zeros((B, chunk))
        best_init = jnp.zeros((B, chunk))
        col_real = gj[None, :] <= n_col

    edge_best, edge_m, edge_u, acc = carry
    # diagonal predecessor at (i-1, c0): shift edges down one row; the
    # row-0 edge value is max(L,M,U) at (0, c0) = the row-0 border there.
    c0 = gjf[0] - 1.0
    if mode == "global":
        row0_diag = jnp.where(c0 == 0.0, 0.0, o + e * c0)  # U(0,c0)|M(0,0)
    else:
        row0_diag = 0.0
    diag_edge = _shift_rows(edge_best, row0_diag)
    jloc = jnp.arange(1, chunk + 1, dtype=jnp.float32)

    def row(rc, xs):
        mp, lp, bestp, lat = rc
        qc, dedge, medge, uedge, iarr = xs  # (B,) each
        sub = jnp.where(t_blk == qc[:, None], match, mis)
        shifted_best = jnp.concatenate(
            [dedge[:, None], bestp[:, :-1]], axis=1
        )
        m_row = shifted_best + sub
        if mode == "local":
            m_row = jnp.maximum(m_row, 0.0)
        l_row = jnp.maximum(lp + e, mp + o)
        # U scan: V[j'] = U[c0+j'] - e*j'; V[0] = U(i, c0) = uedge;
        # cand[j'] = M(i, c0+j'-1) + o - e*j' with M at j'=1 from medge.
        shifted_m = jnp.concatenate([medge[:, None], m_row[:, :-1]], axis=1)
        cand = shifted_m + (o - e * jloc[None, :])
        v = jnp.maximum(jax.lax.cummax(cand, axis=1), uedge[:, None])
        u_row = v + e * jloc[None, :]
        best = jnp.maximum(jnp.maximum(m_row, l_row), u_row)
        i = iarr[:, None]  # (B,1) current row index (1-based)
        # latch whole ROWS here (selects only); the cross-lane reduces
        # happen once after the loop — a per-row masked reduce costs
        # ~2 extra full-width ops on the scan's critical path. Score-only
        # needs max(L,M,U) at (m,n), which IS best — the L/M/U split (the
        # final tie order) only matters for the ptr variant's start state.
        if mode == "global":
            lat = jnp.where(i == m_col, best, lat)
        elif lat_unmasked:
            lat = jnp.maximum(lat, m_row)
        else:
            lat = jnp.maximum(
                lat, jnp.where(i <= m_col, m_row, NEG)
            )
        ys = (m_row[:, -1], u_row[:, -1], best[:, -1])
        return (m_row, l_row, best, lat), ys

    lat0 = jnp.full((B, chunk), NEG)
    iarr = jnp.arange(1, m_pad + 1, dtype=jnp.int32)
    iarr = jnp.broadcast_to(iarr[None, :], (B, m_pad))
    xs = _row_xs(q.astype(jnp.float32), diag_edge, edge_m, edge_u,
                 iarr.astype(jnp.int32))
    (mrow, lrow, bestrow, lat), ys = jax.lax.scan(
        row, (m_init, l_init, best_init, lat0), xs, unroll=_unroll()
    )
    if mode == "global":
        here = jnp.max(jnp.where(eq_n, lat, NEG), axis=1)  # best at (m,n)
        # latch ONLY from the chunk whose columns contain n; m == 0
        # pairs keep their degenerate row-0 init (lat never fired)
        acc = jnp.where(contains_n[:, 0] & (m_col[:, 0] >= 1), here, acc)
    else:
        acc = jnp.maximum(
            acc, jnp.max(jnp.where(col_real, lat, NEG), axis=1)
        )
    em, eu, eb = (y.T for y in ys)  # (B, m_pad)
    return (eb, em, eu, acc)


def _affine_chunk0_edges(mode, B, m_pad, o, e):
    """Edge seeds at global column 0 (the col-0 borders)."""
    ii = jnp.arange(1, m_pad + 1, dtype=jnp.float32)[None, :]
    if mode == "global":
        # L(i,0)=o+e*i, M=U=-inf (alignment.h:432-436) -> best = L
        eb = jnp.broadcast_to(o + e * ii, (B, m_pad))
        em = jnp.full((B, m_pad), NEG)
        eu = jnp.full((B, m_pad), NEG)
    else:
        eb = jnp.zeros((B, m_pad))
        em = jnp.zeros((B, m_pad))
        eu = jnp.zeros((B, m_pad))
    return eb, em, eu


# ---------------------------------------------------------------------------
# overlap (single matrix, linear gap) — alignment.h:926-964
# ---------------------------------------------------------------------------


def _overlap_chunk(q, t_blk, gj, m_col, n_col, params, carry):
    match, mis, o = params
    B, m_pad = q.shape
    chunk = t_blk.shape[1]
    gjf = gj.astype(jnp.float32)
    m_init = jnp.full((B, chunk), NEG)  # row 0 = -inf (cols >= 1)
    lt_n = gj[None, :] <= n_col - 1  # scan cols j in [1, n-1]
    edge_m, acc = carry
    c0 = gjf[0] - 1.0
    row0_diag = jnp.where(c0 == 0.0, 0.0, NEG)  # M(0,0)=0, row0 else -inf
    diag_edge = _shift_rows(edge_m, row0_diag)
    jloc = jnp.arange(1, chunk + 1, dtype=jnp.float32)

    def row(rc, xs):
        mp, lat = rc
        qc, dedge, medge, iarr = xs
        sub = jnp.where(t_blk == qc[:, None], match, mis)
        diag = jnp.concatenate([dedge[:, None], mp[:, :-1]], axis=1) + sub
        dr = jnp.maximum(diag, mp + o)
        # LEFT chain: M[i,j] = max(M[i,j-1]+o, dr[j]); seed M(i, c0).
        # col-0 border M(i,0)=0 is the chunk-0 edge seed (edge_m init).
        cand = dr - o * jloc[None, :]
        v = jnp.maximum(jax.lax.cummax(cand, axis=1), medge[:, None])
        m_row = v + o * jloc[None, :]
        # latch the whole row-m ROW; reduce once after the loop
        lat = jnp.where(iarr[:, None] == m_col, m_row, lat)
        return (m_row, lat), m_row[:, -1]

    lat0 = jnp.full((B, chunk), NEG)
    iarr = jnp.broadcast_to(
        jnp.arange(1, m_pad + 1, dtype=jnp.int32)[None, :], (B, m_pad)
    )
    xs = _row_xs(q.astype(jnp.float32), diag_edge, edge_m, iarr)
    (mrow, lat), em = jax.lax.scan(
        row, (m_init, lat0), xs, unroll=_unroll()
    )
    acc = jnp.maximum(acc, jnp.max(jnp.where(lt_n, lat, NEG), axis=1))
    return (em.T, acc)


# ---------------------------------------------------------------------------
# edit distance (min-plus) — alignment.h:291-315
# ---------------------------------------------------------------------------


def _edit_chunk(q, t_blk, gj, m_col, n_col, params, carry):
    u = params[0]
    B, m_pad = q.shape
    chunk = t_blk.shape[1]
    gjf = gj.astype(jnp.float32)
    row0 = jnp.broadcast_to(gjf, (B, chunk))  # M(0,j) = j
    eq_n = gj[None, :] == n_col
    contains_n = (gj[0] <= n_col[:, 0]) & (n_col[:, 0] <= gj[-1])  # (B,)
    edge_m, acc = carry
    c0 = gjf[0] - 1.0
    diag_edge = _shift_rows(edge_m, c0)  # M(0, c0) = c0
    jloc = jnp.arange(1, chunk + 1, dtype=jnp.float32)

    def row(rc, xs):
        mp, lat = rc
        qc, dedge, medge, iarr = xs
        sub = jnp.where(t_blk == qc[:, None], 0.0, u)
        diag = jnp.concatenate([dedge[:, None], mp[:, :-1]], axis=1) + sub
        cand0 = jnp.minimum(diag, mp + 1.0)
        # row[j] = min(cand0[j], row[j-1]+1): slope-1 min-plus scan,
        # seed M(i, c0) (chunk 0: the col-0 border M(i,0)=i).
        cand = cand0 - jloc[None, :]
        v = jnp.minimum(jax.lax.cummin(cand, axis=1), medge[:, None])
        m_row = v + jloc[None, :]
        # latch the whole row-m ROW; reduce once after the loop
        lat = jnp.where(iarr[:, None] == m_col, m_row, lat)
        return (m_row, lat), m_row[:, -1]

    lat0 = jnp.full((B, chunk), jnp.inf)
    iarr = jnp.broadcast_to(
        jnp.arange(1, m_pad + 1, dtype=jnp.int32)[None, :], (B, m_pad)
    )
    xs = _row_xs(q.astype(jnp.float32), diag_edge, edge_m, iarr)
    (mrow, lat), em = jax.lax.scan(row, (row0, lat0), xs,
                                   unroll=_unroll())
    fin = jnp.min(jnp.where(eq_n, lat, jnp.inf), axis=1)
    # latch only in the chunk containing column n; m == 0 pairs keep
    # their M(0, n) = n init (lat never fired)
    acc = jnp.where(contains_n & (m_col[:, 0] >= 1), fin, acc)
    return (em.T, acc)


# ---------------------------------------------------------------------------
# fit (M/L/U + optional junction-gated J) — alignment.h:596-694
# ---------------------------------------------------------------------------


def _fit_chunk(use_jump, q, t_blk, allow_blk, gj, m_col, n_col, params,
               carry):
    match, mis, o, e, jp = params
    B, m_pad = q.shape
    chunk = t_blk.shape[1]
    # row 0: M = U = 0, L = J = -inf (alignment.h:619-624)
    m_init = jnp.zeros((B, chunk))
    l_init = jnp.full((B, chunk), NEG)
    u_init = jnp.zeros((B, chunk))
    j_init = jnp.full((B, chunk), NEG)
    best_init = jnp.zeros((B, chunk))  # max of row-0 states
    lt_n = gj[None, :] <= n_col - 1  # row-m scan: j in [1, n-1]
    edge_best, edge_m, edge_u, edge_j, accM, accL = carry
    # diag at (i-1, c0): row-0 value = M(0,c0)=U(0,c0)=0 (incl. c0=0:
    # the row-0 loop overwrites M(0,0)=U(0,0)=0, alignment.h:619-624)
    diag_edge = _shift_rows(edge_best, 0.0)
    jloc = jnp.arange(1, chunk + 1, dtype=jnp.float32)

    def row(rc, xs):
        mp, lp, up, jpr, bestp, latM, latL = rc
        qc, dedge, medge, uedge, jedge, iarr = xs
        sub = jnp.where(t_blk == qc[:, None], match, mis)
        shifted_best = jnp.concatenate(
            [dedge[:, None], bestp[:, :-1]], axis=1
        )
        m_row = shifted_best + sub
        l_row = jnp.maximum(lp + e, mp + o)
        shifted_m = jnp.concatenate([medge[:, None], m_row[:, :-1]], axis=1)
        cand = shifted_m + (o - e * jloc[None, :])
        v = jnp.maximum(jax.lax.cummax(cand, axis=1), uedge[:, None])
        u_row = v + e * jloc[None, :]
        if use_jump:
            # J[j] = max(gated M(i,j-1)+jump, J[j-1]); no slope (free
            # horizontal extension) -> plain cummax with seed J(i, c0).
            jc = jnp.where(allow_blk, shifted_m + jp, NEG)
            j_row = jnp.maximum(
                jax.lax.cummax(jc, axis=1), jedge[:, None]
            )
            best = jnp.maximum(
                jnp.maximum(m_row, l_row), jnp.maximum(u_row, j_row)
            )
        else:
            j_row = jnp.broadcast_to(jedge[:, None], m_row.shape)
            best = jnp.maximum(jnp.maximum(m_row, l_row), u_row)
        # latch whole row-m ROWS (selects only); reduce after the loop
        at_m = iarr[:, None] == m_col
        latM = jnp.where(at_m, m_row, latM)
        latL = jnp.where(at_m, l_row, latL)
        ys = (m_row[:, -1], u_row[:, -1], j_row[:, -1], best[:, -1])
        return (m_row, l_row, u_row, j_row, best, latM, latL), ys

    lat0 = jnp.full((B, chunk), NEG)
    iarr = jnp.broadcast_to(
        jnp.arange(1, m_pad + 1, dtype=jnp.int32)[None, :], (B, m_pad)
    )
    xs = _row_xs(q.astype(jnp.float32), diag_edge, edge_m, edge_u, edge_j,
                 iarr)
    (mr, lr, ur, jr, br, latM, latL), ys = jax.lax.scan(
        row,
        (m_init, l_init, u_init, j_init, best_init, lat0, lat0),
        xs,
        unroll=_unroll(),
    )
    accM = jnp.maximum(accM, jnp.max(jnp.where(lt_n, latM, NEG), axis=1))
    accL = jnp.maximum(accL, jnp.max(jnp.where(lt_n, latL, NEG), axis=1))
    em, eu, ej, eb = (y.T for y in ys)
    return (eb, em, eu, ej, accM, accL)


# ---------------------------------------------------------------------------
# public batched fills
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(0, 4),
                   static_argnames=("decaying_params",))
def chunked_scores(mode, qs, ts, ns, n_chunk=DEFAULT_CHUNK, params=None,
                   decaying_params=False):
    """Batched score-only fill, column-chunked. qs (B, m_pad) i32 (pad
    < 0), ts (B, n_pad) i32 (pad -2), ns (B,) i32 true target lengths,
    params (B, 6) f32 [match, mis, o, e, jump, m] (same layout as
    engine/scan.py fills; per-pair m in params[:, 5]).

    ``decaying_params`` (STATIC): the caller asserts mismatch, gap_open
    and gap_extend are all <= 0 — local then skips its per-row latch
    mask (see _affine_chunk.lat_unmasked), with m == 0 pairs fixed after
    the fold. Passing it with positive penalties corrupts local scores.

    Returns (B,) f32 scores (edit: the float value at (m, n))."""
    B, m_pad = qs.shape
    n_pad = ts.shape[1]
    nblk, chunk = pick_chunk(n_pad, n_chunk)
    ts = _pad_cols(ts, nblk * chunk, -2)
    match, mis = params[0, 0], params[0, 1]
    o, e = params[0, 2], params[0, 3]
    m_col = params[:, 5:6].astype(jnp.int32)  # (B, 1)
    n_col = ns[:, None].astype(jnp.int32)
    t_blks = ts.reshape(B, nblk, chunk).transpose(1, 0, 2)
    offs = jnp.arange(nblk, dtype=jnp.int32) * chunk

    if mode in ("global", "local"):
        p = (match, mis, o, e)
        eb, em, eu = _affine_chunk0_edges(mode, B, m_pad, o, e)
        if mode == "global":
            # m==0 degenerate: score = max of the row-0 borders at column
            # n — max(L,M,U)(0,n) = U(0,n) = o+e*n (or 0 at n==0, from
            # M(0,0)=0 vs L(0,0)=U(0,0)=o with o <= 0; exactness for the
            # pathological o > 0 is preserved by taking the real max)
            nf = ns.astype(jnp.float32)
            acc0 = jnp.where(
                ns == 0,
                jnp.maximum(0.0, o),
                o + e * nf,
            )
        else:
            acc0 = jnp.full((B,), NEG)

        unmask = decaying_params and mode == "local"

        def blk(carry, xs):
            t_blk, off = xs
            gj = off + jnp.arange(1, chunk + 1, dtype=jnp.int32)
            return (
                _affine_chunk(mode, qs, t_blk, gj, m_col, n_col, p, carry,
                              lat_unmasked=unmask),
                None,
            )

        carry, _ = jax.lax.scan(blk, (eb, em, eu, acc0), (t_blks, offs))
        acc = carry[3]
        if unmask:
            # the unmasked latch picks up pad-row values for m == 0
            # pairs (whose true score is -inf: no real cells)
            acc = jnp.where(m_col[:, 0] >= 1, acc, NEG)
        return acc

    if mode == "overlap":
        p = (match, mis, o)
        em = jnp.zeros((B, m_pad))  # col-0 border M(i,0)=0
        # j=0 border M(m,0)=0 is inside the start scan [0, n-1] iff n >= 1
        acc0 = jnp.where(ns >= 1, 0.0, NEG)

        def blk(carry, xs):
            t_blk, off = xs
            gj = off + jnp.arange(1, chunk + 1, dtype=jnp.int32)
            return (
                _overlap_chunk(qs, t_blk, gj, m_col, n_col, p, carry),
                None,
            )

        carry, _ = jax.lax.scan(blk, (em, acc0), (t_blks, offs))
        return carry[1]

    if mode == "edit":
        u = params[0, 1]
        ii = jnp.arange(1, m_pad + 1, dtype=jnp.float32)
        em = jnp.broadcast_to(ii[None, :], (B, m_pad))  # M(i,0)=i
        acc0 = ns.astype(jnp.float32)  # m==0 degenerate: M(0,n)=n

        def blk(carry, xs):
            t_blk, off = xs
            gj = off + jnp.arange(1, chunk + 1, dtype=jnp.int32)
            return (
                _edit_chunk(qs, t_blk, gj, m_col, n_col, (u,), carry),
                None,
            )

        carry, _ = jax.lax.scan(blk, (em, acc0), (t_blks, offs))
        return carry[1]

    raise ValueError(mode)


@functools.partial(jax.jit, static_argnums=(0, 5))
def chunked_fit_scores(use_jump, qs, ts, allow, ns, n_chunk=DEFAULT_CHUNK,
                       params=None):
    """Fit-mode batched score fill (+ optional junction jump). allow
    (B, n_pad) bool: jump ENTRY permitted at that column (True where
    (j-1) is NOT a junction site — the reference's inverted enum-bool
    gating, alignment.h:657-667; see spec.engine._jscan)."""
    B, m_pad = qs.shape
    n_pad = ts.shape[1]
    nblk, chunk = pick_chunk(n_pad, n_chunk)
    ts = _pad_cols(ts, nblk * chunk, -2)
    allow = _pad_cols(allow.astype(jnp.bool_), nblk * chunk, False)
    match, mis = params[0, 0], params[0, 1]
    o, e, jp = params[0, 2], params[0, 3], params[0, 4]
    m_col = params[:, 5:6].astype(jnp.int32)
    n_col = ns[:, None].astype(jnp.int32)
    t_blks = ts.reshape(B, nblk, chunk).transpose(1, 0, 2)
    a_blks = allow.reshape(B, nblk, chunk).transpose(1, 0, 2)
    offs = jnp.arange(nblk, dtype=jnp.int32) * chunk
    p = (match, mis, o, e, jp)

    # col-0 edges: all four states -inf for i >= 1 (alignment.h:612-617)
    neg = jnp.full((B, m_pad), NEG)
    # m==0 degenerate: the row-m scan runs over row 0, j in [0, n-1],
    # where M(0,j)=0 (incl. the overwritten M(0,0)=0) -> 0 iff n >= 1
    acc0M = jnp.where((m_col[:, 0] == 0) & (ns >= 1), 0.0, NEG)
    acc0L = jnp.full((B,), NEG)

    def blk(carry, xs):
        t_blk, a_blk, off = xs
        gj = off + jnp.arange(1, chunk + 1, dtype=jnp.int32)
        return (
            _fit_chunk(use_jump, qs, t_blk, a_blk, gj, m_col, n_col, p,
                       carry),
            None,
        )

    carry, _ = jax.lax.scan(
        blk, (neg, neg, neg, neg, acc0M, acc0L), (t_blks, a_blks, offs)
    )
    accM, accL = carry[4], carry[5]
    # tie: M beats L (strict >, alignment.h:676-690) — score is the max
    return jnp.maximum(accM, accL)


# ---------------------------------------------------------------------------
# pointer-emitting fills (packed-byte format of engine/scan.py)
# ---------------------------------------------------------------------------

from aligntools_tpu.engine.scan import (  # noqa: E402
    PK_L_IS_MID,
    PK_J_IS_JUMP,
    PK_M_HOME,
    PK_M_JUMP,
    PK_M_LOW,
    PK_M_MID,
    PK_M_UNSET,
    PK_M_UPP,
    PK_OV_DIAG,
    PK_OV_LEFT,
    PK_OV_RIGHT,
    PK_OV_UNSET,
    PK_U_IS_UPP,
)


def _shift_cols(row, edge_col):
    """(B, chunk) -> value at the previous column; lane 0 gets the edge."""
    return jnp.concatenate([edge_col[:, None], row[:, :-1]], axis=1)


def _m_codes(prevs, codes, unset=None):
    """Batched _m_candidates (scan.py): earliest-argument argmax codes.
    ``prevs``: list of (B, chunk) diagonal predecessor values in max5
    argument order. Returns (best, code with ``unset`` on -inf)."""
    if unset is None:
        unset = PK_M_UNSET
    vals = jnp.stack(prevs)
    best = vals.max(axis=0)
    code = jnp.asarray(codes, jnp.uint8)[jnp.argmax(vals, axis=0)]
    code = jnp.where(best > NEG, code, jnp.uint8(unset))
    return best, code


def _ptr_fields(mode, rpb):
    """Pointer-byte field layout for a chunk-ptr row step.

    rpb == 1: the engine/scan.py packed-byte layout (3-bit pM at bits
    0-2, pL/pU/pJ flags at bits 3/4/5). rpb == 2: the nibble layout —
    pM is 2 bits because code 3 doubles as the
    mode's fourth value (HOME for local, UNSET for global/fit-nojump),
    pL/pU at bits 2/3, no jump state; engine/device_tb decodes both."""
    if rpb == 2:
        return dict(LOW=0, MID=1, UPP=2, HOME=3, UNSET=3,
                    LBIT=1 << 2, UBIT=1 << 3)
    return dict(LOW=PK_M_LOW, MID=PK_M_MID, UPP=PK_M_UPP, HOME=PK_M_HOME,
                UNSET=PK_M_UNSET, LBIT=PK_L_IS_MID, UBIT=PK_U_IS_UPP)


def _scan_rows_packed(row_fn, carry, xs, G, unroll):
    """Scan the per-row step in groups of ``G`` rows, OR-combining each
    row's final ys leaf (its code plane, shifted by in-group row index *
    (8 // G) bits) into ONE packed byte plane per step — so the scan's ys
    buffer IS the packed pointer tensor and the unpacked bytes never
    materialize in HBM. Other ys leaves (the per-row chunk-edge values)
    are stacked per group and reshaped back to per-row after the scan.
    G == 1 falls through to a plain scan (byte layout)."""
    if G == 1:
        return jax.lax.scan(row_fn, carry, xs, unroll=unroll)
    bits = 8 // G
    xs_g = jax.tree.map(
        lambda a: a.reshape((a.shape[0] // G, G) + a.shape[1:]), xs
    )

    def step(c, xg):
        edges, plane = [], None
        for g in range(G):
            c, y = row_fn(c, jax.tree.map(lambda a: a[g], xg))
            code = y[-1]
            plane = code if g == 0 else plane | (code << (bits * g))
            edges.append(y[:-1])
        ys = tuple(jnp.stack(parts) for parts in zip(*edges)) + (plane,)
        return c, ys

    carry, ys = jax.lax.scan(step, carry, xs_g,
                             unroll=max(1, unroll // G))
    flat = tuple(a.reshape((-1,) + a.shape[2:]) for a in ys[:-1])
    return carry, flat + (ys[-1],)


def _lexi_update(best, imax, jmax, rb, ri, rj):
    """Fold one row-candidate into the running row-major argmax: the
    machines scan row-major with strict >, so the winner is the FIRST
    cell in row-major order achieving the global max — across chunks
    (where i restarts) that is the lexicographically smallest (i, j)
    among maximal cells. Within a chunk rows ascend and the in-row
    argmax already picks the smallest j, so (i == imax) can only recur
    with a larger j; only value and i need comparing."""
    upd = (rb > best) | ((rb == best) & (ri < imax))
    return (
        jnp.where(upd, rb, best),
        jnp.where(upd, ri, imax),
        jnp.where(upd, rj, jmax),
    )


def _affine_chunk_ptr(mode, q, t_blk, gj, m_col, n_col, params, carry,
                      rpb=1):
    """Pointer-emitting global/local chunk (score logic mirrors
    _affine_chunk; state rows carried separately for the tie codes).
    ``rpb``: DP rows per emitted pointer byte (1 = byte layout, 2 =
    nibble; see _ptr_fields)."""
    pk = _ptr_fields(mode, rpb)
    match, mis, o, e = params
    B, m_pad = q.shape
    chunk = t_blk.shape[1]
    gjf = gj.astype(jnp.float32)
    c0 = gjf[0] - 1.0
    jloc = jnp.arange(1, chunk + 1, dtype=jnp.float32)
    if mode == "global":
        m_init = jnp.full((B, chunk), NEG)
        l_init = jnp.full((B, chunk), NEG)
        u_init = o + e * jnp.broadcast_to(gjf, (B, chunk))
        eq_n = gj[None, :] == n_col
        contains_n = (gj[0] <= n_col) & (n_col <= gj[-1])
        # row-0 diag values at column c0 per state (alignment.h:428-441)
        dl0 = jnp.where(c0 == 0.0, o, NEG)
        dm0 = jnp.where(c0 == 0.0, 0.0, NEG)
        du0 = jnp.where(c0 == 0.0, o, o + e * c0)
    else:  # local calloc-zero borders
        m_init = jnp.zeros((B, chunk))
        l_init = jnp.zeros((B, chunk))
        u_init = jnp.zeros((B, chunk))
        col_real = gj[None, :] <= n_col
        dl0 = dm0 = du0 = 0.0

    edge_l, edge_m, edge_u, acc = carry
    diag_l = _shift_rows(edge_l, dl0)
    diag_m = _shift_rows(edge_m, dm0)
    diag_u = _shift_rows(edge_u, du0)

    def row(rc, xs):
        mp, lp, up, acc = rc
        qc, dle, dme, due, medge, uedge, iarr = xs
        sub = jnp.where(t_blk == qc[:, None], match, mis)
        dl = _shift_cols(lp, dle)
        dm = _shift_cols(mp, dme)
        du = _shift_cols(up, due)
        if mode == "global":
            # arg order L, M, U (alignment.h:451)
            best_d, pm = _m_codes([dl, dm, du],
                                  (pk["LOW"], pk["MID"], pk["UPP"]),
                                  unset=pk["UNSET"])
            m_row = best_d + sub
        else:
            # arg order L+s, M+s, U+s, 0 (HOME) — alignment.h:825
            vals = jnp.stack(
                [dl + sub, dm + sub, du + sub, jnp.zeros_like(sub)]
            )
            m_row = vals.max(axis=0)
            pm = jnp.asarray(
                (pk["LOW"], pk["MID"], pk["UPP"], pk["HOME"]), jnp.uint8
            )[jnp.argmax(vals, axis=0)]
        a = lp + e
        bb = mp + o
        l_row = jnp.maximum(a, bb)
        plbit = jnp.where(a >= bb, jnp.uint8(0), jnp.uint8(pk["LBIT"]))
        shifted_m = _shift_cols(m_row, medge)
        cand = shifted_m + (o - e * jloc[None, :])
        v = jnp.maximum(jax.lax.cummax(cand, axis=1), uedge[:, None])
        u_row = v + e * jloc[None, :]
        a2 = shifted_m + o
        b2 = _shift_cols(u_row, uedge) + e
        pubit = jnp.where(a2 >= b2, jnp.uint8(0), jnp.uint8(pk["UBIT"]))
        packed = pm | plbit | pubit
        i = iarr[:, None]
        if mode == "global":
            here = jnp.stack(
                [
                    jnp.max(jnp.where(eq_n, l_row, NEG), axis=1),
                    jnp.max(jnp.where(eq_n, m_row, NEG), axis=1),
                    jnp.max(jnp.where(eq_n, u_row, NEG), axis=1),
                ],
                axis=1,
            )
            acc = jnp.where((i == m_col) & contains_n, here, acc)
        else:
            masked = jnp.where(col_real & (i <= m_col), m_row, NEG)
            rb = jnp.max(masked, axis=1)
            rj = gj[jnp.argmax(masked, axis=1)]
            acc = _lexi_update(*acc, rb, iarr, rj)
        ys = (m_row[:, -1], l_row[:, -1], u_row[:, -1], packed)
        return (m_row, l_row, u_row, acc), ys

    iarr = jnp.broadcast_to(
        jnp.arange(1, m_pad + 1, dtype=jnp.int32)[None, :], (B, m_pad)
    )
    xs = _row_xs(q.astype(jnp.float32), diag_l, diag_m, diag_u, edge_m,
                 edge_u, iarr)
    (mr, lr, ur, acc), ys = _scan_rows_packed(
        row, (m_init, l_init, u_init, acc), xs, rpb, _unroll()
    )
    em, el, eu, packed = ys[0].T, ys[1].T, ys[2].T, ys[3]
    return (el, em, eu, acc), packed  # packed: (m_pad/rpb, B, chunk)


def _overlap_chunk_ptr(q, t_blk, gj, m_col, n_col, params, carry, rpb=1):
    """Pointer-emitting overlap chunk (codes: LEFT, DIAGONAL, RIGHT
    argument order, alignment.h:944; UNSET on -inf). Codes are 2 bits,
    so ``rpb`` may be 1, 2, or 4 (row rpb*k in the low bits)."""
    match, mis, o = params
    B, m_pad = q.shape
    chunk = t_blk.shape[1]
    gjf = gj.astype(jnp.float32)
    c0 = gjf[0] - 1.0
    jloc = jnp.arange(1, chunk + 1, dtype=jnp.float32)
    m_init = jnp.full((B, chunk), NEG)
    lt_n = gj[None, :] <= n_col - 1
    edge_m, acc = carry
    diag_edge = _shift_rows(edge_m, jnp.where(c0 == 0.0, 0.0, NEG))

    def row(rc, xs):
        mp, acc = rc
        qc, dedge, medge, iarr = xs
        sub = jnp.where(t_blk == qc[:, None], match, mis)
        diag = _shift_cols(mp, dedge) + sub
        right = mp + o
        dr = jnp.maximum(diag, right)
        cand = dr - o * jloc[None, :]
        v = jnp.maximum(jax.lax.cummax(cand, axis=1), medge[:, None])
        m_row = v + o * jloc[None, :]
        a = _shift_cols(m_row, medge) + o
        val = jnp.maximum(a, dr)
        code = jnp.where(
            a >= val,
            jnp.uint8(PK_OV_LEFT),
            jnp.where(diag >= right, jnp.uint8(PK_OV_DIAG),
                      jnp.uint8(PK_OV_RIGHT)),
        )
        code = jnp.where(val > NEG, code, jnp.uint8(PK_OV_UNSET))
        at_m = iarr[:, None] == m_col
        masked = jnp.where(lt_n & at_m, m_row, NEG)
        rb = jnp.max(masked, axis=1)
        rj = gj[jnp.argmax(masked, axis=1)]
        best, jmax = acc
        upd = rb > best  # strictly greater: earlier (smaller j) wins ties
        acc = (jnp.where(upd, rb, best), jnp.where(upd, rj, jmax))
        return (m_row, acc), (m_row[:, -1], code)

    iarr = jnp.broadcast_to(
        jnp.arange(1, m_pad + 1, dtype=jnp.int32)[None, :], (B, m_pad)
    )
    xs = _row_xs(q.astype(jnp.float32), diag_edge, edge_m, iarr)
    (mr, acc), ys = _scan_rows_packed(row, (m_init, acc), xs, rpb,
                                      _unroll())
    return (ys[0].T, acc), ys[1]


def _fit_chunk_ptr(use_jump, q, t_blk, allow_blk, gj, m_col, n_col, params,
                   carry, rpb=1):
    """Pointer-emitting fit chunk (M arg order L,M,U[,J]; J entry gating
    with the inverted enum-bool semantics; alignment.h:596-694).
    ``rpb`` == 2 (nibble) only without the jump state — pM spans 5
    values with J and pJ needs its own bit)."""
    assert rpb == 1 or not use_jump
    pk = _ptr_fields("fit", rpb)
    match, mis, o, e, jp = params
    B, m_pad = q.shape
    chunk = t_blk.shape[1]
    jloc = jnp.arange(1, chunk + 1, dtype=jnp.float32)
    m_init = jnp.zeros((B, chunk))
    l_init = jnp.full((B, chunk), NEG)
    u_init = jnp.zeros((B, chunk))
    j_init = jnp.full((B, chunk), NEG)
    lt_n = gj[None, :] <= n_col - 1
    edge_l, edge_m, edge_u, edge_j, accM, accL = carry
    # row-0 diag values: M(0,c0)=U(0,c0)=0 (incl. c0=0), L=J=-inf
    diag_l = _shift_rows(edge_l, NEG)
    diag_m = _shift_rows(edge_m, 0.0)
    diag_u = _shift_rows(edge_u, 0.0)
    diag_j = _shift_rows(edge_j, NEG)

    def row(rc, xs):
        mp, lp, up, jpr, accM, accL = rc
        qc, dle, dme, due, dje, medge, uedge, jedge, iarr = xs
        sub = jnp.where(t_blk == qc[:, None], match, mis)
        dl = _shift_cols(lp, dle)
        dm = _shift_cols(mp, dme)
        du = _shift_cols(up, due)
        if use_jump:  # arg order L, M, U, J (alignment.h:635)
            dj = _shift_cols(jpr, dje)
            best_d, pm = _m_codes(
                [dl, dm, du, dj],
                (PK_M_LOW, PK_M_MID, PK_M_UPP, PK_M_JUMP),
            )
        else:  # arg order L, M, U (alignment.h:641)
            best_d, pm = _m_codes([dl, dm, du],
                                  (pk["LOW"], pk["MID"], pk["UPP"]),
                                  unset=pk["UNSET"])
        m_row = best_d + sub
        a = lp + e
        bb = mp + o
        l_row = jnp.maximum(a, bb)
        plbit = jnp.where(a >= bb, jnp.uint8(0), jnp.uint8(pk["LBIT"]))
        shifted_m = _shift_cols(m_row, medge)
        cand = shifted_m + (o - e * jloc[None, :])
        v = jnp.maximum(jax.lax.cummax(cand, axis=1), uedge[:, None])
        u_row = v + e * jloc[None, :]
        a2 = shifted_m + o
        b2 = _shift_cols(u_row, uedge) + e
        pubit = jnp.where(a2 >= b2, jnp.uint8(0), jnp.uint8(pk["UBIT"]))
        if use_jump:
            jc = jnp.where(allow_blk, shifted_m + jp, NEG)
            j_row = jnp.maximum(jax.lax.cummax(jc, axis=1),
                                jedge[:, None])
            b3 = _shift_cols(j_row, jedge)
            pjbit = jnp.where(
                (jc > NEG) & (jc >= b3), jnp.uint8(0),
                jnp.uint8(PK_J_IS_JUMP),
            )
        else:
            j_row = jnp.broadcast_to(jedge[:, None], m_row.shape)
            pjbit = jnp.zeros_like(pm)
        packed = pm | plbit | pubit | pjbit
        at_m = iarr[:, None] == m_col
        mmask = jnp.where(lt_n & at_m, m_row, NEG)
        lmask = jnp.where(lt_n & at_m, l_row, NEG)
        mb = jnp.max(mmask, axis=1)
        mj = gj[jnp.argmax(mmask, axis=1)]
        lb = jnp.max(lmask, axis=1)
        lj = gj[jnp.argmax(lmask, axis=1)]
        bM, jM = accM
        updM = mb > bM  # strict >: smallest j wins (alignment.h:676-690)
        accM = (jnp.where(updM, mb, bM), jnp.where(updM, mj, jM))
        bL, jL = accL
        updL = lb > bL
        accL = (jnp.where(updL, lb, bL), jnp.where(updL, lj, jL))
        ys = (m_row[:, -1], l_row[:, -1], u_row[:, -1], j_row[:, -1],
              packed)
        return (m_row, l_row, u_row, j_row, accM, accL), ys

    iarr = jnp.broadcast_to(
        jnp.arange(1, m_pad + 1, dtype=jnp.int32)[None, :], (B, m_pad)
    )
    xs = _row_xs(q.astype(jnp.float32), diag_l, diag_m, diag_u, diag_j,
                 edge_m, edge_u, edge_j, iarr)
    (mr, lr, ur, jr, accM, accL), ys = _scan_rows_packed(
        row, (m_init, l_init, u_init, j_init, accM, accL), xs, rpb,
        _unroll(),
    )
    em, el, eu, ej = ys[0].T, ys[1].T, ys[2].T, ys[3].T
    return (el, em, eu, ej, accM, accL), ys[4]


def _assemble_ptrs(packed_blocks, B, m_pad, n_pad):
    """(nblk, m_pad, B, chunk) packed bytes -> (B, m_pad, n_pad+1) with
    the machines' zero column 0 prepended."""
    nblk, _, _, chunk = packed_blocks.shape
    p = packed_blocks.transpose(2, 1, 0, 3).reshape(B, m_pad, nblk * chunk)
    p = p[:, :, :n_pad]
    z = jnp.zeros((B, m_pad, 1), jnp.uint8)
    return jnp.concatenate([z, p], axis=2)


@functools.partial(jax.jit, static_argnums=(0, 4, 5))
def chunked_ptr_fill(mode, qs, ts, ns, n_chunk=DEFAULT_CHUNK,
                     rows_per_byte=1, params=None):
    """Pointer-emitting batched fill; returns the vmapped engine/scan.py
    fill tuple per mode (so batch.py's traceback plumbing is unchanged):
      global:  (score, start_state 0/1/2=L/M/U, ptrs [B, m_pad, n_pad+1])
      local:   (score, i_max, j_max, ptrs)
      overlap: (score, j_max, ptrs)

    ``rows_per_byte`` > 1 packs 2 (nibble; global/local) or 4 (2-bit;
    overlap) DP rows per pointer byte INSIDE the row scan and returns the
    raw packed block tensor (nblk, m_pad/rpb, B, chunk) — columns 1..n
    only, NO assembling transpose — so peak HBM is exactly the packed
    bytes. engine/device_tb walks that layout directly (blk_chunk=chunk,
    col_base=1). m_pad must be a multiple of rows_per_byte.
    """
    B, m_pad = qs.shape
    n_pad = ts.shape[1]
    rpb = rows_per_byte
    if m_pad % rpb:
        raise ValueError(f"m_pad {m_pad} not a multiple of rpb {rpb}")
    if rpb == 4 and mode != "overlap":
        raise ValueError("rows_per_byte=4 is overlap-only (2-bit codes)")
    nblk, chunk = pick_chunk(n_pad, n_chunk)
    ts = _pad_cols(ts, nblk * chunk, -2)
    match, mis = params[0, 0], params[0, 1]
    o, e = params[0, 2], params[0, 3]
    m_col = params[:, 5:6].astype(jnp.int32)
    n_col = ns[:, None].astype(jnp.int32)
    t_blks = ts.reshape(B, nblk, chunk).transpose(1, 0, 2)
    offs = jnp.arange(nblk, dtype=jnp.int32) * chunk

    if mode in ("global", "local"):
        p = (match, mis, o, e)
        ii = jnp.arange(1, m_pad + 1, dtype=jnp.float32)[None, :]
        if mode == "global":
            el = jnp.broadcast_to(o + e * ii, (B, m_pad))
            em = jnp.full((B, m_pad), NEG)
            eu = jnp.full((B, m_pad), NEG)
            nf = ns.astype(jnp.float32)
            acc0 = jnp.stack(
                [
                    jnp.where(ns == 0, o, NEG),
                    jnp.where(ns == 0, 0.0, NEG),
                    jnp.where(ns == 0, o, o + e * nf),
                ],
                axis=1,
            )
        else:
            el = jnp.zeros((B, m_pad))
            em = jnp.zeros((B, m_pad))
            eu = jnp.zeros((B, m_pad))
            acc0 = (jnp.full((B,), NEG), jnp.zeros(B, jnp.int32),
                    jnp.zeros(B, jnp.int32))

        def blk(carry, xs):
            t_blk, off = xs
            gj = off + jnp.arange(1, chunk + 1, dtype=jnp.int32)
            return _affine_chunk_ptr(mode, qs, t_blk, gj, m_col, n_col, p,
                                     carry, rpb=rpb)

        carry, packed = jax.lax.scan(blk, (el, em, eu, acc0),
                                     (t_blks, offs))
        ptrs = packed if rpb > 1 else _assemble_ptrs(packed, B, m_pad,
                                                     n_pad)
        if mode == "global":
            fin = carry[3]
            # final tie order L, M, U (alignment.h:466-469)
            return fin.max(axis=1), jnp.argmax(fin, axis=1).astype(
                jnp.int32), ptrs
        best, imax, jmax = carry[3]
        return best, imax, jmax, ptrs

    if mode == "overlap":
        p = (match, mis, o)
        em = jnp.zeros((B, m_pad))
        # j=0 border M(m,0)=0 opens the start scan when n >= 1; strict >
        # keeps it on ties (argmax over [0, n-1], alignment.h:950-959)
        acc0 = (jnp.where(ns >= 1, 0.0, NEG), jnp.zeros(B, jnp.int32))

        def blk(carry, xs):
            t_blk, off = xs
            gj = off + jnp.arange(1, chunk + 1, dtype=jnp.int32)
            return _overlap_chunk_ptr(qs, t_blk, gj, m_col, n_col, p,
                                      carry, rpb=rpb)

        carry, packed = jax.lax.scan(blk, (em, acc0), (t_blks, offs))
        ptrs = packed if rpb > 1 else _assemble_ptrs(packed, B, m_pad,
                                                     n_pad)
        best, jmax = carry[1]
        return best, jmax, ptrs

    raise ValueError(mode)


@functools.partial(jax.jit, static_argnums=(0, 5, 6))
def chunked_fit_ptr_fill(use_jump, qs, ts, allow, ns, n_chunk=DEFAULT_CHUNK,
                         rows_per_byte=1, params=None):
    """Fit-mode pointer fill; returns (score, start_state 0=MID/1=LOW,
    j_max, ptrs) like engine/scan.fit_fill. ``rows_per_byte`` == 2
    (nibble, no-jump only) returns raw packed blocks as chunked_ptr_fill
    does."""
    B, m_pad = qs.shape
    n_pad = ts.shape[1]
    rpb = rows_per_byte
    if rpb > 1 and (use_jump or rpb != 2 or m_pad % 2):
        raise ValueError("fit packs nibbles only without -s jump state")
    nblk, chunk = pick_chunk(n_pad, n_chunk)
    ts = _pad_cols(ts, nblk * chunk, -2)
    allow = _pad_cols(allow.astype(jnp.bool_), nblk * chunk, False)
    match, mis = params[0, 0], params[0, 1]
    o, e, jp = params[0, 2], params[0, 3], params[0, 4]
    m_col = params[:, 5:6].astype(jnp.int32)
    n_col = ns[:, None].astype(jnp.int32)
    t_blks = ts.reshape(B, nblk, chunk).transpose(1, 0, 2)
    a_blks = allow.reshape(B, nblk, chunk).transpose(1, 0, 2)
    offs = jnp.arange(nblk, dtype=jnp.int32) * chunk
    p = (match, mis, o, e, jp)
    neg = jnp.full((B, m_pad), NEG)
    z = jnp.zeros(B, jnp.int32)
    acc0M = (jnp.where((m_col[:, 0] == 0) & (ns >= 1), 0.0, NEG), z)
    acc0L = (jnp.full((B,), NEG), z)

    def blk(carry, xs):
        t_blk, a_blk, off = xs
        gj = off + jnp.arange(1, chunk + 1, dtype=jnp.int32)
        return _fit_chunk_ptr(use_jump, qs, t_blk, a_blk, gj, m_col,
                              n_col, p, carry, rpb=rpb)

    carry, packed = jax.lax.scan(
        blk, (neg, neg, neg, neg, acc0M, acc0L), (t_blks, a_blks, offs)
    )
    ptrs = packed if rpb > 1 else _assemble_ptrs(packed, B, m_pad, n_pad)
    (mb, mj), (lb, lj) = carry[4], carry[5]
    use_l = lb > mb  # M beats L on ties (alignment.h:676-690)
    score = jnp.where(use_l, lb, mb)
    state = jnp.where(use_l, jnp.int32(1), jnp.int32(0))
    j_max = jnp.where(use_l, lj, mj).astype(jnp.int32)
    return score, state, j_max, ptrs
