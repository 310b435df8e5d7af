"""On-device batched traceback: walk all pairs' pointer matrices in parallel.

Host traceback requires pulling the packed pointer tensor off the device —
B x m x n bytes (1 GB for a 256 x 2048^2 batch) — and walking it on the
host. The walk itself is sequential per pair but embarrassingly parallel
ACROSS pairs, so this module runs it on the device: an early-exiting
``lax.while_loop`` (up to m_pad + n_pad steps, stopping the moment every
pair is done; per-step cost: benchmarks/probe_walk.py), each step doing a
B-element gather from the HBM-resident pointer tensor and emitting one
(char1, char2) column per pair. Collection is two host round trips per
FLUSH WAVE of buckets: one fused f32 scalar pull (count/fi/fj/err +
caller extras such as fill scores), then one cols pull sliced to the
longest actual walk — only those bytes ever cross to the host, which
reverses, trims, and applies the per-mode epilogues (global's
unconsumed-prefix padding).

Semantics are identical to the host walker (engine/traceback.py) and the
reference routines it mirrors (src/alignment.h:372-412, 558-592, 766-800,
896-922), including local's emit-then-stop HOME behavior and the
fail-fast on unset pointers (the reference's UB / infinite-loop hazards).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aligntools_tpu.engine.scan import (
    PK_J_IS_JUMP,
    PK_L_IS_MID,
    PK_M_UNSET,
    PK_U_IS_UPP,
)

# walk states (match native/aligntools_native.cpp)
_LOW, _MID, _UPP, _JUMP = 0, 1, 2, 3
_DONE, _ERR = 4, 5
_GAP = np.uint8(ord("-"))


def _gather_byte(ptrs, blk_chunk, bidx, row, jc):
    """One pointer byte per pair: ``ptrs`` is (B, R, C) when blk_chunk ==
    0, else the chunked engine's raw packed block layout (nblk, R, B,
    chunk) — global packed column jc decomposes into (block, lane)."""
    if blk_chunk:
        return ptrs[jc // blk_chunk, row, bidx, jc % blk_chunk]
    return ptrs[bidx, row, jc]


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _walk_affine(stop_at_j0, n_steps, col_base, pack4, code3_home,
                 blk_chunk, ptrs, qs, ts, state0, i0, j0):
    """Batched walk for global/local/fit.

    ptrs (B, R, C) uint8 (or (nblk, R, B, chunk) when ``blk_chunk`` > 0;
    see _gather_byte); qs (B, m_pad) i32; ts (B, n_pad) i32;
    state0/i0/j0 (B,) i32. stop_at_j0: True for global/local (while i>0 and
    j>0), False for fit (while i>0). ``pack4``: nibble layout
    (rows_per_byte=2) — two DP rows per byte, pM 2 bits with code 3
    meaning HOME when ``code3_home`` (local) else unset/ERR (global/fit),
    pL/pU at bits 2/3, no jump state (engine/chunked.py _ptr_fields).
    Returns stacked (n_steps, B) char columns (walk order), per-pair
    emitted length, final (i, j), err flag.

    A ``lax.while_loop`` that EXITS as soon as every pair has stopped:
    walk lengths are data-dependent (local alignments of unrelated reads
    are tens of steps; n_steps is m_pad + n_pad + 1), and the measured
    per-step cost is ~4-20 us, so running the full scan length cost
    3-5x more than the walks needed (benchmarks/probe_walk.py). Columns
    are written through ``dynamic_update_slice`` into a preallocated
    (n_steps, B) HBM buffer; unwritten rows stay zero, matching the old
    scan's inactive-step emissions.
    """
    B = qs.shape[0]
    bidx = jnp.arange(B)

    def _active(state, i, j):
        a = (state < _DONE) & (i > 0)
        if stop_at_j0:
            a = a & (j > 0)
        return a

    def cond(carry):
        k, i, j, state, count, err, c1, c2 = carry
        return (k < n_steps) & jnp.any(_active(state, i, j))

    def body(carry):
        k, i, j, state, count, err, cols1, cols2 = carry
        active = _active(state, i, j)
        row = jnp.maximum(i - 1, 0)
        jc = jnp.maximum(j - col_base, 0)
        if pack4:
            byte = _gather_byte(ptrs, blk_chunk, bidx, row >> 1, jc)
            byte = byte.astype(jnp.int32)
            byte = jnp.where(row & 1, byte >> 4, byte) & 0xF
            code = byte & 0x3
            code3 = jnp.int32(_DONE if code3_home else _ERR)
            nxt_mid = jnp.where(code == 3, code3, code)
            l_is_mid, u_is_upp = byte & 0x4, byte & 0x8
        else:
            byte = _gather_byte(ptrs, blk_chunk, bidx, row, jc)
            byte = byte.astype(jnp.int32)
            code = byte & 0x7
            # next-state decode per current state
            nxt_mid = jnp.where(
                code == PK_M_UNSET,
                _ERR,
                jnp.where(code <= 3, code, _DONE),  # 0-3 LOW/MID/UPP/JUMP; 4 HOME
            )
            l_is_mid, u_is_upp = byte & PK_L_IS_MID, byte & PK_U_IS_UPP
        nxt = jnp.where(
            state == _MID,
            nxt_mid,
            jnp.where(
                state == _LOW,
                jnp.where(l_is_mid, _MID, _LOW),
                jnp.where(
                    state == _UPP,
                    jnp.where(u_is_upp, _UPP, _MID),
                    jnp.where(byte & PK_J_IS_JUMP, _JUMP, _MID),
                ),
            ),
        )
        is_low = state == _LOW
        is_mid = state == _MID
        takes_q = is_low | is_mid  # consumes a query char
        takes_t = ~is_low  # MID/UPP/JUMP consume a target char
        ni = jnp.where(active & takes_q, i - 1, i)
        nj = jnp.where(active & takes_t, j - 1, j)
        qc = qs[bidx, jnp.maximum(ni, 0)].astype(jnp.uint8)
        tc = ts[bidx, jnp.maximum(nj, 0)].astype(jnp.uint8)
        c1 = jnp.where(active, jnp.where(takes_q, qc, _GAP), jnp.uint8(0))
        c2 = jnp.where(active, jnp.where(takes_t, tc, _GAP), jnp.uint8(0))
        err = err | (active & (nxt == _ERR))
        # inactive steps preserve state: a pause (i or j hit the block/walk
        # boundary) must stay distinguishable from a genuine HOME/_DONE
        # stop so the rescan engine can resume across row blocks
        state = jnp.where(active, nxt, state)
        count = count + active.astype(jnp.int32)
        cols1 = jax.lax.dynamic_update_slice(cols1, c1[None], (k, 0))
        cols2 = jax.lax.dynamic_update_slice(cols2, c2[None], (k, 0))
        return (k + 1, ni, nj, state, count, err, cols1, cols2)

    init = (
        jnp.int32(0),
        i0,
        j0,
        state0,
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, bool),
        jnp.zeros((n_steps, B), jnp.uint8),
        jnp.zeros((n_steps, B), jnp.uint8),
    )
    _, fi, fj, fstate, count, err, cols1, cols2 = jax.lax.while_loop(
        cond, body, init
    )
    return cols1, cols2, count, fi, fj, fstate, err


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _walk_overlap(n_steps, col_base, pause_at_i0, rpb, blk_chunk, ptrs,
                  qs, ts, i0, j0):
    """Batched overlap walk (while j>0; 2-bit codes move directly).

    ``pause_at_i0``: True for the block-resumable rescan walk — at i == 0
    the walk simply stops emitting (the caller resumes in the row block
    above) instead of flagging the reference's i<=0 UB as an error.
    ``rpb``: DP rows per byte (1, 2, or 4; row rpb*k in the low bits).
    ``blk_chunk``: chunked-engine raw block layout (_gather_byte).

    Early-exiting ``lax.while_loop`` like :func:`_walk_affine`."""
    B = qs.shape[0]
    bidx = jnp.arange(B)
    bits = 8 // rpb

    def _active(done, i, j):
        a = (~done) & (j > 0)
        if pause_at_i0:
            a = a & (i > 0)
        return a

    def cond(carry):
        k, i, j, done, count, err, c1, c2 = carry
        return (k < n_steps) & jnp.any(_active(done, i, j))

    def body(carry):
        k, i, j, done, count, err, cols1, cols2 = carry
        active = _active(done, i, j)
        row = jnp.maximum(i - 1, 0)
        jc = jnp.maximum(j - col_base, 0)
        if rpb > 1:
            byte = _gather_byte(ptrs, blk_chunk, bidx, row // rpb, jc)
            byte = byte.astype(jnp.int32) >> ((row % rpb) * bits)
        else:
            byte = _gather_byte(ptrs, blk_chunk, bidx, row, jc)
        code = (byte & 0x3).astype(jnp.int32)
        bad = active & ((code == 3) | (i <= 0))
        takes_q = code != 0  # DIAG/RIGHT consume query
        takes_t = code != 2  # LEFT/DIAG consume target
        ni = jnp.where(active & takes_q, i - 1, i)
        nj = jnp.where(active & takes_t, j - 1, j)
        qc = qs[bidx, jnp.maximum(ni, 0)].astype(jnp.uint8)
        tc = ts[bidx, jnp.maximum(nj, 0)].astype(jnp.uint8)
        c1 = jnp.where(active, jnp.where(takes_q, qc, _GAP), jnp.uint8(0))
        c2 = jnp.where(active, jnp.where(takes_t, tc, _GAP), jnp.uint8(0))
        err = err | bad
        done = done | bad | (nj == 0)
        count = count + (active & ~bad).astype(jnp.int32)
        cols1 = jax.lax.dynamic_update_slice(cols1, c1[None], (k, 0))
        cols2 = jax.lax.dynamic_update_slice(cols2, c2[None], (k, 0))
        return (k + 1, ni, nj, done, count, err, cols1, cols2)

    init = (
        # entering at j0 == 0 reports done=True (the old full-length
        # scan picked this up from its first step's nj == 0; the rescan
        # resume loop depends on it)
        jnp.int32(0), i0, j0, j0 <= 0,
        jnp.zeros(B, jnp.int32), jnp.zeros(B, bool),
        jnp.zeros((n_steps, B), jnp.uint8),
        jnp.zeros((n_steps, B), jnp.uint8),
    )
    _, fi, fj, done, count, err, cols1, cols2 = jax.lax.while_loop(
        cond, body, init
    )
    return cols1, cols2, count, fi, fj, done, err


def walk_dispatch(mode, ptrs_dev, qs_np, ts_np, starts, col_base=0,
                  pack4=False, blk_chunk=0, extras=()):
    """Dispatch the device walk WITHOUT any host round trip; returns an
    opaque handle for :func:`walk_collect`.

    ``qs_np``/``ts_np`` may be host planes OR the fill's device-resident
    char planes (uint8 or int32-sentinel) — passing the device arrays
    avoids uploading the sequences a second time; the
    walk only reads true-position chars, which are identical in every
    layout.

    ``starts`` is either the legacy list of per-pair (state0, i0, j0)
    tuples or a 3-tuple of device/int32 arrays — the array form lets the
    caller derive walk starts on device straight from the fill outputs,
    so fill -> walk needs NO host sync and consecutive buckets' fills
    and walks overlap on the device queue.

    ``extras``: optional (B,)-shaped device vectors (e.g. the fill's
    score output) folded into the walk's ONE fused scalar pull; they
    come back from :func:`walk_scalars` as float32 np arrays."""
    if pack4 is True:
        rpb = 2
    elif not pack4:
        rpb = 1
    else:
        rpb = int(pack4)
        assert rpb in (1, 2, 4)
    n_steps = int(qs_np.shape[1] + ts_np.shape[1] + 1)
    qs_d = jnp.asarray(qs_np)
    ts_d = jnp.asarray(ts_np)
    if isinstance(starts, tuple) and len(starts) == 3:
        state0, i0, j0 = (
            jnp.asarray(s).astype(jnp.int32) for s in starts
        )
    else:
        state0 = jnp.asarray([s[0] for s in starts], jnp.int32)
        i0 = jnp.asarray([s[1] for s in starts], jnp.int32)
        j0 = jnp.asarray([s[2] for s in starts], jnp.int32)
    if mode == "overlap":
        c1d, c2d, cnt_d, fi_d, fj_d, _, err_d = _walk_overlap(
            n_steps, col_base, False, rpb, blk_chunk, ptrs_dev, qs_d,
            ts_d, i0, j0
        )
    else:
        c1d, c2d, cnt_d, fi_d, fj_d, _, err_d = _walk_affine(
            mode != "fit", n_steps, col_base, rpb == 2,
            mode == "local", blk_chunk, ptrs_dev, qs_d, ts_d, state0,
            i0, j0,
        )
    # ONE fused f32 scalar block per bucket: count/fi/fj/err plus the
    # caller's extras (the fill's score vector) — every value is an int
    # < 2^24 or a genuine f32, so the f32 stack is exact; one pull
    # instead of two per bucket.
    parts = [cnt_d, fi_d, fj_d, err_d] + list(extras)
    scal_d = jnp.stack([jnp.asarray(p).astype(jnp.float32)
                        for p in parts])
    return (mode, scal_d, c1d, c2d, n_steps, len(extras))


def walk_scalars(handle):
    """Pull a dispatched walk's fused scalar block (ONE host round
    trip): (count, fi, fj, err, [extras...]) as np arrays."""
    mode, scal_d, _, _, _, n_extra = handle
    sc = np.asarray(scal_d)
    count = sc[0].astype(np.int32)
    fi, fj = sc[1].astype(np.int32), sc[2].astype(np.int32)
    err = sc[3].astype(bool)
    return count, fi, fj, err, [sc[4 + e] for e in range(n_extra)]


def _pull_rung(length: int, cap: int) -> int:
    """Round a cols-pull length up to a power-of-2 rung (bounds the
    slice-op compile count), capped at the buffer length."""
    return min(cap, 1 << max(length, 64).bit_length())


def walk_rows(handle, scalars, pairs):
    """Pull the walked columns (bounded by the longest actual walk) and
    assemble the final alignment rows on the host.

    The (n_steps, B) device cols buffers are mostly zeros past
    ``max(count)`` — walk lengths are data-dependent and usually far
    below n_steps — so the pull is sliced to a power-of-2 rung of the
    max walk length.
    """
    mode, _, c1d, c2d, n_steps, _ = handle
    count, fi, fj, err, _ = scalars
    ln_max = int(count.max()) if len(count) else 0
    rung = _pull_rung(ln_max, n_steps)
    both = np.asarray(jnp.stack([c1d[:rung], c2d[:rung]]))
    return _assemble(mode, both[0], both[1], scalars, pairs)


def _assemble(mode, cols1, cols2, scalars, pairs):
    """Host row assembly from pulled walk columns: reverse, trim to each
    pair's walk length, apply the per-mode epilogue."""
    count, fi, fj, err, _ = scalars
    out = []
    for b in range(len(pairs)):
        if err[b]:
            raise RuntimeError(
                "traceback hit unset pointer (reference UB) in pair "
                f"{b}"
            )
        ln = int(count[b])
        r1 = bytes(cols1[:ln, b][::-1])
        r2 = bytes(cols2[:ln, b][::-1])
        if mode == "global":
            q, t = pairs[b]
            i, j = int(fi[b]), int(fj[b])
            r1 = q[:i] + b"-" * j + r1
            r2 = b"-" * i + t[:j] + r2
        out.append((r1, r2))
    return out


def walk_scalars_many(handles):
    """Fused scalar blocks for MANY dispatched walks in ONE host round
    trip (a flush wave's worth of buckets, one sync instead of one per
    bucket)."""
    if len(handles) == 1:
        return [walk_scalars(handles[0])]
    flat = np.asarray(jnp.concatenate(
        [jnp.ravel(h[1]) for h in handles]
    ))
    out, off = [], 0
    for h in handles:
        rows, B = h[1].shape
        sc = flat[off : off + rows * B].reshape(rows, B)
        off += rows * B
        out.append((
            sc[0].astype(np.int32), sc[1].astype(np.int32),
            sc[2].astype(np.int32), sc[3].astype(bool),
            [sc[4 + e] for e in range(h[5])],
        ))
    return out


def walk_rows_many(handles, scalars_list, pairs_list):
    """Bounded cols pulls for MANY dispatched walks in ONE host round
    trip, then per-bucket host assembly; see walk_rows."""
    if len(handles) == 1:
        return [walk_rows(handles[0], scalars_list[0], pairs_list[0])]
    slices, shapes = [], []
    for h, scal in zip(handles, scalars_list):
        _, _, c1d, c2d, n_steps, _ = h
        count = scal[0]
        ln_max = int(count.max()) if len(count) else 0
        rung = _pull_rung(ln_max, n_steps)
        slices.append(jnp.ravel(jnp.stack([c1d[:rung], c2d[:rung]])))
        shapes.append((rung, c1d.shape[1]))
    flat = np.asarray(jnp.concatenate(slices))
    out, off = [], 0
    for h, scal, pairs, (rung, B) in zip(
        handles, scalars_list, pairs_list, shapes
    ):
        both = flat[off : off + 2 * rung * B].reshape(2, rung, B)
        off += 2 * rung * B
        out.append(_assemble(h[0], both[0], both[1], scal, pairs))
    return out


def batch_traceback(mode, ptrs_dev, qs_np, ts_np, pairs, starts,
                    col_base=0, pack4=False, blk_chunk=0):
    """Walk a whole bucket on-device; assemble final rows on the host.

    ``ptrs_dev``: device (B, R, C) uint8 pointer tensor (stays on device);
    ``qs_np``/``ts_np``: host (B, m_pad)/(B, n_pad) int arrays;
    ``pairs``: [(q_bytes, t_bytes)] true sequences; ``starts``: per-pair
    (state0, i0, j0) ints (state encoding of _walk_affine, ignored for
    overlap). ``col_base``: 0 when the pointer tensor includes column 0
    (vmap fills), 1 when it starts at column 1 (chunked packed blocks).
    ``pack4``: packed pointer tensor — truthy means rows_per_byte=2
    (nibble layout); the int 4 selects the 2-bit overlap layout
    (rows_per_byte=4). ``blk_chunk`` > 0: the
    chunked engine's raw packed block layout (nblk, R, B, chunk), walked
    without ever assembling it (pass col_base=1 — the blocks hold
    columns 1..nblk*chunk). Returns [(row1, row2)] per pair.
    """
    return walk_collect(
        walk_dispatch(mode, ptrs_dev, qs_np, ts_np, starts, col_base,
                      pack4, blk_chunk),
        pairs,
    )


def walk_collect(handle, pairs):
    """Pull a dispatched walk (scalars, then bounded cols) and assemble
    the final rows; see :func:`walk_scalars` / :func:`walk_rows`."""
    return walk_rows(handle, walk_scalars(handle), pairs)
