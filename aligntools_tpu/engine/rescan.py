"""Checkpoint-rescan traceback: full alignments in O(m·n/S) pointer memory.

The whole-matrix engines (engine/scan.py + engine/device_tb.py) keep one
packed pointer byte per DP cell — m x n bytes of device memory — which
caps full alignments at the pointer budget's worth of cells
(batch.PTR_BUDGET_FRAC of the device's memory limit). This engine removes
that cap the classic checkpoint-rescan way, restated for the batched
row-scan formulation:

  forward   one scan over the m_pad query rows (the SAME mode machines as
            engine/scan.py — one source of truth for recurrences and
            tie-breaks), emitting NO pointers; instead the carry state rows
            (M, L, U[, J]) are snapshotted once per S-row block:
            (m_pad/S) x states x (n_pad+1) f32 — 16x smaller than the
            pointer tensor at S=256, and tunable.
  backward  the traceback (reference: src/alignment.h:372-412, 558-592,
            766-800, 896-922) visits rows top-down, so blocks are refilled
            from their checkpoint one at a time WITH pointer emission
            (S x n_pad bytes live at once) and walked on-device by the
            batched walker, resuming across block boundaries via the
            walker's (state, i, j) carry. Total refill work <= 2x the
            forward fill; walk steps total O(alignment length) plus one
            partial chunk per block.

Exactness: the refilled blocks reproduce the full-matrix pointers bit for
bit (same machine, same carries), so rows are byte-identical to the
single-tensor engines — and therefore to the reference binary they are
parity-tested against. Verified differentially in tests/test_rescan.py,
including tie-heavy binary alphabets.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aligntools_tpu.engine import device_tb
from aligntools_tpu.engine.scan import (
    _encode,
    _params_vec,
    _unroll,
    check_f32_exact,
    fit_machine,
    global_machine,
    local_machine,
    overlap_machine,
    pad_len,
)

_N_STATE_ROWS = {"global": 3, "local": 3, "fit": 4, "overlap": 1}
_DONE = device_tb._DONE


def _machine(mode, t_arr, n, params, entry_allowed, n_pad, use_jump,
             emit_ptrs):
    if mode == "global":
        return global_machine(t_arr, n, params, n_pad, emit_ptrs)
    if mode == "local":
        return local_machine(t_arr, n, params, n_pad, emit_ptrs)
    if mode == "fit":
        return fit_machine(t_arr, n, params, entry_allowed, n_pad,
                           use_jump, emit_ptrs)
    if mode == "overlap":
        return overlap_machine(t_arr, n, params, n_pad, emit_ptrs)
    raise ValueError(f"unknown mode {mode!r}")


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _forward_ckpt(mode, n_pad, S, use_jump, q_arr, t_arr, n, params,
                  entry_allowed):
    """Forward fill with per-block carry snapshots.

    Returns (finish-tuple, checkpoints (nblk, states, n_pad+1) f32) where
    checkpoints[k] is the machine state ENTERING block k (rows k*S+1 ..
    (k+1)*S)."""
    init, step, finish = _machine(
        mode, t_arr, n, params, entry_allowed, n_pad, use_jump, False
    )
    nrows = _N_STATE_ROWS[mode]
    nblk = q_arr.shape[0] // S
    qf = q_arr.astype(jnp.float32).reshape(nblk, S)
    zer = jnp.zeros((nblk, S))

    def blk(carry, xs):
        ck = jnp.stack(carry[:nrows])
        carry, _ = jax.lax.scan(step, carry, xs, unroll=_unroll())
        return carry, ck

    carry, cks = jax.lax.scan(blk, init, (qf, zer))
    return finish(carry), cks


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _refill_block(mode, n_pad, S, use_jump, ck, i0, q_blk, t_arr, n,
                  params, entry_allowed):
    """Re-run rows i0+1 .. i0+S from checkpoint ``ck``, emitting the packed
    pointer rows (S, n_pad+1) uint8 — bit-identical to the corresponding
    slice of the whole-matrix fill."""
    init, step, _ = _machine(
        mode, t_arr, n, params, entry_allowed, n_pad, use_jump, True
    )
    nrows = _N_STATE_ROWS[mode]
    carry = (
        tuple(ck[r] for r in range(nrows))
        + tuple(init[nrows:-1])  # latches: shapes/dtypes only, discarded
        + (i0.astype(jnp.int32),)
    )
    _, ptrs = jax.lax.scan(
        step, carry, (q_blk.astype(jnp.float32), jnp.zeros(S)),
        unroll=_unroll(),
    )
    return ptrs


def rescan_align(mode, q: bytes, t: bytes, p, sites=None, stride: int = 256):
    """Single-pair full alignment with checkpoint-rescan traceback.

    Byte-identical rows to scan_align / the batched engines; pointer HBM
    footprint is one S x n_pad block instead of m_pad x n_pad. ``stride``
    is the row-block size S (checkpoint memory ~ states * 4 * m * n / S
    bytes). Returns spec.engine.AlignResult.
    """
    from aligntools_tpu.spec.engine import AlignResult

    if mode == "edit":
        raise ValueError("edit mode has no traceback (alignment.h:291-315)")
    if mode == "fit" and len(q) > len(t):
        raise ValueError("first sequence must be shorter than the second")
    m, n = len(q), len(t)
    check_f32_exact(p, m, n, mode)
    S = int(stride)
    if S % 8:
        raise ValueError("stride must be a multiple of 8")
    m_pad = max(S, -(-m // S) * S)
    n_pad = pad_len(n)
    use_jump = mode == "fit" and sites is not None
    qa = np.full(m_pad, -1, np.int32)
    qa[:m] = np.frombuffer(q, np.uint8)
    ta_j = _encode(t, n_pad, -2)
    allowed = np.ones(n_pad, dtype=bool)
    if use_jump:
        s = np.asarray([x for x in sites if 0 <= x < n_pad], dtype=np.int64)
        allowed[s] = False
    allowed_j = jnp.asarray(allowed)
    qa_j = jnp.asarray(qa)
    pv = _params_vec(p, m)
    nn = jnp.int32(n)

    fin, cks = _forward_ckpt(
        mode, n_pad, S, use_jump, qa_j, ta_j, nn, pv, allowed_j
    )
    # Start-cell mapping, identical to scan_align / seqpar_align.
    if mode == "global":
        score, state = float(fin[0]), int(fin[1])  # 0/1/2 = LOW/MID/UPP
        i0, j0 = m, n
    elif mode == "local":
        score, i0, j0 = float(fin[0]), int(fin[1]), int(fin[2])
        state = 1  # _MID
    elif mode == "fit":
        score, use_l, j0 = float(fin[0]), int(fin[1]), int(fin[2])
        if not np.isfinite(score):
            raise RuntimeError("fit: no finite traceback start (reference UB)")
        state, i0 = (0 if use_l else 1), m
    else:  # overlap
        score, j0 = float(fin[0]), int(fin[1])
        state, i0 = 0, m

    stop_j0 = mode in ("global", "local")
    CH = S + 2048  # walk-chunk length: one partial chunk max per block
    ta_np = np.asarray(ta_j)[None]
    chunks1, chunks2 = [], []
    i, j = i0, j0
    finished = i <= 0
    k = (i - 1) // S if i > 0 else -1
    while k >= 0 and not finished:
        base = k * S
        ptrs = _refill_block(
            mode, n_pad, S, use_jump, cks[k], jnp.int32(base),
            qa_j[base : base + S], ta_j, nn, pv, allowed_j,
        )[None]
        qs_blk = qa[None, base : base + S]
        i_rel = i - base
        while True:
            if mode == "overlap":
                c1, c2, cnt, fi, fj, done, werr = device_tb._walk_overlap(
                    CH, 0, True, 1, 0, ptrs, qs_blk, ta_np,
                    jnp.asarray([i_rel], jnp.int32),
                    jnp.asarray([j], jnp.int32),
                )
                fstate, done = None, done
            else:
                c1, c2, cnt, fi, fj, fstate, werr = device_tb._walk_affine(
                    stop_j0, CH, 0, False, mode == "local", 0, ptrs,
                    qs_blk, ta_np,
                    jnp.asarray([state], jnp.int32),
                    jnp.asarray([i_rel], jnp.int32),
                    jnp.asarray([j], jnp.int32),
                )
                done = None
            both = np.asarray(jnp.stack([c1[:, 0], c2[:, 0]]))
            if mode == "overlap":
                scal = np.asarray(jnp.stack(
                    [cnt, fi, fj, done.astype(jnp.int32),
                     werr.astype(jnp.int32)]
                ))[:, 0]
                cnt_h, fi_h, fj_h, done_h, werr_h = (
                    int(scal[0]), int(scal[1]), int(scal[2]),
                    bool(scal[3]), bool(scal[4]),
                )
                fstate_h = state
            else:
                scal = np.asarray(jnp.stack(
                    [cnt, fi, fj, fstate, werr.astype(jnp.int32)]
                ))[:, 0]
                cnt_h, fi_h, fj_h, fstate_h, werr_h = (
                    int(scal[0]), int(scal[1]), int(scal[2]),
                    int(scal[3]), bool(scal[4]),
                )
                done_h = fstate_h >= _DONE
            if werr_h:
                raise RuntimeError(
                    "traceback hit unset pointer (reference UB)"
                )
            chunks1.append(both[0, :cnt_h])
            chunks2.append(both[1, :cnt_h])
            prev = (i_rel, j, state)
            i_rel, j, state = fi_h, fj_h, fstate_h
            if done_h or (stop_j0 and j == 0):
                finished = True
                break
            if i_rel == 0:
                break  # resume in the block above
            if (i_rel, j, state) == prev:
                raise RuntimeError("rescan walk made no progress (bug)")
        i = base + i_rel
        k -= 1
    if not finished and mode == "overlap" and j > 0:
        # walk fell off row 0 with target left — the reference reads
        # pointer row -1 here (UB); fail fast like the walkers do
        raise RuntimeError("traceback hit unset pointer (reference UB)")
    r1 = bytes(np.concatenate(chunks1)[::-1]) if chunks1 else b""
    r2 = bytes(np.concatenate(chunks2)[::-1]) if chunks2 else b""
    if mode == "global":
        # unconsumed-prefix epilogue (alignment.h:398-407)
        r1 = q[:i] + b"-" * j + r1
        r2 = b"-" * i + t[:j] + r2
    return AlignResult(score, r1, r2)
