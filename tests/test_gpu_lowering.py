"""Every fill and walk of the GPU path lowers for CUDA from this host.

``jax.export(..., platforms=["cuda"])`` runs the CUDA lowering without a
card, so a construct the GPU route cannot lower fails here, not on the
chip. The lowered modules must also hold no matrix product (the card
computes f32 products in TF32 by default, which would break the exact
integer scores) and no custom call (no hand kernel is on the path).
"""

import jax
import jax.numpy as jnp
import pytest

from aligntools_tpu import batch as bt
from aligntools_tpu.engine import chunked as ck
from aligntools_tpu.engine import device_tb

B, M, N, CHUNK = 4, 64, 384, 128


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


QI, TI = _sds((B, M), jnp.int32), _sds((B, N), jnp.int32)
QU, TU = _sds((B, M), jnp.uint8), _sds((B, N), jnp.uint8)
NS, PS = _sds((B,), jnp.int32), _sds((B, 6), jnp.float32)
AL = _sds((B, N), jnp.bool_)


def _check(fn, *args):
    exp = jax.export.export(jax.jit(fn), platforms=["cuda"])(*args)
    assert exp.platforms == ("cuda",)
    text = exp.mlir_module()
    assert "dot_general" not in text, "matrix product on the GPU path"
    assert "custom_call" not in text, "hand kernel on the GPU path"
    return exp


MODES = ["global", "local", "overlap", "edit", "fit", "fit_jump"]
# (mode, emit pointers): every mode's score fill, and the pointer fill of
# every mode with a traceback (edit distance has none)
FILLS = [(m, False) for m in MODES] + [
    (m, True) for m in MODES if m != "edit"]


@pytest.mark.parametrize("mode,emit", FILLS)
def test_chunked_fill_lowers_for_cuda(mode, emit):
    if mode.startswith("fit"):
        jump = mode == "fit_jump"
        if emit:
            _check(lambda q, t, a, n, p: ck.chunked_fit_ptr_fill(
                jump, q, t, a, n, CHUNK, 1, params=p), QI, TI, AL, NS, PS)
        else:
            _check(lambda q, t, a, n, p: ck.chunked_fit_scores(
                jump, q, t, a, n, CHUNK, params=p), QI, TI, AL, NS, PS)
    elif emit:
        rpb = 4 if mode == "overlap" else 2
        _check(lambda q, t, n, p: ck.chunked_ptr_fill(
            mode, q, t, n, CHUNK, rpb, params=p), QI, TI, NS, PS)
    else:
        _check(lambda q, t, n, p: ck.chunked_scores(
            mode, q, t, n, CHUNK, params=p), QI, TI, NS, PS)


@pytest.mark.parametrize("mode,emit", FILLS)
def test_vmap_fill_lowers_for_cuda(mode, emit):
    if mode.startswith("fit"):
        jump = mode == "fit_jump"
        _check(lambda q, t, a, n, p: bt._vfill_fit(
            q, t, a, N, jump, emit, n, p), QU, TU, AL, NS, PS)
    else:
        _check(lambda q, t, n, p: bt._vfill(q, t, mode, N, emit, n, p),
               QU, TU, NS, PS)


@pytest.mark.parametrize("mode,rpb,blk", [
    ("global", 1, 0), ("local", 2, CHUNK), ("fit", 1, 0),
    ("fit", 2, CHUNK), ("overlap", 1, 0), ("overlap", 4, CHUNK),
])
def test_device_walk_lowers_for_cuda(mode, rpb, blk):
    """The early-exit while_loop walks, in the byte layout and in the
    chunked engine's packed block layout."""
    if blk:
        ptrs = _sds((N // CHUNK, M // rpb, B, CHUNK), jnp.uint8)
    else:
        ptrs = _sds((B, M, N + 1), jnp.uint8)
    n_steps = M + N + 1
    col_base = 1 if blk else 0
    i32 = _sds((B,), jnp.int32)
    if mode == "overlap":
        _check(lambda pt, q, t, i0, j0: device_tb._walk_overlap(
            n_steps, col_base, False, rpb, blk, pt, q, t, i0, j0),
            ptrs, QI, TI, i32, i32)
    else:
        _check(lambda pt, q, t, s0, i0, j0: device_tb._walk_affine(
            mode != "fit", n_steps, col_base, rpb == 2, mode == "local",
            blk, pt, q, t, s0, i0, j0), ptrs, QI, TI, i32, i32, i32)


def test_transport_decode_lowers_for_cuda():
    """The one-upload transport's device decode (2-bit and uint8 blobs)."""
    blob4 = _sds((B, M // 4 + N // 4 + 32), jnp.uint8)
    lut = _sds((4,), jnp.uint8)
    _check(lambda b, lu: bt._unpack_sentinelize(M // 4, b, lu), blob4, lut)
    blob = _sds((B, M + N + 32), jnp.uint8)
    _check(lambda b: bt._widen_sentinelize(M, b), blob)
