"""Batched alignment: length-bucketed, padded, vmapped device execution.

This is the throughput path the reference has no analog of (it processes one
pair per process invocation, alignment.h:503-510): thousands of pairs are
grouped into (m_bucket, n_bucket) shape buckets by a greedy optimal-split
partition under a compile budget (_bucket_keys), batch-padded to
compile-stable rungs (_pad_batch), and
each bucket executes as one device program vmapped over the batch
dimension. Each bucket ships ONE host->device upload — 2-bit packed (or
raw uint8) q|t chars with the f32 m/n/params meta matrix appended as raw
bytes, bitcast-decoded and widened to the engines' int32 sentinel layout
on device (_dev_inputs) — score fills are dispatched async across all
buckets before one collect wave; rows fills+walks collect in flush waves
of two pulls each.
Padding is mask-correct by construction: DP values flow only rightward/
downward so padded rows/columns never feed real cells, and every per-mode
extraction (final-cell gather, running argmax, bottom-row scans) masks to
the pair's true (m, n) inside the kernel — verified by the padding-
invariance tests (tests/test_batch.py).

Pointer tensors (1 byte/cell) are only materialized when alignments are
requested; score-only mode (``traceback=False``) skips them entirely for
benchmark/scale runs. Host traceback walks each pair's pointer matrix
(engine/traceback.py).

Multi-device execution shards the batch axis of each bucket over the mesh
(parallel/mesh.py wraps these same vmapped fills in shard_map).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from aligntools_tpu.backend import on_gpu

from aligntools_tpu.engine import scan as _scan
from aligntools_tpu.engine import select as _select
from aligntools_tpu.engine import traceback as tb
from aligntools_tpu.params import AlignParams
from aligntools_tpu.spec.engine import AlignResult


def bucket_len(x: int, floor: int, steps: int = 1) -> int:
    """Smallest bucket quantum >= x, floored at the tile quantum.

    ``steps`` per octave: 1 gives the round-1 powers of two (worst-case
    2x padding per dim); 4 gives the quarter-octave ladder p, 1.25p,
    1.5p, 1.75p (worst-case 1.25x), snapped to hardware quanta — every
    rung is a multiple of ``floor``/4 >= 16 so m stays pointer-pack
    aligned (%16) and n stays 128-aligned when floor is 128.
    """
    b = floor
    while b < x:
        b *= 2
    if steps > 1 and b > floor:
        p = b // 2  # x is in (p, 2p]
        align = 16 if floor <= 64 else 128
        for k in range(1, steps):
            rung = -(-(p + (p * k) // steps) // align) * align
            if x <= rung < b:
                b = rung
                break
    return b


@dataclasses.dataclass
class _Bucket:
    m_pad: int
    n_pad: int
    idx: list  # original positions
    q: np.ndarray  # [B, m_pad] uint8 raw chars (0 pad)
    t: np.ndarray  # [B, n_pad] uint8 raw chars (0 pad)
    m: np.ndarray  # [B] int32
    n: np.ndarray  # [B] int32
    allowed: np.ndarray | None = None  # [B, n_pad] bool (fit -s)
    alpha: np.ndarray | None = None  # (k<=4,) uint8 workload alphabet
    min_rows: int = 0  # batch size to route and pad at, if above len(idx)

    @property
    def rows(self) -> int:
        """Batch size the bucket is routed and compiled at: its pair
        count, or ``min_rows`` when larger (a pipeline gives every chunk
        the same, so all chunks share one executable per shape)."""
        return max(len(self.idx), self.min_rows)


# Total-shape (compile) budgets of the bucket partition; see _bucket_budget.
MAX_BUCKETS = 32
# On the GPU a cold compile costs ~3 s per score shape and ~7 s per rows
# shape (H100 80GB HBM3; PERF.md, "Bring-up findings"), so the budget is
# halved there.
GPU_MAX_BUCKETS = 16


def _bucket_budget() -> int:
    """Shape budget for _bucket_keys: env ALIGNTOOLS_MAX_BUCKETS, else
    GPU_MAX_BUCKETS on the GPU and MAX_BUCKETS on the CPU.

    Economics (docs/DESIGN.md §8): on the clustered synthetic read-length
    workload the greedy splitter reaches pad efficiency 0.80 at 16 shapes
    and 0.86 at 32 (an exact staircase DP also gives 0.80 at 16), while
    every shape is compiled once per process — seconds per shape on the
    GPU, unless the persistent compile cache holds it. One-shot small
    workloads never split this far anyway because greedy stops when no
    split saves cells."""
    import os

    env = os.environ.get("ALIGNTOOLS_MAX_BUCKETS")
    if env:
        return max(1, int(env))
    return GPU_MAX_BUCKETS if on_gpu() else MAX_BUCKETS


def _pad_batch(B: int) -> int:
    """Compile-stable batch rung: B rounded up to a 1/16-octave grid
    (grain = 2^floor(log2 B)/16, worst-case 6.25% pad rows, ~3% mean).

    Every jitted fill specializes on its leading batch dimension, so a
    pipeline whose per-chunk bucket occupancies wander (iid length
    distributions give B ~ binomial per bucket per chunk) would compile
    a fresh executable per (B, m_pad, n_pad) triple — measured 779
    distinct keys on the 100k-pair e2e workload. Snapping B to this
    grid collapses the B axis to 1-2 rungs per bucket; the pad rows are
    inert sentinel pairs whose outputs are discarded. Tiny buckets
    (B <= 16) stay exact — padding 1 pair to 16 would cost 16x."""
    if B <= 16:
        return B
    grain = max(1, (1 << (B.bit_length() - 1)) // 16)
    return -(-B // grain) * grain


def _pad_rows(b: "_Bucket"):
    """A bucket's host arrays padded to the _pad_batch rung of
    ``b.rows``: extra rows are inert sentinel pairs (q=-1 never matches
    t=-2, m=n=1) computed alongside and discarded — callers scatter
    results through ``b.idx`` (length B_true) so pad outputs are never
    read. Returns (q, t, allowed_or_None, m, n)."""
    B = len(b.idx)
    Bp = _pad_batch(b.rows)
    if Bp == B:
        return b.q, b.t, b.allowed, b.m, b.n
    q = np.zeros((Bp, b.m_pad), np.uint8)
    t = np.zeros((Bp, b.n_pad), np.uint8)
    q[:B] = b.q
    t[:B] = b.t
    m = np.ones(Bp, np.int32)
    n = np.ones(Bp, np.int32)
    m[:B] = b.m
    n[:B] = b.n
    allowed = None
    if b.allowed is not None:
        allowed = np.ones((Bp, b.n_pad), dtype=bool)
        allowed[:B] = b.allowed
    return q, t, allowed, m, n


def _sentinelize(q_u8, t_u8, ms, ns):
    """Widen raw uint8 char planes to the engines' int32-with-sentinels
    layout ON DEVICE. Transport rides the host link at 1 byte/char
    (int32 transport would move 4x the bytes) while the kernels keep
    their exact padded semantics (query pad -1 never equals target pad
    -2, identical to the former host-side int32 layout)."""
    qi = jnp.where(
        jnp.arange(q_u8.shape[1])[None, :] < ms[:, None],
        q_u8.astype(jnp.int32), -1,
    )
    ti = jnp.where(
        jnp.arange(t_u8.shape[1])[None, :] < ns[:, None],
        t_u8.astype(jnp.int32), -2,
    )
    return qi, ti


def _acct(counters, Bp: int, b: "_Bucket", route: str) -> None:
    """Padded-cells accounting for one executed fill (honest: includes
    batch-rung pad rows, not just per-pair shape padding), and the
    engine ``route`` it took."""
    if counters is not None:
        counters.padded_cells += Bp * b.m_pad * b.n_pad
        counters.routes[route] = counters.routes.get(route, 0) + 1


def _align_m(x: int, m_floor: int) -> int:
    """Smallest valid m_pad >= x: multiple of 16 (DMA/pointer-pack
    alignment), floored at the bucket quantum."""
    return max(m_floor, -(-int(x) // 16) * 16)


def _align_n(x: int, n_floor: int) -> int:
    """Smallest valid n_pad >= x: 128-aligned, floored."""
    return max(n_floor, -(-int(x) // 128) * 128)


def _bucket_keys(pairs, m_floor, n_floor, max_buckets=None):
    """Per-pair (m_pad, n_pad) shape keys minimizing padded cells under
    a compile budget (greedy optimal-split partition).

    Start from ONE bucket at the workload max shape; repeatedly take the
    bucket split with the best global padded-cells saving — for each
    bucket the candidate is the single cut (along m or n, over sorted
    hardware-aligned values, evaluated exactly with prefix/suffix maxes
    of the other dimension) that minimizes that bucket's cells — until
    the budget is spent or no split saves anything. Real workloads
    cluster by length, so the clusters separate in the first few splits;
    measured on the benchmark's clustered synthetic (m~300 +-20%,
    n~3000 +-25%): 0.80 true/padded cells at 16 shapes and 0.86 at 32,
    vs 0.68 for the round-3 quantum ladder and 0.46 for pure pow2. A
    log-uniform spray stays within max(budget, its pow2 shape count)
    and still beats pow2 cells (0.74 vs 0.49)."""
    P = len(pairs)
    if P == 0:
        return []
    if max_buckets is None:
        max_buckets = _bucket_budget()
    ms = np.fromiter((len(q) for q, _ in pairs), np.int64, P)
    ns = np.fromiter((len(t) for _, t in pairs), np.int64, P)
    m_al = np.fromiter((_align_m(x, m_floor) for x in ms), np.int64, P)
    n_al = np.fromiter((_align_n(x, n_floor) for x in ns), np.int64, P)
    # budget floor: never fewer shapes than the pow2 partition would use
    # (keeps the spray worst case at its round-1 compile count)
    pow2 = {
        (bucket_len(int(a), m_floor, 1), bucket_len(int(b), n_floor, 1))
        for a, b in zip(ms, ns)
    }
    budget = max(max_buckets, len(pow2))

    def best_split(idxs):
        """(cells_saved, (left_idxs, right_idxs)) for the best single
        cut of this bucket, or (0, None)."""
        base = m_al[idxs].max() * n_al[idxs].max() * len(idxs)
        best_sav, best_sp = 0, None
        for s_al, o_al in ((m_al, n_al), (n_al, m_al)):
            order = idxs[np.argsort(s_al[idxs], kind="stable")]
            sv, ov = s_al[order], o_al[order]
            if sv[0] == sv[-1]:
                continue
            pref_o = np.maximum.accumulate(ov)
            suff_o = np.maximum.accumulate(ov[::-1])[::-1]
            pref_s = np.maximum.accumulate(sv)
            k = np.arange(1, len(order))
            left = pref_s[:-1] * pref_o[:-1] * k
            right = sv[-1] * suff_o[1:] * (len(order) - k)
            tot = np.where(sv[:-1] != sv[1:], left + right,
                           np.iinfo(np.int64).max)
            kk = int(np.argmin(tot))
            sav = int(base - tot[kk])
            if sav > best_sav:
                best_sav = sav
                best_sp = (order[: kk + 1], order[kk + 1 :])
        return best_sav, best_sp

    buckets = [np.arange(P)]
    cache: list = [None]  # best_split per bucket, computed lazily
    while len(buckets) < budget:
        for i in range(len(buckets)):
            if cache[i] is None:
                cache[i] = best_split(buckets[i])
        i = max(range(len(buckets)), key=lambda i: cache[i][0])
        sav, sp = cache[i]
        if sav <= 0:
            break
        left, right = sp
        buckets[i], cache[i] = left, None
        buckets.append(right)
        cache.append(None)
    out = [None] * P
    for idxs in buckets:
        shape = (int(m_al[idxs].max()), int(n_al[idxs].max()))
        for i in idxs:
            out[i] = shape
    return out


def _bucketize(pairs, sites_list, m_floor=64, n_floor=128, keys=None,
               batch_rows=None):
    """Group pairs into shape buckets. ``keys``: optional precomputed
    per-pair (m_pad, n_pad) shape keys — the pipeline computes ONE
    global partition over the whole run and slices it per chunk, so
    every chunk fills with the same compiled shapes instead of
    re-deriving a slightly different data-dependent partition (and a
    fresh executable set) per chunk. ``batch_rows``: optional
    {key: batch size} each bucket is routed and padded at (at least),
    so the chunks' differing occupancies share one batch rung too."""
    buckets: dict[tuple[int, int], _Bucket] = {}
    if keys is None:
        keys = _bucket_keys(pairs, m_floor, n_floor)
    for k, key in enumerate(keys):
        b = buckets.get(key)
        if b is None:
            b = buckets[key] = _Bucket(key[0], key[1], [], None, None, None, None)
            if batch_rows:
                b.min_rows = int(batch_rows.get(key, 0))
        b.idx.append(k)
    for b in buckets.values():
        B = len(b.idx)
        # raw uint8 char planes (1 byte/char host-link transport); the
        # int32 sentinel layout the engines consume is reconstructed on
        # device by _sentinelize (or on host by _kernel_arrays)
        b.q = np.zeros((B, b.m_pad), dtype=np.uint8)
        b.t = np.zeros((B, b.n_pad), dtype=np.uint8)
        b.m = np.zeros(B, dtype=np.int32)
        b.n = np.zeros(B, dtype=np.int32)
        if sites_list is not None:
            b.allowed = np.ones((B, b.n_pad), dtype=bool)
        for r, k in enumerate(b.idx):
            q, t = pairs[k]
            b.q[r, : len(q)] = np.frombuffer(q, dtype=np.uint8)
            b.t[r, : len(t)] = np.frombuffer(t, dtype=np.uint8)
            b.m[r], b.n[r] = len(q), len(t)
            if sites_list is not None and sites_list[k] is not None:
                s = np.asarray(
                    [x for x in sites_list[k] if 0 <= x < b.n_pad], dtype=np.int64
                )
                b.allowed[r, s] = False
    # workload alphabet (from the true sequences, pads excluded): with
    # <= 4 distinct chars (DNA), _dev_inputs 2-bit-packs the transport
    seen = np.zeros(256, dtype=bool)
    for q, t in pairs:
        seen[np.frombuffer(q, dtype=np.uint8)] = True
        seen[np.frombuffer(t, dtype=np.uint8)] = True
    alpha = np.flatnonzero(seen).astype(np.uint8)
    if len(alpha) <= 4:
        lut = np.zeros(4, np.uint8)
        lut[: len(alpha)] = alpha
        for b in buckets.values():
            b.alpha = lut
    return buckets


# vmapped fills: batch over (q, t, n, params); n_pad / flags static.
# qs/ts arrive as raw uint8 planes; _sentinelize reconstructs the int32
# sentinel layout on device (ms rides ps[:, 5], exact in f32 for any
# sequence this side of 2^24).
@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _vfill(qs, ts, mode, n_pad, emit_ptrs, ns, ps):
    if qs.dtype == jnp.uint8:
        qs, ts = _sentinelize(qs, ts, ps[:, 5].astype(jnp.int32), ns)
    fill = {
        "global": _scan.global_fill,
        "local": _scan.local_fill,
        "overlap": _scan.overlap_fill,
        "edit": _scan.edit_fill,
    }[mode]
    if mode == "edit":
        return jax.vmap(lambda q, t, n, p: fill(q, t, n, p, n_pad))(qs, ts, ns, ps)
    return jax.vmap(lambda q, t, n, p: fill(q, t, n, p, n_pad, emit_ptrs))(
        qs, ts, ns, ps
    )


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _vfill_fit(qs, ts, allowed, n_pad, use_jump, emit_ptrs, ns, ps):
    if qs.dtype == jnp.uint8:
        qs, ts = _sentinelize(qs, ts, ps[:, 5].astype(jnp.int32), ns)
    return jax.vmap(
        lambda q, t, a, n, p: _scan.fit_fill(
            q, t, n, p, a, n_pad, use_jump, emit_ptrs
        )
    )(qs, ts, allowed, ns, ps)


# standalone widen jit: uint8 planes cross the host link, this tiny
# elementwise program (compiles in ms, unlike re-wrapping the engine
# fills in an outer jit, which re-traces their big scans) materializes
# the int32 sentinel layout in HBM for the unmodified engine fills
_sentinelize_dev = jax.jit(_sentinelize)


def _unpack2(p):
    """Device decode of a 2-bit packed char plane (B, L/4) -> (B, L)
    int32 codes — _pack2's inverse, shared by every blob decoder
    (_unpack_sentinelize, _kernel_widen)."""
    B, L4 = p.shape
    shifts = jnp.arange(0, 8, 2, dtype=jnp.uint8)
    codes = (p[:, :, None] >> shifts[None, None, :]) & 3
    return codes.reshape(B, L4 * 4).astype(jnp.int32)


def _pack2(plane: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Host 2-bit pack: map chars through the 4-entry alphabet ``lut``
    and pack 4 codes/byte (vectorized strided OR; pad chars map to
    code 0 and are re-masked by _sentinelize after decode)."""
    inv = np.zeros(256, np.uint8)
    inv[lut] = np.arange(4, dtype=np.uint8)
    c = inv[plane]
    return np.ascontiguousarray(
        c[:, 0::4]
        | (c[:, 1::4] << 2)
        | (c[:, 2::4] << 4)
        | (c[:, 3::4] << 6)
    )


def _meta_split(blob):
    """Device decode of the meta bytes riding the LAST 32 columns of the
    fused upload blob: bitcast back to the f32 (B, 8) matrix with
    columns [m, n, match, mismatch, gap_open, gap_extend, jump, 0],
    split into (ms, ns, ps) — ps in the engines' (B, 6) layout with m
    in col 5. Every value is an integer below 2^24, so the f32
    transport is exact (scores already flow as f32 through every
    engine)."""
    B = blob.shape[0]
    meta = jax.lax.bitcast_convert_type(
        blob[:, -32:].reshape(B, 8, 4), jnp.float32
    )
    ms = meta[:, 0].astype(jnp.int32)
    ns = meta[:, 1].astype(jnp.int32)
    ps = jnp.concatenate([meta[:, 2:7], meta[:, 0:1]], axis=1)
    return ms, ns, ps


@functools.partial(jax.jit, static_argnums=(0,))
def _unpack_sentinelize(qlen4, blob, lut):
    """Decode the fused upload blob (2-bit packed q | 2-bit packed t |
    meta bytes) on device and sentinelize: the char transport is 0.25
    bytes/char (DNA workloads move 4x fewer bytes than the uint8 path
    for one tiny fused gather)."""
    ms, ns, ps = _meta_split(blob)
    qc = jnp.take(lut.astype(jnp.int32), _unpack2(blob[:, :qlen4]))
    tc = jnp.take(lut.astype(jnp.int32), _unpack2(blob[:, qlen4:-32]))
    qi, ti = _sentinelize(qc, tc, ms, ns)
    return qi, ti, ns, ms, ps


@functools.partial(jax.jit, static_argnums=(0,))
def _widen_sentinelize(qlen, blob):
    """Fused uint8 blob (q | t | meta bytes) -> int32 sentinel planes +
    meta split."""
    ms, ns, ps = _meta_split(blob)
    qi, ti = _sentinelize(
        blob[:, :qlen].astype(jnp.int32),
        blob[:, qlen:-32].astype(jnp.int32), ms, ns,
    )
    return qi, ti, ns, ms, ps


_ALPHA_DEV: dict = {}


def _alpha_dev(alpha: np.ndarray):
    """The workload alphabet LUT, uploaded once per process (it is
    byte-identical across every bucket of a workload)."""
    key = alpha.tobytes()
    d = _ALPHA_DEV.get(key)
    if d is None:
        if len(_ALPHA_DEV) > 64:
            _ALPHA_DEV.clear()
        d = _ALPHA_DEV[key] = jnp.asarray(alpha)
    return d


def _dev_inputs(q_np, t_np, m_np, n_np, alpha=None,
                params: AlignParams | None = None):
    """Device (qi, ti, ns, ms, ps) from ONE host->device upload: a uint8
    blob of [chars (2-bit packed for <= 4-letter alphabets, else raw) |
    f32 meta bytes] decoded on device (_meta_split bitcasts the meta
    tail back to f32). One upload per bucket instead of six (q, t,
    alpha, ms, ns, params) pays one transfer's fixed cost."""
    if params is None:
        params = AlignParams()
    B = len(q_np)
    meta = np.zeros((B, 8), np.float32)
    meta[:, 0] = m_np
    meta[:, 1] = n_np
    meta[:, 2:7] = [params.match, params.mismatch, params.gap_open,
                    params.gap_extend, params.jump]
    meta_u8 = np.ascontiguousarray(meta).view(np.uint8).reshape(B, 32)
    if (
        alpha is not None
        and q_np.shape[1] % 4 == 0
        and t_np.shape[1] % 4 == 0
    ):
        blob = np.concatenate(
            [_pack2(q_np, alpha), _pack2(t_np, alpha), meta_u8], axis=1
        )
        return _unpack_sentinelize(
            q_np.shape[1] // 4, jnp.asarray(blob), _alpha_dev(alpha)
        )
    blob = np.concatenate(
        [np.asarray(q_np, np.uint8), np.asarray(t_np, np.uint8),
         meta_u8], axis=1
    )
    return _widen_sentinelize(q_np.shape[1], jnp.asarray(blob))


def _params_mat_np(p: AlignParams, ms: np.ndarray) -> np.ndarray:
    out = np.tile(
        np.array(
            [p.match, p.mismatch, p.gap_open, p.gap_extend, p.jump, 0],
            dtype=np.float32,
        ),
        (len(ms), 1),
    )
    out[:, 5] = ms
    return out


def _params_mat(p: AlignParams, ms: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(_params_mat_np(p, ms))


def _chunked_bucket_scores(mode, b, params: AlignParams, use_jump: bool):
    """Score a bucket on the column-chunked XLA engine (engine/chunked.py)
    — the large-batch long-target regime (engine/select.py use_chunked)."""
    from aligntools_tpu.engine import chunked as ck

    q_np, t_np, allowed_np, m_np, n_np = _pad_rows(b)
    qs, ts, ns, _, ps = _dev_inputs(q_np, t_np, m_np, n_np, b.alpha,
                                    params)
    if mode == "fit":
        allowed = jnp.asarray(
            allowed_np
            if allowed_np is not None
            else np.ones((len(q_np), b.n_pad), dtype=bool)
        )
        out = ck.chunked_fit_scores(
            use_jump, qs, ts, allowed, ns, ck.default_chunk(), params=ps
        )
    else:
        # static param property: all penalties non-positive lets local
        # skip its per-row latch mask (chunked_scores.decaying_params)
        decay = (
            params.mismatch <= 0
            and params.gap_open <= 0
            and params.gap_extend <= 0
        )
        out = ck.chunked_scores(
            mode, qs, ts, ns, ck.default_chunk(), params=ps,
            decaying_params=decay,
        )
    return out  # lazy device vector; align_batch syncs in one wave


def _dispatch_scores(mode, b, params, use_jump, engine, counters):
    """Dispatch ONE score bucket's device fill without syncing: returns
    the lazy device score vector (batch-rung / tile pad rows included —
    callers index results through ``b.idx``). Routing is
    engine/select.py's: the chunked engine from its batch crossover up,
    the vmapped row-scan machines below it (``engine="xla"``: always)."""
    if engine == "auto" and _select.use_chunked(b.rows, b.n_pad):
        _acct(counters, _pad_batch(b.rows), b, "chunked")
        return _chunked_bucket_scores(mode, b, params, use_jump)
    q_np, t_np, allowed_np, m_np, n_np = _pad_rows(b)
    _acct(counters, len(q_np), b, "vmap")
    ps = _params_mat(params, m_np)
    ns = jnp.asarray(np.ascontiguousarray(n_np, np.int32))
    qs, ts = jnp.asarray(q_np), jnp.asarray(t_np)
    if mode == "fit":
        allowed = jnp.asarray(
            allowed_np
            if allowed_np is not None
            else np.ones((len(q_np), b.n_pad), dtype=bool)
        )
        return _vfill_fit(qs, ts, allowed, b.n_pad, use_jump, False,
                          ns, ps)[0]
    if mode == "edit":
        return _vfill(qs, ts, mode, b.n_pad, False, ns, ps)
    return _vfill(qs, ts, mode, b.n_pad, False, ns, ps)[0]


def _tick(counters, field: str, t0: float) -> float:
    """Accumulate a stage duration into ``counters.field``; returns a new
    t0 so call sites can chain stages."""
    t1 = time.perf_counter()
    if counters is not None:
        setattr(counters, field, getattr(counters, field) + t1 - t0)
    return t1


# ---------------------------------------------------------------------------
# Full-alignment (rows) path: HBM budget router
#
# The pointer tensor is the only O(B*m*n) allocation in the system; at
# 256 x 8192^2 an unpacked byte layout is 16 GiB. The
# router (a) packs pointers as tightly as the mode allows (nibble for the
# affine family, 2-bit for overlap — chunked fills emit packed bytes
# inside the scan and are walked in their raw block layout, so peak HBM
# is exactly the packed bytes), (b) slices a bucket's batch so one fill's
# tensor fits the budget, and (c) when even a single pair cannot fit,
# falls back to engine/rescan.py (O(m*n/S) checkpoints, validated at 1M
# columns). No full-alignment shape can OOM. Reference-at-scale behavior
# being matched: the traceback routines src/alignment.h:372-412, 558-592,
# 766-800, 896-922 on tmp.fa-class inputs.
# ---------------------------------------------------------------------------

PTR_BUDGET_FRAC = 0.45  # share of device memory the pointer tensor may use


def _hbm_budget() -> int:
    """Device memory limit in bytes (ALIGNTOOLS_HBM_BUDGET overrides; the
    env knob is also how tests exercise the router on CPU). On the GPU
    this is the allocator's ``bytes_limit``, which is already the share
    of the card that JAX reserved (75% by default); on the CPU it is the
    host's physical memory."""
    env = os.environ.get("ALIGNTOOLS_HBM_BUDGET")
    if env:
        return int(env)
    dev = jax.local_devices()[0]
    if dev.platform == "cpu":
        return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    lim = (dev.memory_stats() or {}).get("bytes_limit")
    if not lim:
        raise RuntimeError(
            f"cannot read the memory limit of {dev.device_kind}; set "
            f"ALIGNTOOLS_HBM_BUDGET to the bytes the rows path may use"
        )
    return int(lim)


def _chunked_rpb(mode: str, use_jump: bool, m_pad: int) -> int:
    """Pointer packing density for the chunked ptr fills (rows/byte)."""
    if mode == "fit" and use_jump:
        return 1  # 6-bit cells: pM spans 5 values + pJ bit
    if mode == "overlap" and m_pad % 4 == 0:
        return 4
    if m_pad % 2 == 0:
        return 2
    return 1


def _rows_ptr_bytes_pp(mode, b, use_jump, engine, batch: int) -> float:
    """Per-pair pointer-tensor bytes (including transient assemble copies)
    the rows path will materialize for a fill of ``batch`` pairs of this
    bucket's shape — mirrors _bucket_rows' routing."""
    m_pad, n_pad = b.m_pad, b.n_pad
    if engine == "auto" and _select.use_chunked(batch, n_pad):
        rpb = _chunked_rpb(mode, use_jump, m_pad)
        if rpb > 1:
            return m_pad * (n_pad + 1) / rpb  # raw block layout, no copy
        return 2.5 * m_pad * (n_pad + 1)  # byte layout + assemble copy
    return 2.5 * float(m_pad) * (n_pad + 1)  # unpacked vmap fill


def _slice_bucket(b: _Bucket, lo: int, hi: int) -> _Bucket:
    sub = _Bucket(
        b.m_pad, b.n_pad, b.idx[lo:hi], b.q[lo:hi], b.t[lo:hi],
        b.m[lo:hi], b.n[lo:hi],
    )
    if b.allowed is not None:
        sub.allowed = b.allowed[lo:hi]
    sub.alpha = b.alpha  # keep the 2-bit DNA transport on sliced buckets
    return sub


def _auto_stride(m: int, n_pad: int, budget: int) -> int:
    """Rescan row-block stride: balance checkpoint memory
    ((m/S) * states * 4 * n) against the live pointer block (S * n),
    then grow until the checkpoints fit the budget."""
    import math

    s = max(256, int(math.sqrt(16.0 * max(m, 1))))
    s = -(-s // 8) * 8
    while m > s and (m / s) * 16 * (n_pad + 1) > budget * 0.4:
        s *= 2
    return s


def _rescan_bucket(mode, b, params, use_jump, pairs, sites_list, results,
                   budget):
    """Last-resort route: per-pair checkpoint-rescan traceback
    (engine/rescan.py) — O(m*n/S) memory, any shape."""
    from aligntools_tpu.engine.rescan import rescan_align
    from aligntools_tpu.engine.scan import pad_len

    for k in b.idx:
        q, t = pairs[k]
        sites = None
        if use_jump and sites_list is not None:
            sites = sites_list[k]
        stride = _auto_stride(len(q), pad_len(max(1, len(t))), budget)
        results[k] = rescan_align(
            mode, q, t, params, sites=sites, stride=stride
        )


@dataclasses.dataclass
class _PendingRows:
    """A dispatched (fill + device walk) awaiting collection."""

    mode: str
    b: _Bucket
    handle: tuple  # device_tb.walk_dispatch handle (scores ride extras)
    bpairs: list


def _collect_rows_wave(pends: list, results, counters=None):
    """Collect a WAVE of dispatched buckets in two host round trips
    total: one concatenated fused scalar pull (count/fi/fj/err + the
    fills' scores — also syncs the fills), then one concatenated cols
    pull, each bucket's slice bounded by its longest actual walk."""

    if not pends:
        return
    from aligntools_tpu.engine import device_tb

    t0 = time.perf_counter()
    scals = device_tb.walk_scalars_many([p.handle for p in pends])
    t0 = _tick(counters, "fill_seconds", t0)
    for p, scal in zip(pends, scals):
        if p.mode == "fit" and not np.all(
            np.isfinite(scal[4][0][: len(p.b.idx)])
        ):
            raise RuntimeError(
                "fit: no finite traceback start (reference UB)"
            )
    rows_list = device_tb.walk_rows_many(
        [p.handle for p in pends], scals, [p.bpairs for p in pends]
    )
    for p, scal, rows in zip(pends, scals, rows_list):
        scores = scal[4][0]
        for r, k in enumerate(p.b.idx):
            results[k] = AlignResult(float(scores[r]), *rows[r])
    _tick(counters, "walk_seconds", t0)


def _walk_on_device() -> bool:
    """Device walk (engine/device_tb.py) on any accelerator; the host
    walk (engine/traceback.py) on the CPU."""
    return not jax.local_devices()[0].platform == "cpu"


def _bucket_rows(mode, b, params, use_jump, pairs, results, engine,
                 counters=None, pipeline_out=None):
    """Full-alignment path for one bucket (or budget slice): pointer-
    emitting fill + batched walk, routed per engine/select.py.

    ``pipeline_out``: optional list — when the device-walk path applies,
    the dispatched work is appended as a _PendingRows instead of being
    collected synchronously, letting align_batch overlap consecutive
    buckets' fills and walks (collection order is preserved by the
    caller)."""
    t0 = time.perf_counter()
    q_np, t_np, allowed_np, m_np, n_np = _pad_rows(b)
    Bp = len(q_np)
    # Full-alignment fills in the chunked engine's regime ride its faster
    # fill too — the pointer variants return the exact vmapped fill
    # tuples (bit-identical starts; packed bytes walk identically,
    # tests/test_chunked.py), so everything downstream is shared.
    chunked_full = engine == "auto" and _select.use_chunked(
        b.rows, b.n_pad
    )
    _acct(counters, Bp, b, "chunked" if chunked_full else "vmap")
    rpb, blk_chunk = 1, 0
    msd = None
    if chunked_full:
        from aligntools_tpu.engine import chunked as ck

        rpb = _chunked_rpb(mode, use_jump, b.m_pad)
        if rpb > 1:
            blk_chunk = ck.pick_chunk(b.n_pad, ck.default_chunk())[1]
        # chunked fills take the int32 sentinel planes (widened on
        # device from the fused two-upload transport)
        qs, ts, ns, msd, ps = _dev_inputs(q_np, t_np, m_np, n_np,
                                          b.alpha, params)
    else:
        # the vmap fills widen inside their own jit
        ps = _params_mat(params, m_np)
        ns = jnp.asarray(np.ascontiguousarray(n_np, np.int32))
        qs, ts = jnp.asarray(q_np), jnp.asarray(t_np)
    if mode == "fit":
        allowed = jnp.asarray(
            allowed_np
            if allowed_np is not None
            else np.ones((Bp, b.n_pad), dtype=bool)
        )
        if chunked_full:
            out = ck.chunked_fit_ptr_fill(
                use_jump, qs, ts, allowed, ns, ck.default_chunk(), rpb,
                params=ps,
            )
        else:
            out = _vfill_fit(qs, ts, allowed, b.n_pad, use_jump, True,
                             ns, ps)
    elif chunked_full:
        out = ck.chunked_ptr_fill(
            mode, qs, ts, ns, ck.default_chunk(), rpb, params=ps
        )
    else:
        out = _vfill(qs, ts, mode, b.n_pad, True, ns, ps)
    # On an accelerator, walk tracebacks on the device: the walk moves
    # only the rows to the host, not the O(B*m*n) pointer tensor. The
    # packed block layout (rpb > 1) is walkable only by the device walker.
    if _walk_on_device() or blk_chunk:
        from aligntools_tpu.engine import device_tb

        # walk inputs padded to the fill's batch rung (the walk jit
        # specializes on B too); pad rows walk the sentinel DP's own
        # pointers from (1, 1) and their rows are discarded at scatter
        bpairs = [pairs[k] for k in b.idx]
        bpairs += [(b"A", b"C")] * (Bp - len(b.idx))
        # walk starts derived ON DEVICE from the fill outputs: the fill
        # -> walk hop needs no host round trip, so consecutive buckets'
        # fills and walks overlap on the device queue (align_batch
        # windows the outstanding pointer tensors by the HBM budget)
        if msd is None:  # chunked path derives it from the meta blob
            msd = jnp.asarray(np.ascontiguousarray(m_np, np.int32))
        if mode == "global":
            # engine start codes 0/1/2 = L/M/U match walk states
            dstarts = (out[1], msd, ns)
        elif mode == "local":
            dstarts = (jnp.ones(Bp, jnp.int32), out[1], out[2])
        elif mode == "fit":
            dstarts = (
                jnp.where(out[1] == 0, 1, 0).astype(jnp.int32),
                msd, out[2],
            )
        else:  # overlap
            dstarts = (jnp.zeros(Bp, jnp.int32), msd, out[1])
        # the walk reads chars from the fill's DEVICE-resident planes
        # (qs/ts) rather than uploading the host planes a second time
        h = device_tb.walk_dispatch(
            mode, out[-1], qs, ts, dstarts,
            col_base=1 if blk_chunk else 0, pack4=rpb,
            blk_chunk=blk_chunk, extras=(out[0],),
        )
        pend = _PendingRows(mode, b, h, bpairs)
        _tick(counters, "fill_seconds", t0)
        if pipeline_out is not None:
            pipeline_out.append(pend)
            return
        _collect_rows_wave([pend], results, counters)
        return
    out = jax.tree.map(np.asarray, out)
    t0 = _tick(counters, "fill_seconds", t0)
    for r, k in enumerate(b.idx):
        q, t = pairs[k]
        m, n = len(q), len(t)
        if mode == "global":
            score, state, ptrs = out[0][r], out[1][r], out[2]
            r1, r2 = tb.traceback_global(q, t, ptrs[r], int(state), m, n)
        elif mode == "local":
            score, imax, jmax, ptrs = (
                out[0][r], out[1][r], out[2][r], out[3]
            )
            r1, r2 = tb.traceback_local(q, t, ptrs[r], int(imax),
                                        int(jmax))
        elif mode == "fit":
            score, state, jmax, ptrs = (
                out[0][r], out[1][r], out[2][r], out[3]
            )
            if not np.isfinite(float(score)):
                raise RuntimeError(
                    "fit: no finite traceback start (reference UB)"
                )
            r1, r2 = tb.traceback_fit(q, t, ptrs[r], int(state), m,
                                      int(jmax))
        else:  # overlap
            score, jmax, ptrs = out[0][r], out[1][r], out[2]
            r1, r2 = tb.traceback_overlap(q, t, ptrs[r], m, int(jmax))
        results[k] = AlignResult(float(score), r1, r2)
    _tick(counters, "walk_seconds", t0)


def align_batch(
    mode: str,
    pairs: Sequence[tuple[bytes, bytes]],
    params: AlignParams = AlignParams(),
    sites_list: Sequence[Sequence[int] | None] | None = None,
    traceback: bool = True,
    engine: str = "auto",
    counters=None,
    keys=None,
    batch_rows=None,
):
    """Align many pairs. Returns a list parallel to ``pairs``:
    AlignResult per pair (int for mode='edit'); with ``traceback=False``,
    AlignResults carry empty rows (score-only, no pointer tensors).
    ``counters``: optional utils.profiling.Counters accumulating the
    encode/fill/walk stage decomposition. ``keys`` and ``batch_rows``:
    optional precomputed per-pair bucket shape keys and per-shape batch
    sizes (see _bucketize) so a chunked pipeline reuses one global
    partition's compiled shapes and batch rungs."""
    if mode == "fit":
        for q, t in pairs:
            if len(q) > len(t):
                raise ValueError("first sequence must be shorter than the second")
    if pairs:
        worst = max(len(q) + len(t) for q, t in pairs)
        _scan.check_f32_exact(params, worst, 0, mode)
    use_jump = sites_list is not None
    t0 = time.perf_counter()
    buckets = _bucketize(pairs, sites_list if use_jump else None,
                         keys=keys, batch_rows=batch_rows)
    t0 = _tick(counters, "encode_seconds", t0)
    results: list = [None] * len(pairs)
    if mode == "edit" or not traceback:
        # Score-only: dispatch EVERY bucket's fill before syncing any.
        # JAX dispatch is async, so host work and transfers overlap
        # device compute across buckets; one collect wave then pulls the
        # tiny score vectors.
        tf = time.perf_counter()
        lazy = []
        for b in buckets.values():
            lazy.append((b, _dispatch_scores(
                mode, b, params, use_jump, engine, counters
            )))
        # ONE device->host pull for all buckets (one sync, not one per
        # bucket)
        if len(lazy) > 1:
            # edit distances stay int32 in the concat: a float32 pull
            # would round distances above 2^24
            cdt = jnp.int32 if mode == "edit" else jnp.float32
            flat = np.asarray(jnp.concatenate(
                [jnp.ravel(out).astype(cdt) for _, out in lazy]
            ))
            off = 0
            allvals = []
            for _, out in lazy:
                sz = int(np.prod(out.shape))
                allvals.append(flat[off : off + sz])
                off += sz
        else:
            allvals = [np.asarray(out) for _, out in lazy]
        for (b, _), vals in zip(lazy, allvals):
            for r, k in enumerate(b.idx):
                results[k] = (
                    int(vals[r]) if mode == "edit"
                    else AlignResult(float(vals[r]), b"", b"")
                )
        _tick(counters, "fill_seconds", tf)
        return results
    # rows path: HBM budget router (see the block comment above) with a
    # dispatch window — consecutive buckets' fills and device walks
    # overlap on the device queue, bounded so the OUTSTANDING pointer
    # tensors never exceed the budget
    budget = int(_hbm_budget() * PTR_BUDGET_FRAC)
    pending: list = []
    pending_bytes: list = []

    def _flush_all():
        # wave collection: 2 round trips for the whole window (all the
        # window's fills+walks were already dispatched, so freeing
        # everything costs no recompute)
        _collect_rows_wave(pending, results, counters)
        pending.clear()
        pending_bytes.clear()

    for b in buckets.values():
        bytes_pp = _rows_ptr_bytes_pp(mode, b, use_jump, engine, b.rows)
        cap = int(budget // bytes_pp)
        if 0 < cap < _pad_batch(b.rows):
            # slices of at most ``cap`` pairs may fall below the chunked
            # crossover onto the vmap fill, which packs less tightly
            bytes_pp = max(bytes_pp, _rows_ptr_bytes_pp(
                mode, b, use_jump, engine, cap))
            cap = int(budget // bytes_pp)
        if cap == 0:
            _flush_all()
            _rescan_bucket(mode, b, params, use_jump, pairs, sites_list,
                           results, budget)
            continue

        def _dispatch(sb):
            est = bytes_pp * _pad_batch(sb.rows)
            if pending and sum(pending_bytes) + est > budget:
                _flush_all()
            n0 = len(pending)
            _bucket_rows(mode, sb, params, use_jump, pairs, results,
                         engine, counters, pipeline_out=pending)
            if len(pending) > n0:  # sync paths collect internally
                pending_bytes.append(est)

        if _pad_batch(b.rows) > cap:
            # equal-size slices, each padded to ``step`` rows (one
            # compiled batch shape); the fill allocates the batch RUNG,
            # so size slices by it
            nsl = -(-b.rows // cap)
            step = -(-b.rows // nsl)
            while step > 1 and _pad_batch(step) > cap:
                nsl += 1
                step = -(-b.rows // nsl)
            for lo in range(0, len(b.idx), step):
                sb = _slice_bucket(b, lo, lo + step)
                sb.min_rows = step
                _dispatch(sb)
        else:
            _dispatch(b)
    _flush_all()
    return results


def batch_scores(
    mode: str,
    pairs: Sequence[tuple[bytes, bytes]],
    params: AlignParams = AlignParams(),
    sites_list=None,
    engine: str = "auto",
    counters=None,
    keys=None,
    batch_rows=None,
) -> np.ndarray:
    """Score-only fast path; returns float64 scores (int values for edit)."""
    res = align_batch(
        mode, pairs, params, sites_list, traceback=False, engine=engine,
        counters=counters, keys=keys, batch_rows=batch_rows
    )
    if mode == "edit":
        return np.asarray(res, dtype=np.int64)
    return np.asarray([r.score for r in res])
