"""Multi-chip / multi-host execution: batch data-parallel sharding.

The reference is strictly single-core (SURVEY.md §2.4); everything here is
new design. The batch axis of each length bucket is
sharded over the mesh's ``data`` axis with ``shard_map`` — each device runs
the same vmapped row-scan fill on its local batch shard (zero cross-device
traffic during the fill; DP cells of different pairs are independent), and
one ``psum`` aggregates batch statistics across devices. Scores land fully
replicated via ``all_gather`` so host 0 owns printing, mirroring the
reference's stdout contract.

Multi-host: under ``jax.distributed`` the same mesh spans hosts (the
network between hosts, NVLink within); ``batch_scores_sharded`` only touches
addressable shards, and the gather rides the mesh collectives.

Sequence parallelism (one long pair sharded across chips) lives in
parallel/seqpar.py.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from aligntools_tpu.params import AlignParams


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 7))
def _sharded_fill(mode, n_pad, mesh, qs, ts, ns, ps, decay=False):
    """Score-only fill with the batch axis sharded over mesh('data').

    Returns (scores [B] replicated, n_finite [] psum'd cell-count stat) —
    the psum is the collective that multi-host result aggregation rides
    on.
    """

    def local(qs, ts, ns, ps):
        # Each device fills its local batch shard on the column-chunked
        # batched engine (engine/chunked.py) — the large-batch route of
        # engine/select.use_chunked, bit-identical to the vmapped
        # machines everywhere (tests/test_chunked.py).
        from aligntools_tpu.engine import chunked as ck

        vals = ck.chunked_scores(mode, qs, ts, ns, ck.default_chunk(),
                                 params=ps, decaying_params=decay)
        total = jax.lax.psum(jnp.sum(jnp.isfinite(vals)), "data")
        gathered = jax.lax.all_gather(vals, "data", tiled=True)
        return gathered, total

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data")),
        out_specs=(P(), P()),
        # the row-scan carries start from unvarying constants; disable the
        # varying-manual-axes check rather than pcast-ing every border row
        check_vma=False,
    )(qs, ts, ns, ps)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _sharded_fill_fit(use_jump, n_pad, mesh, qs, ts, allow, ns, ps):
    """Fit-mode (+ optional junction jump) sharded score fill — same
    collectives as _sharded_fill, with the per-pair jump-entry mask
    sharded alongside the batch."""

    def local(qs, ts, allow, ns, ps):
        from aligntools_tpu.engine import chunked as ck

        vals = ck.chunked_fit_scores(use_jump, qs, ts, allow, ns,
                                     ck.default_chunk(), params=ps)
        total = jax.lax.psum(jnp.sum(jnp.isfinite(vals)), "data")
        gathered = jax.lax.all_gather(vals, "data", tiled=True)
        return gathered, total

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data"),) * 5,
        out_specs=(P(), P()),
        check_vma=False,
    )(qs, ts, allow, ns, ps)


def batch_scores_sharded(
    mode: str,
    pairs: Sequence[tuple[bytes, bytes]],
    params: AlignParams = AlignParams(),
    mesh: Mesh | None = None,
    sites_list: Sequence[Sequence[int] | None] | None = None,
) -> np.ndarray:
    """Data-parallel score-only batch over the mesh. Pads the batch count
    to a multiple of the mesh size; all pairs share one shape bucket
    (max-length padding) so every device executes the same program.
    ``sites_list`` (fit mode): per-pair junction sites — enables the
    jump state with its entry mask sharded alongside the batch."""
    from aligntools_tpu.batch import bucket_len

    if mesh is None:
        mesh = make_mesh()
    d = mesh.devices.size
    B = len(pairs)
    m_pad = bucket_len(max(len(q) for q, _ in pairs), 64)
    n_pad = bucket_len(max(len(t) for _, t in pairs), 128)
    Bp = -(-B // d) * d
    q = np.full((Bp, m_pad), -1, dtype=np.int32)
    t = np.full((Bp, n_pad), -2, dtype=np.int32)
    ms = np.zeros(Bp, dtype=np.int32)
    ns = np.ones(Bp, dtype=np.int32)  # pad rows: n=1 keeps fills well-defined
    for k, (qb, tb) in enumerate(pairs):
        q[k, : len(qb)] = np.frombuffer(qb, dtype=np.uint8)
        t[k, : len(tb)] = np.frombuffer(tb, dtype=np.uint8)
        ms[k], ns[k] = len(qb), len(tb)
    pmat = np.tile(
        np.array(
            [params.match, params.mismatch, params.gap_open,
             params.gap_extend, params.jump, 0],
            dtype=np.float32,
        ),
        (Bp, 1),
    )
    pmat[:, 5] = ms
    shard = NamedSharding(mesh, P("data"))
    # every process builds the same global host arrays (each host reads
    # the same input), so the per-shard callback just slices — this is
    # the multi-process-correct construction (device_put with a global
    # array only works single-process) and identical on one process
    host = [q, t, ns, pmat]
    if mode == "fit":
        allow = np.ones((Bp, n_pad), dtype=bool)
        use_jump = sites_list is not None
        if use_jump:
            for k, sites in enumerate(sites_list):
                if sites:
                    s = np.asarray(
                        [x for x in sites if 0 <= x < n_pad], np.int64
                    )
                    allow[k, s] = False
        host.insert(2, allow)
    args = [
        jax.make_array_from_callback(
            a.shape, shard, lambda idx, a=a: a[idx]
        )
        for a in host
    ]
    if mode == "fit":
        scores, _ = _sharded_fill_fit(use_jump, n_pad, mesh, *args)
    else:
        decay = (
            params.mismatch <= 0
            and params.gap_open <= 0
            and params.gap_extend <= 0
        )
        scores, _ = _sharded_fill(mode, n_pad, mesh, *args, decay)
    out = np.asarray(scores)[:B]
    if mode == "edit":
        return out.astype(np.int64)
    return out
