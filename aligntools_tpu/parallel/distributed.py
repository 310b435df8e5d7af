"""Multi-host execution: initialization, result gather, failure handling.

The reference is a single process with ``die() -> exit(-1)`` as its entire
failure story (SURVEY.md §5; alignment.h:69-79). The equivalent here, for
multi-host runs:

  * ``init_multihost()`` — ``jax.distributed.initialize`` from the standard
    coordinator env (JAX_COORDINATOR_ADDRESS etc.), with a barrier so every
    host either enters the run or the whole job aborts together;
  * ``gather_to_host0`` — collective result gather over DCN so process 0
    owns all printing (the stdout contract stays byte-identical to the
    reference's single process);
  * ``abort_all`` — clean whole-job teardown on any host's failure (the
    distributed runtime propagates the error to every process instead of
    leaving a hung collective).

Single-process runs (the common case, and all CI) are no-ops throughout,
so every call site can use these unconditionally.
"""

from __future__ import annotations

import sys

import jax
import numpy as np


def is_multihost() -> bool:
    return jax.process_count() > 1


def init_multihost(timeout_s: int = 300) -> None:
    """Initialize jax.distributed from environment (no-op single-host).

    Must run before any jax device use on every host. A failed/partial
    initialization raises on every host rather than hanging: the
    coordinator enforces ``timeout_s``.
    """
    import os

    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None:
        return  # single host
    # jax's auto-detection covers cluster schedulers (SLURM etc.) but not
    # plain env launches: pass the triplet explicitly when provided
    kwargs = {}
    if os.environ.get("JAX_NUM_PROCESSES"):
        kwargs = dict(
            coordinator_address=addr,
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=int(os.environ.get("JAX_PROCESS_ID", "0")),
        )
    jax.distributed.initialize(
        initialization_timeout=timeout_s,
        **kwargs,
    )
    barrier("aligntools-init")


def barrier(name: str) -> None:
    """All-host barrier (no-op single-host)."""
    if not is_multihost():
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def gather_to_host0(local_values: np.ndarray) -> np.ndarray | None:
    """Gather per-host result arrays to process 0 (returns None elsewhere).

    Values ride DCN via the standard process_allgather; every host calls
    this collectively."""
    if not is_multihost():
        return local_values
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(local_values)
    return gathered.reshape(-1, *local_values.shape[1:]) if (
        jax.process_index() == 0
    ) else None


def abort_all(err: BaseException) -> None:
    """Tear the whole job down after a local failure (clean abort rather
    than a hung collective on the other hosts)."""
    sys.stderr.write(f"FATAL ERROR (host {jax.process_index()}): {err}\n")
    if is_multihost():
        try:
            jax.distributed.shutdown()
        finally:
            sys.exit(1)
    sys.exit(1)
