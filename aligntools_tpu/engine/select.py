"""Engine selection: route each shape bucket to the faster exact engine.

Two XLA engines fill a bucket, bit-identical to each other
(tests/test_chunked.py):

  * the column-chunked engine (engine/chunked.py): the batched row scan
    in column chunks of ``default_chunk()`` with carried row edges, at
    any target length;
  * the vmapped row-scan engine (engine/scan.py): one ``lax.scan`` over
    rows of full target width, vmapped over the batch.

On the GPU a bucket takes the chunked engine when its target fits one
chunk (``n_pad <= default_chunk()``) or its batch reaches the measured
crossover ``chunked_bmin`` (engine/autotune.py holds the default and the
per-device calibration), and the vmap engine otherwise: the chunked
engine pays a fixed cost per row step in every chunk, which small batches
of long rows cannot amortize (PERF.md, "Bring-up findings").
Full-alignment buckets follow the same rule through the pointer-emitting
variants of both engines. On the CPU (tests, ``JAX_PLATFORMS=cpu``)
every bucket takes the vmap engine; tests force the chunked route by
patching ``use_chunked``.
"""

from __future__ import annotations


def use_chunked(batch: int, n_pad: int) -> bool:
    """True if the column-chunked engine fills this bucket.
    ALIGNTOOLS_NO_CHUNKED=1 disables it."""
    import os

    from aligntools_tpu.backend import on_gpu

    if os.environ.get("ALIGNTOOLS_NO_CHUNKED") == "1" or not on_gpu():
        return False
    from aligntools_tpu.engine.autotune import table
    from aligntools_tpu.engine.chunked import default_chunk

    return n_pad <= default_chunk() or batch >= table()["chunked_bmin"]
