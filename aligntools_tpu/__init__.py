"""aligntools_tpu — batched pairwise sequence alignment engine for the GPU.

A JAX/XLA implementation of the five DP alignment modes of
r3fang/alignTools.C (global, local, fit+jump, overlap, edit distance), with
exact score and alignment-string parity against the reference C binary,
batched and sharded across GPUs.
"""

from aligntools_tpu.params import AlignParams, MODES
from aligntools_tpu.version import __version__

__all__ = ["AlignParams", "MODES", "__version__", "align_pair", "align_batch",
           "batch_scores"]


def __getattr__(name):  # lazy: keep `import aligntools_tpu` JAX-free
    if name == "align_pair":
        from aligntools_tpu.api import align_pair

        return align_pair
    if name in ("align_batch", "batch_scores"):
        from aligntools_tpu import batch

        return getattr(batch, name)
    raise AttributeError(name)
