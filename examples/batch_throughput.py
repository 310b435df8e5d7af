"""Throughput: thousands of pairs, bucketed + vmapped on the device.

Run on the GPU (default backend) or CPU (JAX_PLATFORMS=cpu)."""
import numpy as np

from aligntools_tpu import AlignParams, batch_scores, align_batch

rng = np.random.default_rng(0)
alpha = list(b"ACGT")
pairs = [
    (bytes(rng.choice(alpha, int(rng.integers(200, 1000))).tolist()),
     bytes(rng.choice(alpha, int(rng.integers(200, 1000))).tolist()))
    for _ in range(2000)
]

scores = batch_scores("local", pairs, AlignParams())          # score-only
results = align_batch("global", pairs[:100], AlignParams())   # + alignments
print(len(scores), "scores; first alignment:",
      results[0].score, results[0].row1[:40])
