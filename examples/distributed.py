"""Multi-device execution: dp batch sharding, sequence parallelism, and
their 2D composition. Run on several GPUs, or simulate on the CPU:

  JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python distributed.py
"""
import jax
import numpy as np
from jax.sharding import Mesh

from aligntools_tpu import AlignParams
from aligntools_tpu.parallel.mesh import batch_scores_sharded
from aligntools_tpu.parallel.seqpar import seqpar_score, seqpar_batch_scores

rng = np.random.default_rng(0)
alpha = list(b"ACGT")
pairs = [
    (bytes(rng.choice(alpha, 120).tolist()),
     bytes(rng.choice(alpha, 360).tolist()))
    for _ in range(64)
]
p = AlignParams()

# dp: batch axis sharded over every device
print("dp:", batch_scores_sharded("local", pairs, p)[:4])

# sp: ONE pair's target sharded across all devices
q = bytes(rng.choice(alpha, 80).tolist())
t = bytes(rng.choice(alpha, 4000).tolist())
print("sp:", seqpar_score("fit", q, t, p, sites=[100, 2000]))

# dp x sp on a 2D mesh
devs = np.asarray(jax.devices())
if devs.size >= 4:
    mesh = Mesh(devs.reshape(2, -1), ("data", "seq"))
    print("dp x sp:", seqpar_batch_scores("local", pairs[:8], p, mesh=mesh)[:4])
