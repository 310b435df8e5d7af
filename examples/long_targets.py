"""Long-target scaling: full rows at lengths past a full pointer matrix.

The reference mallocs O(m*n) doubles per alignment (~7 GB for its own
114k-column stress pair, test/tmp.fa in its checkout). This framework
scales the same workloads three ways:

  * the column-chunked engine (engine/chunked.py) — the target in column
    chunks with carried row edges, packed pointers walked on device;
  * checkpoint-rescan traceback (engine/rescan.py) — O(m * stride)
    memory, full rows at ANY length;
  * sequence parallelism (parallel/seqpar.py) — the TARGET axis sharded
    over a device mesh, per-row ppermute boundary exchange, pointer
    slabs walked on device; rows byte-identical to single-device.

Run on CPU with a virtual mesh:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/long_targets.py
"""

import numpy as np

from aligntools_tpu import AlignParams

p = AlignParams()
rng = np.random.default_rng(0)
alpha = list(b"ACGT")

# a 512 bp read inside a 100k synthetic gene, 5% mutations
n = 100_000
gene = rng.choice(alpha, n)
read = gene[60_000:60_512].copy()
mut = rng.random(512) < 0.05
read[mut] = rng.choice(alpha, int(mut.sum()))
read_b, gene_b = bytes(read.tolist()), bytes(gene.tolist())

# 1. checkpoint-rescan: linear-memory full alignment
from aligntools_tpu.engine.rescan import rescan_align

r = rescan_align("fit", read_b, gene_b, p, stride=256)
print(f"rescan fit @100k: score={r.score} rows={len(r.row1)} chars")

# 2. sequence-parallel full alignment: target sharded over all devices
import jax

if len(jax.devices()) > 1:
    from aligntools_tpu.parallel.seqpar import seqpar_align

    r2 = seqpar_align("fit", read_b, gene_b, p)
    assert (r2.score, r2.row1, r2.row2) == (r.score, r.row1, r.row2)
    print(f"seqpar fit over {len(jax.devices())} devices: byte-identical")
else:
    print("seqpar: single device, skipped (run with the virtual mesh)")
