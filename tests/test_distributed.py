"""Multi-host wrappers (parallel/distributed.py) under a REAL 2-process
jax.distributed job on the CPU backend.

Earlier these ran only as single-process no-ops; here two subprocesses form an actual coordinator/client pair over
localhost DCN, so init_multihost / barrier / gather_to_host0 run their
multihost branches: process_allgather moves real data and the barrier
synchronizes both sides. abort_all's exit path stays covered by the
single-process unit test below (killing a live collective would leave
the peer to the coordinator timeout — too slow for CI).
"""

import os
import socket
import subprocess
import sys

import numpy as np

_WORKER = r"""
import os, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.environ["ALIGNTOOLS_REPO"])
from aligntools_tpu.parallel import distributed as dist

dist.init_multihost(timeout_s=60)
assert jax.process_count() == 2, jax.process_count()
pid = jax.process_index()

local = np.asarray([[pid * 10 + 1, pid * 10 + 2]], np.int32)
got = dist.gather_to_host0(local)
if pid == 0:
    assert got is not None and got.shape == (2, 2), got
    assert got.tolist() == [[1, 2], [11, 12]], got.tolist()
else:
    assert got is None, got

dist.barrier("test-end")

# dp-sharded scores over the REAL 2-process x 4-device global mesh,
# compared on every process against the replicated-local oracle
from aligntools_tpu.batch import batch_scores
from aligntools_tpu.params import AlignParams
from aligntools_tpu.parallel.mesh import batch_scores_sharded

assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4
rng = np.random.default_rng(23)
pairs = [
    (bytes(rng.choice(list(b"ACGT"), int(rng.integers(5, 40))).tolist()),
     bytes(rng.choice(list(b"ACGT"), int(rng.integers(5, 90))).tolist()))
    for _ in range(11)
]
p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
got = batch_scores_sharded("local", pairs, p)
want = batch_scores("local", pairs, p)
assert np.array_equal(got, want), (got, want)

dist.barrier("test-scores")
print(f"proc{pid} OK", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gather_and_barrier(tmp_path):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = []
    for pid in (0, 1):
        env = dict(
            os.environ,
            ALIGNTOOLS_REPO=repo,
            JAX_PLATFORMS="cpu",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, str(script)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = []
    for pr in procs:
        try:
            out, err = pr.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for p2 in procs:
                p2.kill()
            raise
        outs.append((pr.returncode, out, err))
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, (pid, out, err[-2000:])
        assert f"proc{pid} OK" in out, (pid, out, err[-2000:])


def test_abort_all_exits_single_process():
    """abort_all prints the reference FATAL banner and exits nonzero."""
    import pytest

    from aligntools_tpu.parallel import distributed as dist

    with pytest.raises(SystemExit) as ex:
        dist.abort_all(RuntimeError("boom"))
    assert ex.value.code == 1
