"""The multi-device dry run starts from a fresh process with no XLA_FLAGS:
it must create its own virtual CPU devices before any backend starts."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_fresh_process_without_xla_flags():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(4)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dryrun_multichip OK: 4-device cpu mesh" in r.stdout
    assert "2x2 mesh" in r.stdout
