"""Test configuration.

Tests run on the CPU with 8 virtual devices, so the multi-device sharding
paths run without a GPU. Tests marked ``gpu`` need the card and skip
elsewhere; ``python chip_smoke.py`` runs them on the GPU, where it sets
ALIGNTOOLS_TEST_GPU=1 so this file leaves the platform alone.
"""

import os
import subprocess
import sys

if not os.environ.get("ALIGNTOOLS_TEST_GPU"):
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

# checkout of the reference C sources (src/, test/); the tests that need
# it skip when ALIGNTOOLS_REFERENCE is unset or points nowhere
REF_DIR = os.environ.get("ALIGNTOOLS_REFERENCE", "")
REF_TEST = os.path.join(REF_DIR, "test")


@pytest.fixture
def gpu():
    """The GPU device; skips the test when JAX has none."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run: python chip_smoke.py)")
    return devs[0]


@pytest.fixture(scope="session")
def ref_binary(tmp_path_factory):
    """Compile the reference C binary for differential testing (never vendored
    into this repo; built from the read-only reference checkout, Makefile:2)."""
    if not REF_DIR or not os.path.isdir(REF_DIR):
        pytest.skip("reference checkout not available")
    out = tmp_path_factory.mktemp("refbin") / "alignTools"
    src = [f"{REF_DIR}/src/main.c", f"{REF_DIR}/src/kstring.c"]
    cmd = ["cc", "-g", "-O2", *src, f"-I{REF_DIR}/src", "-lz", "-o", str(out)]
    subprocess.run(cmd, check=True, capture_output=True)
    return str(out)


@pytest.fixture(scope="session")
def fixtures():
    """The reference's own test FASTA files; skips when absent."""
    if not REF_DIR or not os.path.isdir(REF_TEST):
        pytest.skip("reference checkout not available")
    return {
        "global": f"{REF_TEST}/test_global.fa",
        "local": f"{REF_TEST}/test_local.fa",
        "edit": f"{REF_TEST}/test_edit.fa",
        "fit": f"{REF_TEST}/test_fit.fa",
        "tmp": f"{REF_TEST}/tmp.fa",
    }


def run_ref(binary, args):
    """Run the reference binary, return stdout lines (stderr dropped)."""
    r = subprocess.run(
        [binary, *args], capture_output=True, text=True, timeout=600
    )
    return r.stdout.splitlines(), r.returncode


@pytest.fixture(scope="session")
def ref_run(ref_binary):
    def _run(*args):
        return run_ref(ref_binary, list(args))

    return _run
