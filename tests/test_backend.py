"""The accelerator check and the compile-cache placement (backend.py).

Without a GPU the production surfaces raise with a clear message unless
the CPU was asked for explicitly; nothing degrades to the CPU on its own.
"""

import os
import subprocess
import sys

import jax
import pytest

import aligntools_tpu.backend as bk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS",
                        "JAX_COMPILATION_CACHE_DIR")}
    env.update(env_over)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)


@pytest.fixture
def platforms():
    """Set jax_platforms for one test; restored afterwards."""
    old = jax.config.jax_platforms
    yield lambda v: jax.config.update("jax_platforms", v)
    jax.config.update("jax_platforms", old)


def test_cpu_requested_reads_platform_config(platforms):
    platforms("cpu")
    assert bk.cpu_requested()
    platforms("cuda,cpu")
    assert not bk.cpu_requested()
    platforms(None)
    assert not bk.cpu_requested()


def test_require_device_explicit_cpu_passes():
    # the suite pins JAX_PLATFORMS=cpu (conftest): an explicit request
    assert bk.require_device() == "cpu"


def test_require_device_raises_without_gpu(platforms):
    """CPU backend reached by JAX's own fallback (no platform pinned):
    an error naming the way out, never a silent CPU run."""
    platforms(None)
    with pytest.raises(bk.NoDeviceError, match="JAX_PLATFORMS=cpu"):
        bk.require_device()


def test_require_device_raises_when_platform_missing(monkeypatch):
    def boom():
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(jax, "default_backend", boom)
    with pytest.raises(bk.NoDeviceError, match="cuda"):
        bk.require_device()


def test_on_gpu_false_on_cpu():
    assert bk.on_gpu() is False


def test_batch_cli_exits_nonzero_without_gpu(tmp_path):
    """`aligntools batch` on a host with no GPU and no explicit CPU
    request: non-zero exit and a clear message, no output rows."""
    fa = tmp_path / "p.fa"
    fa.write_text(">q\nACGT\n>t\nACGGT\n")
    code = (
        "import sys\n"
        "from aligntools_tpu.cli import main\n"
        f"sys.exit(main(['aligntools', 'batch', 'local', {str(fa)!r}]))\n"
    )
    r = _run(code)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert r.stdout == ""
    r = _run(code, JAX_PLATFORMS="cpu")  # explicit CPU: runs
    assert r.returncode == 0, r.stderr[-500:]
    assert r.stdout.startswith("q\tt\t")


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert bk.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert bk.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert bk.cache_dir() == bk.cache_dir()


def test_enable_compile_cache_sets_env_dir(tmp_path):
    """A fresh single-device CPU process: the cache lands exactly where
    JAX_COMPILATION_CACHE_DIR says."""
    code = (
        "import jax\n"
        "from aligntools_tpu.backend import enable_compile_cache\n"
        "enable_compile_cache()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    r = _run(code, JAX_PLATFORMS="cpu",
             JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"))
    assert r.returncode == 0, r.stderr[-500:]
    assert r.stdout.strip() == str(tmp_path / "c")
    assert (tmp_path / "c").is_dir()


def test_compile_cache_skipped_on_virtual_cpu_devices():
    """Several virtual CPU devices (this suite): no persistent cache, as
    executable serialization has aborted there on shard_map programs."""
    assert jax.device_count() > 1
    bk._cache_enabled = False
    bk.enable_compile_cache()
    assert bk._cache_enabled is False
