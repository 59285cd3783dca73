"""Process set-up of the entry points (greb_tpu/runtime.py): the persistent
compilation cache location and the GPU device check."""
import os

import jax
import pytest

from greb_tpu import runtime


@pytest.fixture
def cache_config():
    """Restore JAX's cache directory after a test changes it."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, cache_config, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_checkout_path(monkeypatch,
                                                      cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert runtime.CACHE_DIR == want
    assert runtime.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu(jax.devices("cpu"))


def check_require_gpu_on_card():
    dev = runtime.require_gpu()
    assert dev.platform == "gpu"
    assert runtime.gpu_name_and_power_limit()


@pytest.mark.gpu
def test_require_gpu_on_card():
    check_require_gpu_on_card()
