"""Run-time setup of the entry points: the compile-cache rule, the GPU
check that refuses the CPU, and chip_smoke.py's use of it."""
import importlib.util
import os

import jax
import pytest

from ofdm_lte_tpu.utils import device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache setting after the test."""
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_cache_dir_from_environment_is_left_to_jax(monkeypatch, tmp_path,
                                                   cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_dir_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        device.require_gpu()


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_device_check_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        _load_chip_smoke().check_device()


def test_chip_smoke_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit):
        _load_chip_smoke().main([])
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_binomial_bound():
    bound = _load_chip_smoke().binomial_bound
    assert bound(0.0, 1000) == 0.0
    assert bound(0.01, 10_000) == pytest.approx(
        3 * (2 * 0.01 * 0.99 / 10_000) ** 0.5)
    assert bound(0.01, 40_000) == pytest.approx(bound(0.01, 10_000) / 2)


@pytest.mark.gpu
def test_gpu_power_limit_readable(gpu):
    name_and_limit = device.gpu_name_and_power_limit()
    assert "," in name_and_limit and "W" in name_and_limit
