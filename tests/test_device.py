"""The device module: it hands out the platform asked for or refuses, reports
what it hands out, and places the compile cache (``$JAX_COMPILATION_CACHE_DIR``
when set, else one fixed directory inside the checkout)."""

import os
import subprocess
import sys

import jax
import pytest

from gym_fishing_tpu import device


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_require_refuses_gpu_on_cpu_only_backend():
    with pytest.raises(device.DeviceUnavailable, match="'gpu'"):
        device.require("gpu")


def test_require_refuses_too_few_devices():
    n = len(jax.devices("cpu"))
    with pytest.raises(device.DeviceUnavailable, match=f"found {n}"):
        device.require("cpu", n + 1)


def test_require_returns_exactly_the_platform_asked_for():
    devs = device.require("cpu", 3)
    assert len(devs) == 3 and all(d.platform == "cpu" for d in devs)
    assert devs == jax.devices("cpu")[:3]


def test_describe_reports_platform_kind_and_count():
    devs = jax.devices("cpu")[:2]
    info = device.describe(devs)
    assert info == {"platform": "cpu", "kind": devs[0].device_kind, "count": 2}


def test_describe_refuses_an_empty_device_list():
    with pytest.raises(device.DeviceUnavailable):
        device.describe([])


def test_gpu_name_and_power_limit_fails_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(OSError):
        device.gpu_name_and_power_limit()


def test_device_unavailable_is_a_runtime_error():
    # callers that catch RuntimeError from jax.devices keep working
    assert issubclass(device.DeviceUnavailable, RuntimeError)


def test_cache_dir_follows_env_var(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert device.compile_cache_dir() == str(tmp_path / "c")
    assert device.setup_compile_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")


def test_cache_dir_defaults_to_fixed_in_checkout_path(monkeypatch,
                                                      restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.setup_compile_cache()
    assert path == str(device.DEFAULT_CACHE_DIR)
    assert jax.config.jax_compilation_cache_dir == path
    assert device.DEFAULT_CACHE_DIR.parent == device.REPO_ROOT
    assert (device.REPO_ROOT / "gym_fishing_tpu" / "device.py").exists()


def test_default_cache_dir_is_the_same_in_every_process(monkeypatch):
    """No pid, time or temporary name: a second process gets the same path."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    code = "from gym_fishing_tpu import device; print(device.compile_cache_dir())"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(device.REPO_ROOT),
                         check=True).stdout.strip()
    assert out == device.compile_cache_dir() == str(device.DEFAULT_CACHE_DIR)


def test_default_cache_dir_is_git_ignored():
    lines = (device.REPO_ROOT / ".gitignore").read_text().splitlines()
    rel = device.DEFAULT_CACHE_DIR.relative_to(device.REPO_ROOT).as_posix()
    assert f"{rel}/" in lines or rel in lines or f"/{rel}/" in lines


def test_empty_env_var_falls_back_to_default(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert device.compile_cache_dir() == str(device.DEFAULT_CACHE_DIR)
