"""Bench-harness code-path tests (tiny shapes, CPU): the measure() machinery
must produce sane numbers and the trajectory-storing variant must work."""

import gym_fishing_tpu  # noqa: F401
from gym_fishing_tpu.bench.throughput import measure
from gym_fishing_tpu.bench.profiling import time_fn

import jax
import jax.numpy as jnp


def test_measure_xla_tiny():
    res = measure(num_envs=64, num_steps=8, iters=2, warmup=1)
    assert res["steps_per_s"] > 0
    assert res["steps_per_s"] == res["num_envs"] * res["num_steps"] * 2 / res["seconds"]
    assert "vs_baseline" not in res


def test_measure_store_trajectory():
    res = measure(num_envs=32, num_steps=8, iters=1, warmup=1, store_trajectory=True)
    assert res["steps_per_s"] > 0


def test_weak_scaling_functional_on_virtual_mesh():
    """weak_scaling runs on the 8-virtual-device mesh and returns a sane
    curve (functional check only: virtual devices share 2 physical cores, so
    efficiency here measures core contention, not interconnect)."""
    from gym_fishing_tpu.bench.scaling import weak_scaling

    res = weak_scaling(
        envs_per_device=64, num_steps=8, iters=2, device_counts=[1, 2, 4, 8]
    )
    assert set(res["throughput"]) == {1, 2, 4, 8}
    assert all(v > 0 for v in res["throughput"].values())
    assert res["efficiency"][1] == 1.0
    assert all(0 < e <= 1.5 for e in res["efficiency"].values())


def test_time_fn():
    f = jax.jit(lambda x: (x * 2).sum())
    out = time_fn(f, jnp.ones(128), iters=3, warmup=1)
    assert out["seconds_per_call"] > 0 and out["iters"] == 3


def test_measure_ppo_train_fast_tier_tiny():
    """The bfloat16 compute option reaches the timed PPO train step."""
    from gym_fishing_tpu.bench.throughput import measure_ppo_train

    res = measure_ppo_train(
        num_envs=64, num_steps=8, iters=1, warmup=1, compute_dtype="bfloat16",
    )
    assert res["steps_per_s"] > 0
    assert res["compute_dtype"] == "bfloat16"


def test_measure_ppo_train_inherits_chain_shortening_defaults():
    """measure_ppo_train takes no option of its own beyond sizes and timing:
    every other PPOConfig field keeps its default, so the bench measures the
    configuration users get."""
    import inspect

    from gym_fishing_tpu.agents.ppo import PPOConfig
    from gym_fishing_tpu.bench.throughput import measure_ppo_train

    sig = inspect.signature(measure_ppo_train)
    assert set(sig.parameters) == {
        "num_envs", "num_steps", "iters", "warmup", "sigma", "cfg_overrides",
    }
    res = measure_ppo_train(num_envs=32, num_steps=8, iters=1, warmup=1)
    cfg = PPOConfig()
    for k in ("compute_dtype", "shuffle", "epochs", "num_minibatches"):
        assert res[k] == getattr(cfg, k), k


def test_measure_rng_impl_rbg_tiny():
    res = measure(num_envs=64, num_steps=8, iters=2, warmup=1, rng_impl="rbg")
    assert res["steps_per_s"] > 0
    assert res["rng_impl"] == "rbg"


def test_bench_refuses_to_run_without_gpu(capsys):
    """bench.py fails on a machine without a GPU instead of reporting CPU
    numbers, and prints no result line."""
    import importlib.util
    import os

    import pytest

    from gym_fishing_tpu.device import DeviceUnavailable

    spec = importlib.util.spec_from_file_location(
        "bench_main",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py"),
    )
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    with pytest.raises(DeviceUnavailable):
        bench.main()
    assert capsys.readouterr().out == ""
