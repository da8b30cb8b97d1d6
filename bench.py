#!/usr/bin/env python
"""Engine stepping and PPO training throughput on one GPU, as one JSON line.

    python bench.py

Prints ``{"metric", "value", "unit", "device", "gpu", "config", "ppo",
"git_sha"}``: ``value`` is the engine's env-steps/s (fishing-v1, escapement
policy, B=2^21, T=512 by default), ``ppo`` the default PPO iteration's
trained env-steps/s (16,384 envs x 128 steps). ``device`` is the platform,
device kind and count as JAX reports them; ``gpu`` is nvidia-smi's name and
power limit. Without a GPU the script fails: it never reports CPU numbers.

Options (env vars): BENCH_NUM_ENVS, BENCH_NUM_STEPS, BENCH_ITERS, BENCH_ENV,
BENCH_RNG (threefry2x32 | rbg), BENCH_SKIP_PPO=1, BENCH_PPO_NUM_ENVS,
BENCH_PPO_NUM_STEPS, BENCH_PPO_ITERS.
"""

import json
import os
import subprocess


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "-C", os.path.dirname(os.path.abspath(__file__)),
             "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except OSError:
        return "unknown"


def main() -> None:
    from gym_fishing_tpu import device

    info = device.describe(device.require("gpu"))
    device.setup_compile_cache()
    gpu = device.gpu_name_and_power_limit()

    from gym_fishing_tpu.bench.throughput import measure, measure_ppo_train

    env_id = os.environ.get("BENCH_ENV", "fishing-v1")
    res = measure(
        env_id=env_id,
        num_envs=int(os.environ.get("BENCH_NUM_ENVS", 1 << 21)),
        num_steps=int(os.environ.get("BENCH_NUM_STEPS", 512)),
        iters=int(os.environ.get("BENCH_ITERS", 5)),
        rng_impl=os.environ.get("BENCH_RNG", "threefry2x32"),
    )
    line = {
        "metric": f"env-steps/s ({env_id} batched, escapement policy)",
        "value": res["steps_per_s"],
        "unit": "steps/s",
        "device": info,
        "gpu": gpu,
        "config": {k: res[k] for k in ("num_envs", "num_steps", "iters",
                                       "rng_impl")},
    }
    if os.environ.get("BENCH_SKIP_PPO") != "1":
        line["ppo"] = measure_ppo_train(
            num_envs=int(os.environ.get("BENCH_PPO_NUM_ENVS", 16384)),
            num_steps=int(os.environ.get("BENCH_PPO_NUM_STEPS", 128)),
            iters=int(os.environ.get("BENCH_PPO_ITERS", 10)),
        )
    line["git_sha"] = _git_sha()
    print(json.dumps(line))


if __name__ == "__main__":
    main()
