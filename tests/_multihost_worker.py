"""Worker process for the true multi-process SPMD test (not a pytest module).

Launched N times by tests/test_multihost.py, each as a SEPARATE OS process:

    python tests/_multihost_worker.py <process_id> <num_processes> <port> \
        [local_devices=2]

Each process owns `local_devices` virtual CPU devices; `jax.distributed.initialize` wires
them into one 2N-device SPMD program with gloo CPU collectives (the CPU
stand-in for the GPU's collectives — SURVEY.md §2.4 multi-host row).
It then runs the real multi-host recipe from examples/multihost_train.py —
replicated learner params, per-host env slice assembled via
`host_local_to_global` — for two PPO train steps and prints one JSON line of
results; the test asserts every process (and a single-process reference run
on the same global mesh size) agrees.
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_local_devices = sys.argv[4] if len(sys.argv) > 4 else "2"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={_local_devices}"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")


def main() -> None:
    process_id, num_processes, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    from gym_fishing_tpu.shard import distributed_init

    if num_processes > 1:
        distributed_init(
            coordinator_address=f"localhost:{port}",
            num_processes=num_processes,
            process_id=process_id,
        )

    from functools import partial

    import gym_fishing_tpu as gft
    from gym_fishing_tpu.agents.ppo import PPOConfig, make_train_state, train_step
    from gym_fishing_tpu.batch import batched_reset
    from gym_fishing_tpu.shard import (
        host_local_to_global,
        make_mesh,
        replicate,
        state_checksum,
    )

    mesh = make_mesh()
    env, params = gft.make("fishing-v1", sigma=0.05)
    global_envs = 16
    cfg = PPOConfig(
        num_envs=global_envs, num_steps=8, epochs=2, num_minibatches=2, hidden=16
    )
    key = jax.random.key(0)  # same key everywhere: SPMD lockstep
    ts = replicate(make_train_state(env, cfg, key), mesh)
    local_envs = global_envs // jax.process_count()
    bstate = host_local_to_global(batched_reset(env, params, local_envs), mesh)
    step = jax.jit(partial(train_step, env, params, cfg))

    for it in range(2):
        ts, bstate, metrics = step(ts, bstate, jax.random.fold_in(key, it))

    out = {
        "process_id": process_id,
        "num_processes": jax.process_count(),
        "num_devices": jax.device_count(),
        "params_checksum": float(state_checksum(ts.params)),
        "state_checksum": float(state_checksum(bstate.env)),
        "mean_reward": float(metrics["mean_reward"]),
        "loss": float(metrics["loss"]),
    }

    # The same global batch on one device of this process: the sharded
    # iterations above must reproduce it (env state bitwise, params within
    # the all-reduce reordering tolerance).
    if jax.process_count() == 1:
        dev = jax.devices()[0]
        with jax.default_device(dev):
            ts1 = make_train_state(env, cfg, key)
            b1 = batched_reset(env, params, global_envs)
            for it in range(2):
                ts1, b1, m1 = step(ts1, b1, jax.random.fold_in(key, it))
        out["single_device_params_checksum"] = float(state_checksum(ts1.params))
        out["single_device_state_checksum"] = float(state_checksum(b1.env))
        out["single_device_loss"] = float(m1["loss"])

    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
