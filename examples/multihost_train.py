#!/usr/bin/env python
"""Multi-host SPMD PPO training.

Run ONE copy of this script per host (the standard jax.distributed launch:
give each process --coordinator, --num-processes and --process-id). Every
process executes the same program; env instances shard over all devices,
learner params replicate, and XLA inserts the collectives. Run without
--coordinator it uses the local devices of one host.

    python examples/multihost_train.py --num-envs-per-chip 4096
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs-per-chip", type=int, default=4096)
    ap.add_argument("--num-steps", type=int, default=128)
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (or set JAX_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args()

    import jax

    from gym_fishing_tpu.shard import distributed_init

    kw = {}
    if args.coordinator:
        kw = dict(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    distributed_init(**kw)

    from functools import partial

    import gym_fishing_tpu as gft
    from gym_fishing_tpu.agents.ppo import PPOConfig, make_train_state, train_step
    from gym_fishing_tpu.batch import batched_reset
    from gym_fishing_tpu.shard import host_local_to_global, make_mesh, replicate

    n_chips = jax.device_count()
    mesh = make_mesh()
    env, params = gft.make("fishing-v1", sigma=0.05)
    cfg = PPOConfig(
        num_envs=args.num_envs_per_chip * n_chips, num_steps=args.num_steps
    )
    key = jax.random.key(0)  # same key on every process: SPMD lockstep
    # params are host-identical -> replicate; the env batch is built as THIS
    # host's slice only and assembled into one global sharded array (never
    # device_put a host array onto non-addressable devices).
    ts = replicate(make_train_state(env, cfg, key), mesh)
    local_envs = args.num_envs_per_chip * jax.local_device_count()
    bstate = host_local_to_global(batched_reset(env, params, local_envs), mesh)
    step = jax.jit(partial(train_step, env, params, cfg))

    for it in range(args.iterations):
        ts, bstate, metrics = step(ts, bstate, jax.random.fold_in(key, it))
        if jax.process_index() == 0 and it % 10 == 0:
            print(
                f"iter {it}: ep_ret={float(metrics['episode_return']):.3f} "
                f"({n_chips} chips, {cfg.num_envs} envs)", flush=True,
            )


if __name__ == "__main__":
    main()
