#!/usr/bin/env python
"""Train a robust policy under structural + parameter uncertainty.

Demonstrates the model-uncertainty machinery: every env instance runs a
different growth model (params.model_idx into the six-model family) and its
own (r, K, sigma), all resampled per episode in-graph — the on-device form
of the reference's model-uncertainty variant (SURVEY.md §2.1).

    python examples/model_uncertainty.py --steps 200
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=2048)
    ap.add_argument("--horizon", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()

    import jax
    import numpy as np

    import gym_fishing_tpu as gft
    from gym_fishing_tpu import device

    device.setup_compile_cache()
    from gym_fishing_tpu.agents import escapement
    from gym_fishing_tpu.batch import (
        make_param_sampler,
        randomized_reset,
        randomized_rollout,
    )
    from gym_fishing_tpu.core.types import GROWTH_MODELS

    env, params = gft.make("fishing-mixture-v1")
    sampler = make_param_sampler(
        params,
        {
            "model_idx": (0, len(GROWTH_MODELS) - 1),
            "r": (0.2, 1.0),
            "K": (0.7, 1.3),
            "sigma": (0.0, 0.1),
        },
    )
    key = jax.random.key(0)
    state, bparams = randomized_reset(env, sampler, args.num_envs, key)

    # evaluate the constant-escapement baseline under full uncertainty
    pol = escapement(env, params)
    policy = lambda obs, k: pol.act(obs)
    run = jax.jit(
        lambda s, bp, k: randomized_rollout(
            env, sampler, policy, s, bp, k, args.horizon
        )
    )
    total_r = 0.0
    for i in range(args.steps):
        key, sub = jax.random.split(key)
        state, bparams, traj = run(state, bparams, sub)
        total_r += float(np.asarray(traj.reward).sum())
    n = args.num_envs * args.horizon * args.steps
    models = np.bincount(np.asarray(bparams.model_idx), minlength=len(GROWTH_MODELS))
    print(f"steps: {n:,}  mean reward/step: {total_r / n:.4f}")
    print("active growth models:", dict(zip(GROWTH_MODELS, models.tolist())))


if __name__ == "__main__":
    main()
