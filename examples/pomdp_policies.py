#!/usr/bin/env python
"""Compare the three POMDP remedies on an observation-noise env:

1. memoryless PPO on the raw noisy observation,
2. PPO on a k-step observation window (envs.ObsStackEnv),
3. recurrent PPO (GRU belief state, agents.ppo_rnn).

    python examples/pomdp_policies.py --sigma-m 0.15 --iterations 150
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="fishing-v1")
    ap.add_argument("--sigma", type=float, default=0.02)
    ap.add_argument("--sigma-m", type=float, default=0.15)
    ap.add_argument("--k", type=int, default=6, help="observation-window length")
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--reps", type=int, default=16)
    args = ap.parse_args()

    import gym_fishing_tpu as gft
    from gym_fishing_tpu import device

    device.setup_compile_cache()
    from gym_fishing_tpu.agents import RPPOConfig, RecurrentPPOPolicy, escapement, rppo_train
    from gym_fishing_tpu.agents.ppo import PPOConfig, PPOPolicy, train
    from gym_fishing_tpu.analysis import simulate_mdp
    from gym_fishing_tpu.envs import stack_observations

    env, params = gft.make(args.env, sigma=args.sigma, sigma_m=args.sigma_m)
    wenv = stack_observations(env, k=args.k)
    cfg = PPOConfig(num_envs=args.num_envs, num_steps=32, epochs=2, num_minibatches=4)
    # small entropy bonus keeps the GRU policy exploring long enough to find
    # the sustainable-harvest regime (deterministic collapse is its main
    # early-training failure mode)
    rcfg = RPPOConfig(num_envs=args.num_envs, num_steps=32, epochs=2,
                      num_minibatches=4, hidden=32, ent_coef=0.003)

    ts_raw, _ = train(env, cfg, iterations=args.iterations, env_params=params, seed=0)
    ts_stk, _ = train(wenv, cfg, iterations=args.iterations, env_params=params, seed=0)
    ts_rnn, _ = rppo_train(env, rcfg, iterations=args.iterations, env_params=params, seed=0)

    rows = [
        ("PPO raw obs", env, PPOPolicy(env, ts_raw)),
        (f"PPO {args.k}-step window", wenv, PPOPolicy(wenv, ts_stk)),
        ("recurrent PPO (GRU)", env, RecurrentPPOPolicy(env, ts_rnn, rcfg)),
        ("escapement (sees noisy obs)", env, escapement(env, params)),
    ]
    for name, e, pol in rows:
        df = simulate_mdp(e, pol, reps=args.reps, params=params)
        ret = df.groupby("rep").reward.sum()
        print(f"{name:30s} mean return {ret.mean():7.3f}  (sd {ret.std():.3f})")


if __name__ == "__main__":
    main()
