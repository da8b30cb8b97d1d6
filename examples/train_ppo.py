#!/usr/bin/env python
"""Train PPO (or A2C) on fishing-v1 and compare against the closed-form
baselines.

Reference-parity workflow (reference: README sb3 usage; reconstructed):

    python examples/train_ppo.py --env fishing-v1 --timesteps 4000000
    python examples/train_ppo.py --algo a2c --timesteps 8000000

Produces ppo_fishing/{sim.csv, mdp.png, policy.png} + a learning-curve plot,
and prints the trained return vs the MSY / constant-escapement baselines.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="fishing-v1")
    ap.add_argument("--algo", choices=["ppo", "a2c"], default="ppo")
    ap.add_argument("--timesteps", type=int, default=2_000_000)
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--num-steps", type=int, default=128)
    ap.add_argument("--sigma", type=float, default=0.05)
    ap.add_argument("--out", default="ppo_fishing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--shuffle", choices=["exact", "affine"], default="exact",
        help="PPO only: epoch shuffle of the minibatch update",
    )
    args = ap.parse_args()

    import gym_fishing_tpu as gft
    from gym_fishing_tpu import device

    device.setup_compile_cache()
    from gym_fishing_tpu.agents import A2C, PPO, escapement, msy
    from gym_fishing_tpu.analysis import (
        estimate_policyfn,
        plot_mdp,
        plot_policyfn,
        simulate_mdp,
        write_csv,
    )

    env, params = gft.make(args.env, sigma=args.sigma)
    algo_cls = {"ppo": PPO, "a2c": A2C}[args.algo]
    extra = {"shuffle": args.shuffle} if args.algo == "ppo" else {}
    model = algo_cls(
        "MlpPolicy",
        (env, params),
        num_envs=args.num_envs,
        num_steps=args.num_steps,
        seed=args.seed,
        verbose=1,
        **extra,
    )
    model.learn(total_timesteps=args.timesteps)

    os.makedirs(args.out, exist_ok=True)
    model.save(os.path.join(args.out, "ckpt"))

    df = simulate_mdp(env, model.policy, reps=10, params=params)
    write_csv(df, os.path.join(args.out, "sim.csv"))
    plot_mdp(df, os.path.join(args.out, "mdp.png"))
    dfp = estimate_policyfn(env, model.policy, reps=1, n=100, params=params)
    plot_policyfn(dfp, os.path.join(args.out, "policy.png"))

    trained_ret = df.groupby("rep").reward.sum().mean()
    msy_ret = (
        simulate_mdp(env, msy(env, params), reps=10, params=params)
        .groupby("rep").reward.sum().mean()
    )
    esc_ret = (
        simulate_mdp(env, escapement(env, params), reps=10, params=params)
        .groupby("rep").reward.sum().mean()
    )
    print(f"mean episode return: {args.algo}={trained_ret:.3f}  "
          f"msy={msy_ret:.3f}  escapement={esc_ret:.3f}")


if __name__ == "__main__":
    main()
