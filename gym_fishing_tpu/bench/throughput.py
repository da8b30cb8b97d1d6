"""Throughput of the stepping engine and of the PPO train step.

``measure``: batched env-steps/s of a jitted lax.scan rollout (escapement
policy + step + auto-reset on device). ``measure_ppo_train``: trained
env-steps/s of the default PPO iteration (rollout + GAE + minibatch SGD).
Each timed window chains every iteration on the previous one's outputs and
ends in ``block_until_ready``. The numbers are only as meaningful as the
device they ran on: ``bench.py`` asks for the GPU and names it in its output.
"""

from __future__ import annotations

import dataclasses
import time

import jax

import gym_fishing_tpu as gft
from gym_fishing_tpu.agents.policies import escapement
from gym_fishing_tpu.batch import batched_reset, batched_step
from gym_fishing_tpu.shard import shard_batch


def stepping_program(env, params, policy, num_steps: int,
                     store_trajectory: bool = False):
    """``run(state, key) -> (state, out)``: num_steps batched steps.

    Step t draws its noise from ``jax.random.split(key, num_steps)[t]``.
    ``store_trajectory=False``: ``out`` is the reward summed on device — pure
    stepping throughput, no [T, B] buffers. ``True``: ``out`` is the
    time-major trajectory of the same steps (``RolloutStep`` with actions),
    the learner-feeding variant.
    """

    def run(state, key):
        obs0 = jax.vmap(env.get_obs, in_axes=(None, 0))(params, state.env)

        def body(carry, k):
            st, obs = carry
            action = policy.act(obs)
            st, ts = batched_step(env, params, st, action, k, autoreset=True)
            out = (dataclasses.replace(ts, action=action) if store_trajectory
                   else ts.reward.sum())
            return (st, ts.obs), out

        keys = jax.random.split(key, num_steps)
        (state2, _), out = jax.lax.scan(body, (state, obs0), keys)
        return state2, (out if store_trajectory else out.sum())

    return run


def measure(
    env_id: str = "fishing-v1",
    num_envs: int = 1 << 20,
    num_steps: int = 64,
    iters: int = 10,
    warmup: int = 3,
    sigma: float = 0.05,
    mesh=None,
    store_trajectory: bool = False,
    rng_impl: str = "threefry2x32",
) -> dict:
    """Time the engine's rollout program; returns env-steps/s.

    ``rng_impl``: key implementation ("threefry2x32" | "rbg"). The engine is
    key-impl-agnostic (all draws flow from the caller's key); "rbg" lowers
    the per-step noise draw to XLA's RngBitGenerator.
    """
    env, params = gft.make(env_id, sigma=sigma)
    run = jax.jit(
        stepping_program(env, params, escapement(env, params), num_steps,
                         store_trajectory),
        donate_argnums=(0,),
    )

    state = batched_reset(env, params, num_envs)
    if mesh is not None:
        state = shard_batch(state, mesh)

    key = jax.random.key(0, impl=rng_impl)
    for _ in range(warmup):
        key, sub = jax.random.split(key)
        state, out = run(state, sub)
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    for _ in range(iters):
        key, sub = jax.random.split(key)
        state, out = run(state, sub)
    jax.block_until_ready((state, out))
    dt = time.perf_counter() - t0

    return {
        "env_id": env_id,
        "rng_impl": rng_impl,
        "num_envs": num_envs,
        "num_steps": num_steps,
        "iters": iters,
        "seconds": dt,
        "steps_per_s": num_envs * num_steps * iters / dt,
    }


def measure_ppo_train(
    num_envs: int = 16384,
    num_steps: int = 128,
    iters: int = 10,
    warmup: int = 3,
    sigma: float = 0.05,
    **cfg_overrides,
) -> dict:
    """Time the PPO train step (rollout + GAE + epochs of minibatch SGD).

    Every ``PPOConfig`` field not given in ``cfg_overrides`` keeps its
    default, so the result measures the configuration users get.
    """
    from functools import partial

    from gym_fishing_tpu.agents import ppo

    env, params = gft.make("fishing-v1", sigma=sigma)
    cfg = ppo.PPOConfig(num_envs=num_envs, num_steps=num_steps, **cfg_overrides)
    key = jax.random.key(0)
    ts = ppo.make_train_state(env, cfg, key)
    bstate = batched_reset(env, params, num_envs)
    step = jax.jit(partial(ppo.train_step, env, params, cfg))

    for i in range(warmup):
        ts, bstate, metrics = step(ts, bstate, jax.random.fold_in(key, i))
    jax.block_until_ready(metrics)

    t0 = time.perf_counter()
    for i in range(iters):
        ts, bstate, metrics = step(ts, bstate, jax.random.fold_in(key, 100 + i))
    jax.block_until_ready((ts, bstate, metrics))
    dt = time.perf_counter() - t0

    return {
        "compute_dtype": cfg.compute_dtype,
        "shuffle": cfg.shuffle,
        "num_envs": num_envs,
        "num_steps": num_steps,
        "epochs": cfg.epochs,
        "num_minibatches": cfg.num_minibatches,
        "iters": iters,
        "seconds": dt,
        "steps_per_s": num_envs * num_steps * iters / dt,
    }
