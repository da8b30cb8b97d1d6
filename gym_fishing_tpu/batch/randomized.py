"""Per-instance / per-episode parameter randomization (model uncertainty).

The reference hints at a model/parameter-uncertainty variant (SURVEY.md §2.1:
env sampling dynamics parameters per episode, TBV). The on-device
generalization: EnvParams is a pytree, so a *batched* params record (leaves
shaped [num_envs]) rides through vmap exactly like state — every instance can
run different (r, K, sigma, ...) and auto-reset resamples that instance's
parameters at episode boundaries, entirely in-graph. This is the standard
domain-randomization machinery for sim2real / robust-policy training, and
costs nothing extra on the VPU (the params were scalars in registers anyway).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp

from gym_fishing_tpu.batch.batch import BatchState, RolloutStep
from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams


def make_param_sampler(
    base: EnvParams, ranges: Dict[str, Tuple[float, float]]
) -> Callable[[jax.Array], EnvParams]:
    """sample(key) -> EnvParams with `ranges` fields drawn ~ U(lo, hi)."""
    names = sorted(ranges)

    def sample(key: jax.Array) -> EnvParams:
        keys = jax.random.split(key, len(names))
        draws = {}
        for name, k in zip(names, keys):
            lo, hi = ranges[name]
            if name in ("model_idx", "Tmax"):  # integer fields: U{lo..hi}
                draws[name] = jax.random.randint(k, (), int(lo), int(hi) + 1, jnp.int32)
            else:
                draws[name] = jax.random.uniform(k, (), base.dtype, lo, hi)
        return base.replace(**draws)

    return sample


def randomized_reset(
    env: Env,
    sample_fn: Callable[[jax.Array], EnvParams],
    num_envs: int,
    key: jax.Array,
) -> Tuple[BatchState, EnvParams]:
    """Batched initial state + per-instance sampled params (leaves [B])."""
    keys = jax.random.split(key, num_envs)
    bparams = jax.vmap(sample_fn)(keys)
    env_state = jax.vmap(env.reset)(bparams)
    dtype = env_state.stock.dtype
    state = BatchState(
        env=env_state,
        episode_return=jnp.zeros((num_envs,), dtype),
        episode_length=jnp.zeros((num_envs,), jnp.int32),
    )
    return state, bparams


def randomized_step(
    env: Env,
    sample_fn: Callable[[jax.Array], EnvParams],
    bparams: EnvParams,
    state: BatchState,
    actions,
    key: jax.Array,
) -> Tuple[BatchState, EnvParams, RolloutStep]:
    """One step with per-instance params; done instances get fresh params.

    Mirrors batch.batched_step(autoreset=True) with params vmapped alongside
    state and resampled (fold_in of step key x instance index) at episode
    boundaries.
    """
    num_envs = state.episode_return.shape[0]
    k_noise, k_resample = jax.random.split(key)
    noise = jax.random.normal(k_noise, (2, num_envs), bparams.dtype)
    env_state, ts = jax.vmap(env.step_xi)(bparams, state.env, actions, noise[0], noise[1])

    ep_ret = state.episode_return + ts.reward
    ep_len = state.episode_length + 1
    done = ts.done

    fresh_params = jax.vmap(sample_fn)(jax.random.split(k_resample, num_envs))
    fresh_state = jax.vmap(env.reset)(fresh_params)

    def sel(new, init):
        d = done.reshape(done.shape + (1,) * (jnp.ndim(new) - done.ndim))
        return jnp.where(d, init, new)

    env_state = jax.tree.map(sel, env_state, fresh_state)
    bparams = jax.tree.map(sel, bparams, fresh_params)
    obs = jax.vmap(env.get_obs)(bparams, env_state)
    new_state = BatchState(
        env=env_state,
        episode_return=jnp.where(done, 0.0, ep_ret).astype(ep_ret.dtype),
        episode_length=jnp.where(done, 0, ep_len),
    )
    out = RolloutStep(
        obs=obs, action=None, reward=ts.reward, done=done,
        collapsed=ts.collapsed, quota=ts.quota, harvest=ts.harvest,
        episode_return=ep_ret, episode_length=ep_len,
    )
    return new_state, bparams, out


def randomized_rollout(
    env: Env,
    sample_fn: Callable[[jax.Array], EnvParams],
    policy_fn: Callable,
    state: BatchState,
    bparams: EnvParams,
    key: jax.Array,
    num_steps: int,
) -> Tuple[BatchState, EnvParams, RolloutStep]:
    """lax.scan rollout with per-episode parameter resampling in-graph."""
    obs0 = jax.vmap(env.get_obs)(bparams, state.env)

    def body(carry, step_key):
        st, bp, obs = carry
        k_pi, k_env = jax.random.split(step_key)
        actions = policy_fn(obs, k_pi)
        st, bp, out = randomized_step(env, sample_fn, bp, st, actions, k_env)
        out = dataclasses.replace(out, action=actions)
        return (st, bp, out.obs), out

    keys = jax.random.split(key, num_steps)
    (state, bparams, _), traj = jax.lax.scan(body, (state, bparams, obs0), keys)
    return state, bparams, traj
