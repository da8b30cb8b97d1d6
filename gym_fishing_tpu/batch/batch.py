"""Batched env engine: vmap step, in-graph auto-reset, lax.scan rollout.

This is the instance-batch parallelism layer of SURVEY.md §2.4 — the env
analog of data parallelism. The reference steps one env per Python call
(reference: gym_fishing/envs/base_fishing_env.py step; reconstructed); here a
leading ``[num_envs]`` axis on the state pytree turns the scalar MDP into one
fused XLA kernel per step, and ``lax.scan`` over time keeps the whole rollout
on-device with zero host round-trips (BASELINE.json north star).

RNG: one fused draw per step — ``jax.random.normal(key, (2, B))`` — instead of
B per-instance splits; this is the counter-based, order-independent scheme of
BASELINE.json and is exactly equivalent to feeding each instance an injected
xi/eta pair (the exactness tests rely on that equivalence).

Auto-reset (new component, no reference counterpart — SURVEY.md §3.3): when an
instance reports done, its state is where-selected back to the initial state
*in the same step*, and the episode return/length are surfaced in that step's
outputs, gym-autoreset style.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp

from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams, EnvState, TimeStep


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatchState:
    """Batched env state + per-instance episode accumulators."""

    env: EnvState            # leaves have leading [num_envs]
    episode_return: Any      # running undiscounted return
    episode_length: Any      # running episode length (int32)

    def replace(self, **kw) -> "BatchState":
        return dataclasses.replace(self, **kw)


def batched_reset(env: Env, params: EnvParams, num_envs: int) -> BatchState:
    """All-instances initial state (broadcast of the scalar reset)."""
    single = env.reset(params)
    env_state = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (num_envs,) + jnp.shape(x)), single
    )
    dtype = params.dtype
    return BatchState(
        env=env_state,
        episode_return=jnp.zeros((num_envs,), dtype),
        episode_length=jnp.zeros((num_envs,), jnp.int32),
    )


def batched_step_xi(
    env: Env, params: EnvParams, state: EnvState, actions, xi, eta
) -> Tuple[EnvState, TimeStep]:
    """vmap of the injected-noise step over the instance axis."""
    return jax.vmap(env.step_xi, in_axes=(None, 0, 0, 0, 0))(
        params, state, actions, xi, eta
    )


def batched_step(
    env: Env,
    params: EnvParams,
    state: BatchState,
    actions,
    key: jax.Array,
    autoreset: bool = True,
) -> Tuple[BatchState, TimeStep]:
    """One batched step with optional in-graph auto-reset.

    Returns the next BatchState and a TimeStep whose leaves carry the
    per-instance results of this step. When ``autoreset`` and an instance is
    done, its next state/obs are the post-reset ones while reward/done/episode
    stats describe the finished episode step.
    """
    num_envs = state.episode_return.shape[0]
    dtype = params.dtype
    noise = jax.random.normal(key, (2, num_envs), dtype)
    env_state, ts = batched_step_xi(env, params, state.env, actions, noise[0], noise[1])

    ep_ret = state.episode_return + ts.reward
    ep_len = state.episode_length + 1

    if autoreset:
        reset_state = batched_reset(env, params, num_envs)
        done = ts.done

        def sel(new, init):
            d = done.reshape(done.shape + (1,) * (new.ndim - done.ndim))
            return jnp.where(d, init, new)

        env_state = jax.tree.map(sel, env_state, reset_state.env)
        # Done instances observe the (noise-free) reset state; everyone else
        # keeps the step's own obs so measurement noise (sigma_m) reaches the
        # policy — re-deriving obs for all envs via get_obs would silently
        # strip the obs-noise variants' noise from training.
        reset_obs = jax.vmap(env.get_obs, in_axes=(None, 0))(
            params, reset_state.env
        )
        d = done.reshape(done.shape + (1,) * (ts.obs.ndim - done.ndim))
        ts = ts.replace(obs=jnp.where(d, reset_obs, ts.obs))
        next_ret = jnp.where(done, 0.0, ep_ret).astype(dtype)
        next_len = jnp.where(done, 0, ep_len)
    else:
        next_ret, next_len = ep_ret, ep_len

    new_state = BatchState(env=env_state, episode_return=next_ret, episode_length=next_len)
    # Surface the (completed-or-running) episode stats of *this* step.
    ts_out = _rollout_step(ts, ep_ret, ep_len)
    return new_state, ts_out


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RolloutStep:
    """One scan slice of a rollout trajectory."""

    obs: Any
    action: Any
    reward: Any
    done: Any
    collapsed: Any  # done split: collapse (terminated) vs horizon (truncated)
    quota: Any
    harvest: Any
    episode_return: Any
    episode_length: Any


def _rollout_step(ts: TimeStep, ep_ret, ep_len):
    return RolloutStep(
        obs=ts.obs,
        action=None,
        reward=ts.reward,
        done=ts.done,
        collapsed=ts.collapsed,
        quota=ts.quota,
        harvest=ts.harvest,
        episode_return=ep_ret,
        episode_length=ep_len,
    )


def rollout(
    env: Env,
    params: EnvParams,
    policy_fn: Callable[[Any, jax.Array], Any],
    state: BatchState,
    key: jax.Array,
    num_steps: int,
    autoreset: bool = True,
) -> Tuple[BatchState, RolloutStep]:
    """On-device rollout: lax.scan of (policy -> batched step) over time.

    ``policy_fn(obs, key) -> actions`` runs *inside* the scan — no host
    round-trips (BASELINE.json). Returns final state and a time-major
    trajectory pytree with leaves shaped [num_steps, num_envs, ...].
    """
    obs0 = jax.vmap(env.get_obs, in_axes=(None, 0))(params, state.env)

    def body(carry, step_key):
        st, obs = carry
        k_pi, k_env = jax.random.split(step_key)
        actions = policy_fn(obs, k_pi)
        st, ts = batched_step(env, params, st, actions, k_env, autoreset=autoreset)
        ts = dataclasses.replace(ts, action=actions)
        return (st, ts.obs), ts

    keys = jax.random.split(key, num_steps)
    (state, _), traj = jax.lax.scan(body, (state, obs0), keys)
    return state, traj
