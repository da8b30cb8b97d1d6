"""Functional environment wrappers.

``ObsStackEnv`` stacks the last k (possibly noise-corrupted) observations
into one window so memoryless policies can act on the POMDP variants — the
observation-noise envs (``sigma_m > 0``), the growth-model-uncertainty
mixture, and the non-stationary drift env are all partially observed, and a
k-step window is the standard non-recurrent remedy. The reference has no
such wrapper (its sb3 users reached for external `VecFrameStack`;
reconstructed); here it is a first-class functional env so it composes with
the whole JAX stack: the wrapper implements the same pure protocol as
``core.env.Env`` (`reset` / `step` / `step_xi` / `get_obs`), so vmap
batching, auto-reset, `lax.scan` rollouts, mesh sharding and every learner
work on it unchanged.

State is a pytree ``StackedState(env, window)`` — the window rides through
jit like any other leaf; no host-side ring buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams, TimeStep
from gym_fishing_tpu.spaces.spaces import Box


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StackedState:
    """Inner env state + rolling observation window (most recent last)."""

    env: Any     # inner EnvState
    window: Any  # (..., k) observations

    def replace(self, **kw) -> "StackedState":
        return dataclasses.replace(self, **kw)

    # expose the inner leaves the learners read (e.g. DQN's carried harvest)
    @property
    def harvest(self):
        return self.env.harvest

    @property
    def stock(self):
        return self.env.stock

    @property
    def t(self):
        return self.env.t


@dataclasses.dataclass(frozen=True)
class ObsStackEnv:
    """k-step observation window over an inner functional env."""

    inner: Env
    k: int = 4

    def __post_init__(self) -> None:
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.inner.observation_space.shape != (1,):
            raise ValueError("ObsStackEnv expects a scalar-observation inner env")

    # ----------------------------------------------------------------- labels
    @property
    def id(self) -> str:
        return f"{self.inner.id}-stack{self.k}"

    @property
    def config(self):
        return self.inner.config

    @property
    def default_params(self) -> EnvParams:
        return self.inner.default_params

    def params(self, *args, **kwargs) -> EnvParams:
        return self.inner.params(*args, **kwargs)

    # ----------------------------------------------------------------- spaces
    @property
    def action_space(self):
        return self.inner.action_space

    @property
    def observation_space(self):
        return Box(-1.0, 1.0, (self.k,))

    # ------------------------------------------------------------------- core
    def reset(self, params: EnvParams, key: Optional[jax.Array] = None) -> StackedState:
        s = self.inner.reset(params, key)
        obs0 = self.inner.get_obs(params, s)[..., 0]
        return StackedState(env=s, window=jnp.broadcast_to(obs0, obs0.shape + (self.k,)))

    def _push(self, window, obs):
        return jnp.concatenate([window[..., 1:], obs], axis=-1)

    def step_xi(self, params, state: StackedState, action, xi, eta=None
                ) -> Tuple[StackedState, TimeStep]:
        s, ts = self.inner.step_xi(params, state.env, action, xi, eta)
        window = self._push(state.window, ts.obs)
        return StackedState(env=s, window=window), ts.replace(obs=window)

    def step(self, params, state: StackedState, action, key: jax.Array
             ) -> Tuple[StackedState, TimeStep]:
        s, ts = self.inner.step(params, state.env, action, key)
        window = self._push(state.window, ts.obs)
        return StackedState(env=s, window=window), ts.replace(obs=window)

    # ------------------------------------------------------------- utilities
    def get_obs(self, params: EnvParams, state: StackedState):
        return state.window

    def get_fish_population(self, params: EnvParams, obs):
        # latest window entry is the current (measured) observation
        return self.inner.get_fish_population(params, obs[..., -1:])

    def get_quota(self, params: EnvParams, state: StackedState, action):
        return self.inner.get_quota(params, state.env, action)

    def get_action(self, params: EnvParams, state: StackedState, quota):
        return self.inner.get_action(params, state.env, quota)


def stack_observations(env: Env, k: int = 4) -> ObsStackEnv:
    """Wrap `env` with a k-step observation window (POMDP remedy)."""
    return ObsStackEnv(inner=env, k=k)
