"""The functional environment: pure `step` / `reset` over explicit pytrees.

This replaces the reference's stateful `gym.Env.step/reset` (reference:
gym_fishing/envs/base_fishing_env.py — step, reset, harvest_draw,
population_draw; reconstructed, ORACLE_SEMANTICS.md pins the semantics) with
the on-device protocol demanded by BASELINE.json:

    step(params, state, action, key) -> (state', TimeStep)

Three entry points, layered:

- ``step_xi(params, state, action, xi, eta)`` — noise-injected, fully
  deterministic. The exactness harness drives this and the NumPy oracle with
  the same N(0,1) stream (SURVEY.md §7.4).
- ``step(params, state, action, key)`` — draws (xi, eta) from a JAX key;
  counter-based, per-instance RNG per BASELINE.json.
- batched variants live in ``gym_fishing_tpu.batch`` (vmap + a single fused
  normal draw per step across the whole batch).

Everything here is branch-free elementwise math: under jit+vmap the whole
step fuses into one XLA kernel (the "moral native component" of SURVEY.md
§2.2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gym_fishing_tpu.core.types import EnvConfig, EnvParams, EnvState, TimeStep
from gym_fishing_tpu.dynamics.growth import get_growth_fn
from gym_fishing_tpu.dynamics.noise import apply_process_noise
from gym_fishing_tpu.spaces.scaling import (
    decode_action,
    encode_action,
    obs_from_stock,
    stock_from_obs,
)
from gym_fishing_tpu.spaces.spaces import Box, Discrete


@dataclasses.dataclass(frozen=True)
class Env:
    """An assembled environment: static config + default params + pure fns.

    Instances are lightweight, hashable-config records; all the actual
    behavior is in the pure functions below, which close over only the static
    ``EnvConfig`` (so jit caches per config, not per instance).
    """

    id: str
    config: EnvConfig
    default_params: EnvParams

    # ------------------------------------------------------------------ spaces
    @property
    def action_space(self):
        if self.config.scheme == "continuous":
            return Box(-1.0, 1.0, (1,))
        return Discrete(self.config.n_actions)

    @property
    def observation_space(self):
        return Box(-1.0, 1.0, (1,))

    # ------------------------------------------------------------------- core
    def reset(self, params: EnvParams, key: Optional[jax.Array] = None) -> EnvState:
        """Initial state. `key` accepted for API symmetry (no reset noise —
        pinned, ORACLE_SEMANTICS.md)."""
        del key
        dtype = params.dtype
        return EnvState(
            stock=jnp.asarray(params.init_state, dtype),
            harvest=jnp.asarray(params.init_harvest, dtype),
            t=jnp.asarray(0, jnp.int32),
        )

    def step_xi(
        self,
        params: EnvParams,
        state: EnvState,
        action,
        xi,
        eta=None,
    ) -> Tuple[EnvState, TimeStep]:
        """Deterministic step given injected N(0,1) draws (xi, eta).

        Step order per ORACLE_SEMANTICS.md: decode -> harvest -> growth ->
        noise -> clip -> reward -> done -> observe.
        """
        cfg = self.config
        dtype = params.dtype
        x = state.stock
        xi = jnp.asarray(xi, dtype)
        eta = jnp.zeros((), dtype) if eta is None else jnp.asarray(eta, dtype)

        quota, new_h = decode_action(cfg, params, state.harvest, action)
        hv = jnp.minimum(x, quota)
        x1 = x - hv
        # non-stationary drift: effective r at step t (identity when drift=0)
        p_g = params.replace(r=params.r + params.r_drift * state.t.astype(dtype))
        mu = get_growth_fn(cfg.growth)(p_g, x1)
        x2 = apply_process_noise(cfg.noise_form, params, mu, x1, xi)
        x_next = jnp.maximum(x2, jnp.zeros((), dtype))

        collapsed = x_next <= 0.0
        reward = (
            params.price * hv
            - params.cost * quota * quota
            - jnp.where(collapsed, params.collapse_penalty, jnp.zeros((), dtype))
        )
        t_next = state.t + 1
        done = (t_next >= params.Tmax) | collapsed

        if cfg.scheme != "relative":
            new_h = hv
        new_state = EnvState(stock=x_next, harvest=new_h, t=t_next)

        measured = x_next * jnp.exp(params.sigma_m * eta)
        obs = obs_from_stock(params, measured)
        ts = TimeStep(
            obs=obs, reward=reward, done=done, quota=quota, harvest=hv,
            collapsed=collapsed,
        )
        return new_state, ts

    def step(
        self,
        params: EnvParams,
        state: EnvState,
        action,
        key: jax.Array,
    ) -> Tuple[EnvState, TimeStep]:
        """Seeded step: one key per instance per step (counter-based RNG)."""
        dtype = params.dtype
        k_xi, k_eta = jax.random.split(key)
        xi = jax.random.normal(k_xi, (), dtype)
        eta = jax.random.normal(k_eta, (), dtype)
        return self.step_xi(params, state, action, xi, eta)

    # ------------------------------------------------------------- utilities
    def get_obs(self, params: EnvParams, state: EnvState):
        """Noise-free observation of the current state (reference `get_obs`)."""
        return obs_from_stock(params, state.stock)

    def get_fish_population(self, params: EnvParams, obs):
        return stock_from_obs(params, obs)

    def get_quota(self, params: EnvParams, state: EnvState, action):
        quota, _ = decode_action(self.config, params, state.harvest, action)
        return quota

    def get_action(self, params: EnvParams, state: EnvState, quota):
        """Inverse decode (reference `get_action`): desired quota -> action."""
        return encode_action(self.config, params, state.harvest, jnp.asarray(quota))

    def params(self, dtype=jnp.float32, **overrides) -> EnvParams:
        """Default params cast to `dtype`, with keyword overrides applied."""
        p = self.default_params.replace(**overrides) if overrides else self.default_params
        return p.astype(dtype)


def make_env(
    env_id: str,
    growth: str = "logistic",
    noise_form: str = "additive",
    scheme: str = "continuous",
    n_actions: int = 3,
    **param_overrides,
) -> Env:
    """Assemble an Env from static choices + parameter overrides."""
    cfg = EnvConfig(
        growth=growth, noise_form=noise_form, scheme=scheme, n_actions=n_actions
    )
    params = EnvParams().replace(**param_overrides) if param_overrides else EnvParams()
    return Env(id=env_id, config=cfg, default_params=params)
