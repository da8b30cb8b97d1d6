"""Closed-form baseline fisheries policies with the sb3 `.predict` contract.

Reference: gym_fishing/models/policies.py — `msy(env)` (constant fishing
mortality; harvest r*K/4 at equilibrium for logistic) and `escapement(env)`
(harvest everything above a fixed escapement stock) wrapped in objects whose
`.predict(obs, state=None, deterministic=True) -> (action, state)` duck-types
a stable-baselines3 model (reconstructed — SURVEY.md §2.1 Lx).

On-device twist: each policy is a *pure, jit/vmap-safe function* of the
observation (``policy.act``), generalized beyond logistic via a numeric
maximum-sustainable-yield computation on the growth curve; the object wrapper
only adds numpy I/O. For the 3-action relative decode the sb3 "recurrent
state" slot carries the policy's view of the current harvest, so `.predict`
stays Markov-correct without touching env internals.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams
from gym_fishing_tpu.dynamics.growth import get_growth_fn
from gym_fishing_tpu.spaces.scaling import encode_action, stock_from_obs


def surplus_production_msy(env: Env, params: EnvParams, n_grid: int = 4097):
    """(x*, msy): stock maximizing sustainable surplus growth(x) - x.

    For logistic growth this is exactly (K/2, r*K/4); computed numerically so
    every growth model gets a correct MSY/escapement policy.
    """
    growth = get_growth_fn(env.config.growth)
    xs = jnp.linspace(0.0, 2.0 * params.K, n_grid, dtype=params.dtype)
    surplus = growth(params, xs) - xs
    i = jnp.argmax(surplus)
    return xs[i], surplus[i]


class _PolicyBase:
    """Shared sb3-compatible wrapper around a pure quota rule."""

    def __init__(self, env: Env, params: Optional[EnvParams] = None):
        self.env = env
        self.params = params if params is not None else env.params()
        self.x_star, self.msy_harvest = surplus_production_msy(env, self.params)

    def quota(self, stock):
        raise NotImplementedError

    def act(self, obs, carried_harvest=None):
        """Pure, vmap/jit-safe: obs (..., 1) -> action."""
        p = self.params
        stock = stock_from_obs(p, obs)
        q = self.quota(stock)
        if carried_harvest is None:
            carried_harvest = jnp.broadcast_to(
                jnp.asarray(p.init_harvest, p.dtype), jnp.shape(q)
            )
        return encode_action(self.env.config, p, carried_harvest, q)

    def predict(
        self,
        obs,
        state: Any = None,
        episode_start=None,
        deterministic: bool = True,
    ) -> Tuple[np.ndarray, Any]:
        """sb3 contract. `state` carries the relative-scheme harvest."""
        del episode_start, deterministic
        obs = jnp.asarray(obs, self.params.dtype)
        carried = None if state is None else jnp.asarray(state, self.params.dtype)
        action = self.act(obs, carried)
        if self.env.config.scheme == "relative":
            from gym_fishing_tpu.spaces.scaling import decode_action

            base = (
                jnp.broadcast_to(
                    jnp.asarray(self.params.init_harvest, self.params.dtype),
                    jnp.shape(action),
                )
                if carried is None
                else carried
            )
            _, new_h = decode_action(self.env.config, self.params, base, action)
            return np.asarray(action), np.asarray(new_h)
        return np.asarray(action), None


class msy(_PolicyBase):
    """Constant-mortality MSY policy: quota = F * stock with F = msy / x*.

    At the logistic equilibrium this harvests r*K/4 per step with mortality
    F = r/2 (reference: gym_fishing/models/policies.py msy; reconstructed).
    """

    def quota(self, stock):
        F = self.msy_harvest / self.x_star
        return F * stock


class escapement(_PolicyBase):
    """Constant-escapement policy: quota = max(stock - x*, 0).

    x* = K/2 for logistic (reference escapement level; reconstructed), and the
    surplus-maximizing stock for the other growth models.
    """

    def quota(self, stock):
        return jnp.maximum(stock - self.x_star, 0.0)


class user_action:
    """Interactive policy: prompts for a quota (reference parity; TBV).

    Reference: gym_fishing/models/policies.py `user_action` (reconstructed).
    """

    def __init__(self, env: Env, params: Optional[EnvParams] = None):
        self.env = env
        self.params = params if params is not None else env.params()

    def predict(self, obs, state=None, **kw):
        q = float(input("Set harvest quota: "))
        stock = stock_from_obs(self.params, jnp.asarray(obs, self.params.dtype))
        carried = (
            jnp.asarray(state, self.params.dtype)
            if state is not None
            else jnp.broadcast_to(
                jnp.asarray(self.params.init_harvest, self.params.dtype),
                jnp.shape(stock),
            )
        )
        action = encode_action(
            self.env.config, self.params, carried, jnp.full_like(stock, q)
        )
        return np.asarray(action), state
