"""Gymnasium-native env + registration (reference `gym.make` parity).

The reference registers its envs with OpenAI gym so users write
`gym.make("fishing-v1")` (reference: gym_fishing/__init__.py; reconstructed).
This module provides the modern equivalent: a `gymnasium.Env` subclass over
the JAX engine with the terminated/truncated split (terminated = stock
collapse, truncated = Tmax horizon), registered under both
"gym_fishing_tpu/<id>" and plain "<id>" for every id in our registry, so

    import gymnasium, gym_fishing_tpu.envs.gymnasium_compat  # noqa
    env = gymnasium.make("fishing-v1")

is a drop-in for the reference usage. Import of this module is optional —
the core engine has no gymnasium dependency.
"""

from __future__ import annotations

from typing import Optional

import gymnasium
import numpy as np
from gymnasium import spaces as gspaces

import jax
import jax.numpy as jnp

from gym_fishing_tpu.registry.registry import make as registry_make
from gym_fishing_tpu.registry.registry import registered_ids


class GymnasiumFishingEnv(gymnasium.Env):
    metadata = {"render_modes": ["ansi"]}

    def __init__(self, env_id: str = "fishing-v1", render_mode: Optional[str] = None, **overrides):
        super().__init__()
        self.env, self.params = registry_make(env_id, **overrides)
        self.render_mode = render_mode
        if self.env.config.scheme == "continuous":
            self.action_space = gspaces.Box(-1.0, 1.0, (1,), np.float32)
        else:
            self.action_space = gspaces.Discrete(self.env.config.n_actions)
        self.observation_space = gspaces.Box(-1.0, 1.0, (1,), np.float32)
        self.Tmax = int(np.asarray(self.params.Tmax))
        self._jit_step = jax.jit(self.env.step)
        self._key = jax.random.key(0)
        self._state = self.env.reset(self.params)

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        if seed is not None:
            self._key = jax.random.key(seed)
        self._state = self.env.reset(self.params)
        obs = np.asarray(self.env.get_obs(self.params, self._state), np.float32)
        return obs, {}

    def step(self, action):
        if self.env.config.scheme == "continuous":
            a = jnp.asarray(np.asarray(action, np.float32).reshape(1))
        else:
            a = jnp.asarray(int(np.asarray(action)), jnp.int32)
        self._key, sub = jax.random.split(self._key)
        self._state, ts = self._jit_step(self.params, self._state, a, sub)
        obs = np.asarray(ts.obs, np.float32)
        reward = float(ts.reward)
        stock = float(self._state.stock)
        terminated = stock <= 0.0
        truncated = int(self._state.t) >= self.Tmax and not terminated
        info = {"quota": float(ts.quota), "harvest": float(ts.harvest), "stock": stock}
        return obs, reward, terminated, truncated, info

    def render(self):
        return (
            f"t={int(self._state.t)} stock={float(self._state.stock):.6f} "
            f"harvest={float(self._state.harvest):.6f}"
        )


def register_all() -> None:
    """Register every engine env id with gymnasium (idempotent)."""
    existing = set(gymnasium.registry.keys())
    for env_id in registered_ids():
        for name in (f"gym_fishing_tpu/{env_id}", env_id):
            if name in existing:
                continue
            gymnasium.register(
                id=name,
                entry_point="gym_fishing_tpu.envs.gymnasium_compat:GymnasiumFishingEnv",
                kwargs={"env_id": env_id},
            )


register_all()
