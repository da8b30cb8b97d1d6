"""gymnasium.vector.VectorEnv adapter over the batched JAX engine.

The reference has no vector API at all (SURVEY.md §2.4 — not even gym's
SyncVectorEnv is used). This adapter exposes the jit+vmap engine through the
standard `gymnasium.vector.VectorEnv` protocol (batched reset/step with
in-graph auto-reset), so CleanRL/sb3-style vectorized training code drops in
while the actual stepping runs as one fused XLA program on device.

    from gym_fishing_tpu.envs.vector_env import FishingVectorEnv
    envs = FishingVectorEnv("fishing-v1", num_envs=4096, sigma=0.05)
    obs, infos = envs.reset(seed=0)
    obs, rew, term, trunc, infos = envs.step(actions)   # numpy in/out
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

try:
    import gymnasium
    from gymnasium import spaces as gspaces

    _VectorBase = gymnasium.vector.VectorEnv
except Exception:  # pragma: no cover - gymnasium optional
    gymnasium = None
    _VectorBase = object

from gym_fishing_tpu.batch import batched_reset, batched_step
from gym_fishing_tpu.registry.registry import make as registry_make


class FishingVectorEnv(_VectorBase):
    """Vectorized env: numpy at the boundary, one fused XLA step inside."""

    def __init__(self, env_id: str = "fishing-v1", num_envs: int = 1024, seed: int = 0, **overrides):
        self.env, self.params = registry_make(env_id, **overrides)
        self.num_envs = num_envs
        if gymnasium is not None:
            if self.env.config.scheme == "continuous":
                self.single_action_space = gspaces.Box(-1.0, 1.0, (1,), np.float32)
            else:
                self.single_action_space = gspaces.Discrete(self.env.config.n_actions)
            self.single_observation_space = gspaces.Box(-1.0, 1.0, (1,), np.float32)
            self.action_space = gymnasium.vector.utils.batch_space(
                self.single_action_space, num_envs
            )
            self.observation_space = gymnasium.vector.utils.batch_space(
                self.single_observation_space, num_envs
            )
        self.Tmax = int(np.asarray(self.params.Tmax))
        self._key = jax.random.key(seed)
        self._state = batched_reset(self.env, self.params, num_envs)
        self._jit_step = jax.jit(
            lambda s, a, k: batched_step(self.env, self.params, s, a, k, autoreset=True)
        )
        self._obs_fn = jax.jit(
            lambda s: jax.vmap(self.env.get_obs, in_axes=(None, 0))(self.params, s.env)
        )

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._key = jax.random.key(seed)
        self._state = batched_reset(self.env, self.params, self.num_envs)
        obs = np.asarray(self._obs_fn(self._state), np.float32)
        return obs, {}

    def step(self, actions):
        if self.env.config.scheme == "continuous":
            a = jnp.asarray(np.asarray(actions, np.float32).reshape(self.num_envs, 1))
        else:
            a = jnp.asarray(np.asarray(actions, np.int64).reshape(self.num_envs), jnp.int32)
        self._key, sub = jax.random.split(self._key)
        self._state, ts = self._jit_step(self._state, a, sub)
        obs = np.asarray(ts.obs, np.float32)
        reward = np.asarray(ts.reward, np.float32)
        done = np.asarray(ts.done)
        # terminated = collapse, truncated = horizon-only; the step carries the
        # collapse flag out explicitly, so a collapse exactly on the Tmax-th
        # step still classifies as terminated (matches gymnasium_compat).
        terminated = np.asarray(ts.collapsed)
        truncated = done & ~terminated
        infos = {
            "episode_return": np.asarray(ts.episode_return, np.float32),
            "episode_length": np.asarray(ts.episode_length),
            "harvest": np.asarray(ts.harvest, np.float32),
            "quota": np.asarray(ts.quota, np.float32),
        }
        return obs, reward, terminated, truncated, infos

    def render(self):
        return None

    def close(self, **kwargs):
        pass
