"""Stateful gym-style adapter over the functional engine (drop-in surface).

A user of the reference interacts with a mutable `gym.Env` (reference:
gym_fishing/envs/base_fishing_env.py — reset/step/render/simulate/plot plus
attributes fish_population / harvest / years_passed; reconstructed). This
adapter reproduces that surface 1:1 on top of the pure JAX engine: it owns an
``EnvState`` + JAX key, steps through a jitted closure, and exposes numpy in
/ numpy out. Single-instance and eager by design — the batched/scan engine in
``gym_fishing_tpu.batch`` is the performance path; this is the compatibility
path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gym_fishing_tpu.analysis.plotting import plot_mdp, plot_policyfn, write_csv
from gym_fishing_tpu.analysis.simulate import estimate_policyfn, simulate_mdp
from gym_fishing_tpu.registry.registry import make as registry_make


class GymFishingEnv:
    """gym.Env-compatible wrapper: `GymFishingEnv("fishing-v1", sigma=0.1)`."""

    metadata = {"render.modes": ["ansi"]}

    def __init__(
        self,
        env_id: str = "fishing-v1",
        seed: int = 0,
        file: Optional[str] = None,
        **overrides,
    ):
        self.env, self.params = registry_make(env_id, **overrides)
        self.action_space = self.env.action_space
        self.observation_space = self.env.observation_space
        self.Tmax = int(np.asarray(self.params.Tmax))
        self._step = jax.jit(self.env.step)
        self._key = jax.random.key(seed)
        self._state = None
        # reference-parity per-step episode log (SURVEY.md §5.5: the reference
        # envs take a file=/CSV row-writing ctor path): every step appends one
        # tidy row [time, state, action, reward, rep]; rep counts resets.
        self._file = open(file, "w") if file else None
        self._rep = -1
        if self._file:
            self._file.write("time,state,action,reward,rep\n")
        self.reset(seed=seed)

    # ------------------------------------------------------------- gym API
    def seed(self, seed: Optional[int] = None):
        if seed is not None:
            self._key = jax.random.key(seed)
        return [seed]

    def reset(self, *, seed: Optional[int] = None, options=None, return_info: bool = False):
        del options
        if seed is not None:
            self.seed(seed)
        self._state = self.env.reset(self.params)
        self._rep += 1
        obs = np.asarray(self.env.get_obs(self.params, self._state))
        return (obs, {}) if return_info else obs

    def step(self, action) -> Tuple[np.ndarray, float, bool, dict]:
        if self.env.config.scheme == "continuous":
            a = jnp.asarray(np.asarray(action, np.float32).reshape(1))
        else:
            a = jnp.asarray(int(np.asarray(action)), jnp.int32)
        self._key, sub = jax.random.split(self._key)
        t_pre, x_pre = int(self._state.t), float(self._state.stock)
        self._state, ts = self._step(self.params, self._state, a, sub)
        info = {
            "quota": float(ts.quota),
            "harvest": float(ts.harvest),
            "stock": float(self._state.stock),
        }
        if self._file:
            a_log = (
                float(np.asarray(action).reshape(-1)[0])
                if self.env.config.scheme == "continuous"
                else int(np.asarray(action))
            )
            self._file.write(
                f"{t_pre},{x_pre},{a_log},{float(ts.reward)},{self._rep}\n"
            )
        return np.asarray(ts.obs), float(ts.reward), bool(ts.done), info

    def render(self, mode: str = "ansi"):
        return (
            f"t={self.years_passed} stock={self.fish_population:.6f} "
            f"harvest={self.harvest:.6f}"
        )

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

    # -------------------------------------------- reference-parity attrs
    @property
    def fish_population(self) -> float:
        return float(self._state.stock)

    @property
    def harvest(self) -> float:
        return float(self._state.harvest)

    @property
    def years_passed(self) -> int:
        return int(self._state.t)

    # ---------------------------------------- reference-parity utilities
    def get_obs(self):
        return np.asarray(self.env.get_obs(self.params, self._state))

    def get_fish_population(self, obs) -> float:
        return float(self.env.get_fish_population(self.params, jnp.asarray(obs)))

    def get_quota(self, action) -> float:
        if self.env.config.scheme == "continuous":
            a = jnp.asarray(np.asarray(action, np.float32).reshape(1))
        else:
            a = jnp.asarray(int(np.asarray(action)), jnp.int32)
        return float(self.env.get_quota(self.params, self._state, a))

    def get_action(self, quota: float):
        return np.asarray(self.env.get_action(self.params, self._state, quota))

    def simulate(self, model, reps: int = 1, file: Optional[str] = None):
        df = simulate_mdp(self.env, model, reps=reps, params=self.params)
        if file:
            write_csv(df, file)
        return df

    def policyfn(self, model, reps: int = 1, n: int = 50):
        return estimate_policyfn(self.env, model, reps=reps, n=n, params=self.params)

    def plot(self, df, output: Optional[str] = None):
        return plot_mdp(df, output)

    def plot_policy(self, df, output: Optional[str] = None):
        return plot_policyfn(df, output)
