"""stable-baselines3-style facades over the JAX learners.

Reference workloads train via sb3: `PPO("MlpPolicy", env).learn(300_000)` then
`env.simulate(model)` (reference: README usage, SURVEY.md §3.5;
reconstructed). These facades reproduce that workflow verbatim on the batched
engine — no torch, no host round-trips in the rollout — so reference users
can port scripts by changing only the import. `A2C` shares the on-policy
surface; `SAC`, `TD3` (continuous) and `DQN` (discrete) get the same surface
over the off-policy learners in `agents/sb3_offpolicy.py`, which needs flax
and loads on first use.

    from gym_fishing_tpu.agents.sb3_like import PPO
    model = PPO("MlpPolicy", "fishing-v1", num_envs=4096)
    model.learn(total_timesteps=2_000_000)
    action, _ = model.predict(obs)
    model.save("ppo_fishing")
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from gym_fishing_tpu.agents.a2c import A2CConfig, a2c_train_step, make_a2c_state
from gym_fishing_tpu.agents.ppo import (
    PPOConfig,
    PPOPolicy,
    make_train_state,
    train_step,
)
from gym_fishing_tpu.batch import batched_reset
from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams
from gym_fishing_tpu.registry.registry import make as registry_make
from gym_fishing_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint


def _resolve_env(env) -> Tuple[Env, EnvParams]:
    if isinstance(env, str):
        return registry_make(env)
    if isinstance(env, Env):
        return env, env.params()
    if isinstance(env, tuple) and len(env) == 2:
        return env
    # GymFishingEnv / GymnasiumFishingEnv adapters carry .env/.params
    if hasattr(env, "env") and hasattr(env, "params"):
        return env.env, env.params
    raise TypeError(f"cannot resolve environment from {type(env)!r}")


class PPO:
    """sb3-compatible surface: __init__(policy, env), learn, predict, save/load."""

    _cfg_cls = PPOConfig
    _make_ts = staticmethod(make_train_state)
    _train_step = staticmethod(train_step)

    def __init__(
        self,
        policy: str = "MlpPolicy",
        env: Any = "fishing-v1",
        seed: int = 0,
        verbose: int = 0,
        **ppo_kwargs,
    ):
        if policy != "MlpPolicy":
            raise ValueError("only MlpPolicy is supported (reference parity)")
        self.env, self.env_params = _resolve_env(env)
        self.cfg = self._cfg_cls(**ppo_kwargs)
        self.verbose = verbose
        self._key = jax.random.key(seed)
        self._key, k_init = jax.random.split(self._key)
        self.train_state = self._make_ts(self.env, self.cfg, k_init)
        self._bstate = batched_reset(self.env, self.env_params, self.cfg.num_envs)
        step_fn = type(self)._train_step
        self._jit_step = jax.jit(
            lambda ts, b, k: step_fn(self.env, self.env_params, self.cfg, ts, b, k)
        )
        self.num_timesteps = 0
        self.history: list = []

    # ------------------------------------------------------------------ learn
    def learn(self, total_timesteps: int, callback=None, log_interval: int = 10):
        per_iter = self.cfg.num_envs * self.cfg.num_steps
        iterations = max(1, math.ceil(total_timesteps / per_iter))
        for it in range(iterations):
            self._key, sub = jax.random.split(self._key)
            self.train_state, self._bstate, metrics = self._jit_step(
                self.train_state, self._bstate, sub
            )
            self.num_timesteps += per_iter
            m = {k: float(v) for k, v in metrics.items()}
            self.history.append(m)
            if callback is not None:
                callback(self, m)
            if self.verbose and it % log_interval == 0:
                print(
                    f"iter {it}/{iterations} steps={self.num_timesteps} "
                    f"ep_ret={m['episode_return']:.3f} ep_len={m['episode_length']:.1f}"
                )
        return self

    # ---------------------------------------------------------------- predict
    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        return PPOPolicy(self.env, self.train_state).predict(
            obs, state=state, episode_start=episode_start, deterministic=deterministic
        )

    @property
    def policy(self) -> PPOPolicy:
        return PPOPolicy(self.env, self.train_state)

    # -------------------------------------------------------------- save/load
    def save(self, path: str) -> None:
        save_checkpoint(
            path,
            {
                "params": self.train_state.params,
                "opt_state": self.train_state.opt_state,
                "env_state": self._bstate,
                "rng_key": self._key,
                "step": jnp.asarray(self.num_timesteps),
            },
            step=0,
        )

    @classmethod
    def load(cls, path: str, env: Any = "fishing-v1", **kwargs) -> "PPO":
        model = cls(env=env, **kwargs)
        template = {
            "params": model.train_state.params,
            "opt_state": model.train_state.opt_state,
            "env_state": model._bstate,
            "rng_key": model._key,
            "step": jnp.asarray(0),
        }
        restored, _ = restore_checkpoint(path, template, step=0)
        model.train_state = model.train_state.replace(
            params=restored["params"], opt_state=restored["opt_state"]
        )
        model._bstate = restored["env_state"]
        model._key = restored["rng_key"]
        model.num_timesteps = int(restored["step"])
        return model


class A2C(PPO):
    """sb3-style A2C: same on-policy surface, single unclipped RMSProp update."""

    _cfg_cls = A2CConfig
    _make_ts = staticmethod(make_a2c_state)
    _train_step = staticmethod(a2c_train_step)


def __getattr__(name):
    # the off-policy facades need flax, so they load on first use
    if name in ("DQN", "SAC", "TD3"):
        from gym_fishing_tpu.agents import sb3_offpolicy

        return getattr(sb3_offpolicy, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
