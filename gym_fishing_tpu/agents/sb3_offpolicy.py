"""stable-baselines3-style facades over the off-policy learners: SAC, TD3
(continuous) and DQN (discrete).

They share the on-policy facades' surface (`agents/sb3_like.py`). The
learners' networks are flax modules, so this module needs flax; the
`gym_fishing_tpu.agents` package imports it on first use of `SAC`, `TD3` or
`DQN`.

    from gym_fishing_tpu.agents import SAC
    model = SAC("MlpPolicy", "fishing-v1", num_envs=256)
    model.learn(total_timesteps=100_000)
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from gym_fishing_tpu.agents.dqn import DQNConfig, DQNPolicy, dqn_train_step, make_dqn_state
from gym_fishing_tpu.agents.sac import SACConfig, SACPolicy, make_sac_state, sac_train_step
from gym_fishing_tpu.agents.sb3_like import _resolve_env
from gym_fishing_tpu.agents.td3 import TD3Config, TD3Policy, make_td3_state, td3_train_step
from gym_fishing_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint


class _OffPolicyAlgo:
    """Shared sb3-style surface for the off-policy learners (SAC/TD3/DQN).

    One `.learn` "timestep" is one batched env step of `cfg.num_envs`
    instances (sb3 counts single-env steps; here the batch is the unit, as
    with the PPO facade). The full learner state — networks, optimizers,
    targets, replay buffer, env state — checkpoints as one pytree, so
    save/load resumes training bit-exactly.
    """

    _cfg_cls = None
    _policy_cls = None
    _default_env = "fishing-v1"

    def __init__(
        self,
        policy: str = "MlpPolicy",
        env: Any = None,
        seed: int = 0,
        verbose: int = 0,
        **cfg_kwargs,
    ):
        if policy != "MlpPolicy":
            raise ValueError("only MlpPolicy is supported (reference parity)")
        self.env, self.env_params = _resolve_env(
            env if env is not None else self._default_env
        )
        self.cfg = self._cfg_cls(**cfg_kwargs)
        self.verbose = verbose
        self._key = jax.random.key(seed)
        self._key, k_init = jax.random.split(self._key)
        self.state = self._make_state(k_init)
        self._jit_step = jax.jit(self._step_fn())
        self.num_timesteps = 0
        self.history: list = []

    # Per-algo hooks -------------------------------------------------------
    def _make_state(self, key):
        raise NotImplementedError

    def _step_fn(self):
        raise NotImplementedError

    # ------------------------------------------------------------------ learn
    def learn(self, total_timesteps: int, callback=None, log_interval: int = 100):
        steps = max(1, math.ceil(total_timesteps / self.cfg.num_envs))
        for it in range(steps):
            self._key, sub = jax.random.split(self._key)
            self.state, metrics = self._jit_step(self.state, sub)
            self.num_timesteps += self.cfg.num_envs
            m = {k: float(v) for k, v in metrics.items()}
            self.history.append(m)
            if callback is not None:
                callback(self, m)
            if self.verbose and it % log_interval == 0:
                print(f"step {it}/{steps} env-steps={self.num_timesteps} "
                      f"ep_ret={m.get('episode_return', float('nan')):.3f}")
        return self

    # ---------------------------------------------------------------- predict
    @property
    def policy(self):
        return self._policy_cls(self.env, self.state)

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        return self.policy.predict(
            obs, state=state, episode_start=episode_start, deterministic=deterministic
        )

    # -------------------------------------------------------------- save/load
    def save(self, path: str) -> None:
        save_checkpoint(
            path,
            {"state": self.state, "rng_key": self._key,
             "step": jnp.asarray(self.num_timesteps)},
            step=0,
        )

    @classmethod
    def load(cls, path: str, env: Any = None, **kwargs):
        model = cls(env=env, **kwargs)
        template = {"state": model.state, "rng_key": model._key,
                    "step": jnp.asarray(0)}
        restored, _ = restore_checkpoint(path, template, step=0)
        model.state = restored["state"]
        model._key = restored["rng_key"]
        model.num_timesteps = int(restored["step"])
        return model


class SAC(_OffPolicyAlgo):
    """sb3-style SAC over the device-resident off-policy learner."""

    _cfg_cls = SACConfig
    _policy_cls = SACPolicy

    def _make_state(self, key):
        state, self._alpha_tx = make_sac_state(self.env, self.cfg, key, self.env_params)
        return state

    def _step_fn(self):
        return partial(sac_train_step, self.env, self.env_params, self.cfg, self._alpha_tx)


class TD3(_OffPolicyAlgo):
    """sb3-style TD3 over the device-resident off-policy learner."""

    _cfg_cls = TD3Config
    _policy_cls = TD3Policy

    def _make_state(self, key):
        return make_td3_state(self.env, self.cfg, key, self.env_params)

    def _step_fn(self):
        return partial(td3_train_step, self.env, self.env_params, self.cfg)


class DQN(_OffPolicyAlgo):
    """sb3-style DQN over the device-resident off-policy learner (discrete)."""

    _cfg_cls = DQNConfig
    _policy_cls = None  # DQNPolicy needs env_params; built in .policy
    _default_env = "fishing-v0"

    def _make_state(self, key):
        return make_dqn_state(self.env, self.cfg, key, self.env_params)

    def _step_fn(self):
        return partial(dqn_train_step, self.env, self.env_params, self.cfg)

    @property
    def policy(self):
        return DQNPolicy(self.env, self.state, self.env_params)
