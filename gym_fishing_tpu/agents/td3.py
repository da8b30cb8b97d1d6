"""TD3 (Twin Delayed DDPG) — the third member of the continuous-control
family the reference's experiments trained via sb3 (reference: lab usage of
PPO/SAC/TD3 on these envs; reconstructed, SURVEY.md §3.5).

Shares the device-resident ReplayBuffer with SAC; one jitted `train_step` =
one batched env step + K updates with clipped target-policy smoothing and
delayed (every-other-update) actor/target refreshes, implemented branchlessly
with a where-select so the update scan stays trace-static.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gym_fishing_tpu.agents._flax import nn
from gym_fishing_tpu.agents.sac import DoubleCritic, ReplayBuffer, buffer_add, buffer_init, buffer_sample
from gym_fishing_tpu.agents.train_state import TrainState
from gym_fishing_tpu.batch import batched_reset, batched_step
from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams


@dataclasses.dataclass(frozen=True)
class TD3Config:
    num_envs: int = 256
    buffer_size: int = 1 << 17
    batch_size: int = 4096
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    hidden: int = 64
    updates_per_step: int = 1
    explore_noise: float = 0.1       # behavior-policy Gaussian noise
    target_noise: float = 0.2        # target-policy smoothing
    target_noise_clip: float = 0.5
    policy_delay: int = 2


class DeterministicActor(nn.Module):
    act_dim: int
    hidden: int = 64

    @nn.compact
    def __call__(self, obs):
        x = nn.tanh(nn.Dense(self.hidden)(obs))
        x = nn.tanh(nn.Dense(self.hidden)(x))
        return nn.tanh(nn.Dense(self.act_dim)(x))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TD3State:
    actor: Any
    critic: Any
    target_actor_params: Any
    target_critic_params: Any
    buffer: ReplayBuffer
    env_state: Any
    obs: Any
    update_count: Any  # int32, for the delayed policy update


def make_td3_state(env: Env, cfg: TD3Config, key: jax.Array,
                   env_params: Optional[EnvParams] = None) -> TD3State:
    assert env.config.scheme == "continuous", "TD3 supports continuous envs"
    if env_params is None:
        env_params = env.params()
    k_a, k_c = jax.random.split(key)
    obs_dim, act_dim = env.observation_space.shape[0], 1
    actor_net = DeterministicActor(act_dim, cfg.hidden)
    critic_net = DoubleCritic(cfg.hidden)
    obs0 = jnp.zeros((1, obs_dim), jnp.float32)
    act0 = jnp.zeros((1, act_dim), jnp.float32)
    actor = TrainState.create(
        apply_fn=actor_net.apply, params=actor_net.init(k_a, obs0),
        tx=optax.adam(cfg.lr),
    )
    critic = TrainState.create(
        apply_fn=critic_net.apply, params=critic_net.init(k_c, obs0, act0),
        tx=optax.adam(cfg.lr),
    )
    bstate = batched_reset(env, env_params, cfg.num_envs)
    obs = jax.vmap(env.get_obs, in_axes=(None, 0))(env_params, bstate.env)
    return TD3State(
        actor=actor, critic=critic,
        target_actor_params=actor.params,
        target_critic_params=critic.params,
        buffer=buffer_init(cfg.buffer_size, obs_dim, act_dim),
        env_state=bstate, obs=obs.astype(jnp.float32),
        update_count=jnp.asarray(0, jnp.int32),
    )


def td3_train_step(
    env: Env,
    env_params: EnvParams,
    cfg: TD3Config,
    state: TD3State,
    key: jax.Array,
):
    k_act, k_env, k_upd = jax.random.split(key, 3)

    # ---- interact (exploration noise, clipped to the action box)
    action = state.actor.apply_fn(state.actor.params, state.obs)
    noise = cfg.explore_noise * jax.random.normal(k_act, action.shape)
    action = jnp.clip(action + noise, -1.0, 1.0)
    bstate2, rs = batched_step(env, env_params, state.env_state, action, k_env)
    next_obs = rs.obs.astype(jnp.float32)
    true_done = rs.done & (rs.episode_length < env_params.Tmax)
    buf = buffer_add(
        state.buffer, state.obs, action,
        rs.reward.astype(jnp.float32), next_obs, true_done.astype(jnp.float32),
    )
    state = dataclasses.replace(state, buffer=buf, env_state=bstate2, obs=next_obs)

    def update(state: TD3State, k):
        k_samp, k_smooth = jax.random.split(k)
        obs, act, rew, nobs, done = buffer_sample(state.buffer, k_samp, cfg.batch_size)

        # target action with clipped smoothing noise
        nact = state.actor.apply_fn(state.target_actor_params, nobs)
        smooth = jnp.clip(
            cfg.target_noise * jax.random.normal(k_smooth, nact.shape),
            -cfg.target_noise_clip, cfg.target_noise_clip,
        )
        nact = jnp.clip(nact + smooth, -1.0, 1.0)
        tq1, tq2 = state.critic.apply_fn(state.target_critic_params, nobs, nact)
        target_q = rew + cfg.gamma * (1.0 - done) * jnp.minimum(tq1, tq2)

        def critic_loss(p):
            q1, q2 = state.critic.apply_fn(p, obs, act)
            return ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()

        c_loss, c_grads = jax.value_and_grad(critic_loss)(state.critic.params)
        critic = state.critic.apply_gradients(grads=c_grads)

        # delayed actor + target update: compute always, apply every
        # policy_delay-th update via where-select (branchless under scan)
        def actor_loss(p):
            a = state.actor.apply_fn(p, obs)
            q1, _ = critic.apply_fn(critic.params, obs, a)
            return -q1.mean()

        a_loss, a_grads = jax.value_and_grad(actor_loss)(state.actor.params)
        actor_stepped = state.actor.apply_gradients(grads=a_grads)
        do_update = (state.update_count % cfg.policy_delay) == cfg.policy_delay - 1

        def sel(new, old):
            return jax.tree.map(lambda n, o: jnp.where(do_update, n, o), new, old)

        actor = state.actor.replace(
            step=jnp.where(do_update, actor_stepped.step, state.actor.step),
            params=sel(actor_stepped.params, state.actor.params),
            opt_state=sel(actor_stepped.opt_state, state.actor.opt_state),
        )
        soft = lambda t, o: (1 - cfg.tau) * t + cfg.tau * o
        target_actor = sel(
            jax.tree.map(soft, state.target_actor_params, actor.params),
            state.target_actor_params,
        )
        target_critic = sel(
            jax.tree.map(soft, state.target_critic_params, critic.params),
            state.target_critic_params,
        )
        state = dataclasses.replace(
            state, actor=actor, critic=critic,
            target_actor_params=target_actor, target_critic_params=target_critic,
            update_count=state.update_count + 1,
        )
        return state, {"critic_loss": c_loss, "actor_loss": a_loss}

    state, metrics = jax.lax.scan(update, state, jax.random.split(k_upd, cfg.updates_per_step))
    metrics = jax.tree.map(lambda x: x.mean(), metrics)

    done_f = rs.done.astype(jnp.float32)
    n_done = done_f.sum()
    metrics["episode_return"] = jnp.where(
        n_done > 0,
        (rs.episode_return.astype(jnp.float32) * done_f).sum() / jnp.maximum(n_done, 1),
        jnp.nan,
    )
    return state, metrics


def td3_train(
    env: Env,
    cfg: TD3Config,
    steps: int = 1000,
    seed: int = 0,
    env_params: Optional[EnvParams] = None,
):
    if env_params is None:
        env_params = env.params()
    key = jax.random.key(seed)
    key, k_init = jax.random.split(key)
    state = make_td3_state(env, cfg, k_init, env_params)
    step = jax.jit(partial(td3_train_step, env, env_params, cfg))
    history = []
    for i in range(steps):
        key, sub = jax.random.split(key)
        state, metrics = step(state, sub)
        if i % 50 == 0 or i == steps - 1:
            history.append({k: float(v) for k, v in metrics.items()})
    return state, history


class TD3Policy:
    """sb3-style .predict over a trained TD3State."""

    def __init__(self, env: Env, state: TD3State):
        self.env = env
        self.state = state

    def act(self, obs, carried_harvest=None):
        return self.state.actor.apply_fn(
            self.state.actor.params, jnp.asarray(obs, jnp.float32)
        )

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        return np.asarray(self.act(obs)), state
