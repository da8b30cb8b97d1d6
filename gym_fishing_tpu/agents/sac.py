"""Soft Actor-Critic with a device-resident replay buffer.

The reference's published experiments train sb3 agents (PPO/SAC/TD3-family)
on these envs (reference: README + lab usage; reconstructed, SURVEY.md §3.5).
This provides the off-policy member of that family, on device: the replay
buffer is a set of pre-allocated device arrays (no host round-trips — insert
is a wrapped dynamic scatter of the vectorized envs' transitions, sampling a
uniform row-gather), and one `train_step` = one batched env step + K critic/
actor/alpha updates, all in a single jitted program.

Continuous-action envs only (tanh-squashed Gaussian policy).
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
from gym_fishing_tpu.agents.train_state import TrainState
from gym_fishing_tpu.batch import BatchState, batched_reset, batched_step
from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


@dataclasses.dataclass(frozen=True)
class SACConfig:
    num_envs: int = 256
    buffer_size: int = 1 << 17        # transitions (device-resident)
    batch_size: int = 4096
    gamma: float = 0.99
    tau: float = 0.005                # target soft-update rate
    lr: float = 3e-4
    hidden: int = 64
    updates_per_step: int = 1
    target_entropy_scale: float = 1.0  # target entropy = -scale * act_dim
    init_alpha: float = 0.1


class SquashedGaussianActor(nn.Module):
    act_dim: int
    hidden: int = 64

    @nn.compact
    def __call__(self, obs):
        x = nn.tanh(nn.Dense(self.hidden)(obs))
        x = nn.tanh(nn.Dense(self.hidden)(x))
        mean = nn.Dense(self.act_dim)(x)
        log_std = jnp.clip(nn.Dense(self.act_dim)(x), LOG_STD_MIN, LOG_STD_MAX)
        return mean, log_std


class DoubleCritic(nn.Module):
    hidden: int = 64

    @nn.compact
    def __call__(self, obs, act):
        x = jnp.concatenate([obs, act], axis=-1)

        def q(x, name):
            h = nn.tanh(nn.Dense(self.hidden, name=f"{name}_d1")(x))
            h = nn.tanh(nn.Dense(self.hidden, name=f"{name}_d2")(h))
            return nn.Dense(1, name=f"{name}_out")(h)[..., 0]

        return q(x, "q1"), q(x, "q2")


def sample_squashed(mean, log_std, key):
    """Reparameterized tanh-Gaussian sample + log-prob."""
    std = jnp.exp(log_std)
    eps = jax.random.normal(key, mean.shape, mean.dtype)
    pre = mean + std * eps
    act = jnp.tanh(pre)
    logp = jnp.sum(
        -0.5 * (eps**2 + 2 * log_std + jnp.log(2 * jnp.pi))
        - jnp.log(1.0 - act**2 + 1e-6),
        axis=-1,
    )
    return act, logp


# ---------------------------------------------------------------- buffer
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ReplayBuffer:
    obs: Any       # (cap, obs_dim)
    action: Any    # (cap, act_dim)
    reward: Any    # (cap,)
    next_obs: Any  # (cap, obs_dim)
    done: Any      # (cap,)  float32 (1.0 = terminal, horizon-truncation = 0)
    ptr: Any       # int32
    size: Any      # int32


def buffer_init(cap: int, obs_dim: int, act_dim: int) -> ReplayBuffer:
    return ReplayBuffer(
        obs=jnp.zeros((cap, obs_dim), jnp.float32),
        action=jnp.zeros((cap, act_dim), jnp.float32),
        reward=jnp.zeros((cap,), jnp.float32),
        next_obs=jnp.zeros((cap, obs_dim), jnp.float32),
        done=jnp.zeros((cap,), jnp.float32),
        ptr=jnp.asarray(0, jnp.int32),
        size=jnp.asarray(0, jnp.int32),
    )


def buffer_add(buf: ReplayBuffer, obs, action, reward, next_obs, done) -> ReplayBuffer:
    """Vectorized wrapped insert of a batch of transitions (in-graph).

    Values are cast to the buffer dtypes so x64-mode envs (the exactness
    test configuration) scatter cleanly into the float32 storage.
    """
    B = obs.shape[0]
    cap = buf.obs.shape[0]
    idx = (buf.ptr + jnp.arange(B, dtype=jnp.int32)) % cap
    return ReplayBuffer(
        obs=buf.obs.at[idx].set(obs.astype(buf.obs.dtype)),
        action=buf.action.at[idx].set(action.astype(buf.action.dtype)),
        reward=buf.reward.at[idx].set(reward.astype(buf.reward.dtype)),
        next_obs=buf.next_obs.at[idx].set(next_obs.astype(buf.next_obs.dtype)),
        done=buf.done.at[idx].set(done.astype(buf.done.dtype)),
        ptr=(buf.ptr + B) % cap,
        size=jnp.minimum(buf.size + B, cap),
    )


def buffer_sample(buf: ReplayBuffer, key: jax.Array, batch: int):
    idx = jax.random.randint(key, (batch,), 0, jnp.maximum(buf.size, 1))
    return (
        buf.obs[idx], buf.action[idx], buf.reward[idx],
        buf.next_obs[idx], buf.done[idx],
    )


# ----------------------------------------------------------------- state
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SACState:
    actor: Any            # TrainState
    critic: Any           # TrainState
    target_critic_params: Any
    log_alpha: Any
    alpha_opt_state: Any
    buffer: ReplayBuffer
    env_state: Any        # BatchState
    obs: Any              # (num_envs, obs_dim) current observations


def make_sac_state(env: Env, cfg: SACConfig, key: jax.Array,
                   env_params: Optional[EnvParams] = None) -> Tuple[SACState, Any]:
    assert env.config.scheme == "continuous", "SAC supports continuous envs"
    if env_params is None:
        env_params = env.params()
    k_a, k_c = jax.random.split(key)
    obs_dim, act_dim = env.observation_space.shape[0], 1
    actor_net = SquashedGaussianActor(act_dim, cfg.hidden)
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
    alpha_tx = optax.adam(cfg.lr)
    log_alpha = jnp.asarray(np.log(cfg.init_alpha), jnp.float32)
    bstate = batched_reset(env, env_params, cfg.num_envs)
    obs = jax.vmap(env.get_obs, in_axes=(None, 0))(env_params, bstate.env)
    state = SACState(
        actor=actor,
        critic=critic,
        target_critic_params=critic.params,
        log_alpha=log_alpha,
        alpha_opt_state=alpha_tx.init(log_alpha),
        buffer=buffer_init(cfg.buffer_size, obs_dim, act_dim),
        env_state=bstate,
        obs=obs.astype(jnp.float32),
    )
    return state, alpha_tx


def sac_train_step(
    env: Env,
    env_params: EnvParams,
    cfg: SACConfig,
    alpha_tx,
    state: SACState,
    key: jax.Array,
):
    """One batched env step + cfg.updates_per_step SAC updates (jittable)."""
    k_act, k_env, k_upd = jax.random.split(key, 3)

    # ---- interact
    mean, log_std = state.actor.apply_fn(state.actor.params, state.obs)
    action, _ = sample_squashed(mean, log_std, k_act)
    bstate2, rs = batched_step(env, env_params, state.env_state, action, k_env)
    next_obs = rs.obs.astype(jnp.float32)
    # horizon truncation is not a true terminal: bootstrap through Tmax ends
    true_done = rs.done & (rs.episode_length < env_params.Tmax)
    buf = buffer_add(
        state.buffer, state.obs, action,
        rs.reward.astype(jnp.float32), next_obs, true_done.astype(jnp.float32),
    )
    state = dataclasses.replace(state, buffer=buf, env_state=bstate2, obs=next_obs)

    target_entropy = -cfg.target_entropy_scale * 1.0  # act_dim == 1

    def update(state: SACState, k):
        k_samp, k_pi, k_pi2 = jax.random.split(k, 3)
        obs, act, rew, nobs, done = buffer_sample(state.buffer, k_samp, cfg.batch_size)
        alpha = jnp.exp(state.log_alpha)

        # critic update
        nmean, nlog_std = state.actor.apply_fn(state.actor.params, nobs)
        nact, nlogp = sample_squashed(nmean, nlog_std, k_pi)
        tq1, tq2 = state.critic.apply_fn(state.target_critic_params, nobs, nact)
        target_v = jnp.minimum(tq1, tq2) - alpha * nlogp
        target_q = rew + cfg.gamma * (1.0 - done) * target_v

        def critic_loss(p):
            q1, q2 = state.critic.apply_fn(p, obs, act)
            return ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()

        c_loss, c_grads = jax.value_and_grad(critic_loss)(state.critic.params)
        critic = state.critic.apply_gradients(grads=c_grads)

        # actor update
        def actor_loss(p):
            m, ls = state.actor.apply_fn(p, obs)
            a, logp = sample_squashed(m, ls, k_pi2)
            q1, q2 = critic.apply_fn(critic.params, obs, a)
            return (alpha * logp - jnp.minimum(q1, q2)).mean(), logp

        (a_loss, logp), a_grads = jax.value_and_grad(actor_loss, has_aux=True)(
            state.actor.params
        )
        actor = state.actor.apply_gradients(grads=a_grads)

        # temperature update
        def alpha_loss(la):
            return (-jnp.exp(la) * (jax.lax.stop_gradient(logp) + target_entropy)).mean()

        al_loss, al_grad = jax.value_and_grad(alpha_loss)(state.log_alpha)
        updates, al_opt = alpha_tx.update(al_grad, state.alpha_opt_state)
        log_alpha = optax.apply_updates(state.log_alpha, updates)

        target = jax.tree.map(
            lambda t, o: (1 - cfg.tau) * t + cfg.tau * o,
            state.target_critic_params, critic.params,
        )
        state = dataclasses.replace(
            state, actor=actor, critic=critic, target_critic_params=target,
            log_alpha=log_alpha, alpha_opt_state=al_opt,
        )
        metrics = {
            "critic_loss": c_loss, "actor_loss": a_loss,
            "alpha": jnp.exp(log_alpha), "alpha_loss": al_loss,
        }
        return state, metrics

    state, metrics = jax.lax.scan(update, state, jax.random.split(k_upd, cfg.updates_per_step))
    metrics = jax.tree.map(lambda x: x.mean(), metrics)

    done_f = rs.done.astype(jnp.float32)
    n_done = done_f.sum()
    metrics["episode_return"] = jnp.where(
        n_done > 0,
        (rs.episode_return.astype(jnp.float32) * done_f).sum() / jnp.maximum(n_done, 1),
        jnp.nan,
    )
    metrics["buffer_size"] = state.buffer.size
    return state, metrics


def sac_train(
    env: Env,
    cfg: SACConfig,
    steps: int = 1000,
    seed: int = 0,
    env_params: Optional[EnvParams] = None,
    warmup_steps: int = 10,
):
    """Host loop over the jitted SAC step (single-device convenience API)."""
    if env_params is None:
        env_params = env.params()
    key = jax.random.key(seed)
    key, k_init = jax.random.split(key)
    state, alpha_tx = make_sac_state(env, cfg, k_init, env_params)
    step = jax.jit(partial(sac_train_step, env, env_params, cfg, alpha_tx))
    history = []
    for i in range(steps):
        key, sub = jax.random.split(key)
        state, metrics = step(state, sub)
        if i % 50 == 0 or i == steps - 1:
            history.append({k: float(v) for k, v in metrics.items()})
    return state, history


class SACPolicy:
    """sb3-style .predict over a trained SACState (deterministic mean)."""

    def __init__(self, env: Env, state: SACState):
        self.env = env
        self.state = state

    def act(self, obs, carried_harvest=None):
        mean, _ = self.state.actor.apply_fn(
            self.state.actor.params, jnp.asarray(obs, jnp.float32)
        )
        return jnp.tanh(mean)

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        return np.asarray(self.act(obs)), state
