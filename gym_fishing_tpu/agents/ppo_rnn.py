"""Recurrent PPO (GRU actor-critic) for the partially observed variants.

Frame stacking (`envs/wrappers.ObsStackEnv`) is the cheap POMDP remedy; this
is the principled one: a GRU carries a learned belief state across the
episode, so policies can filter observation noise (`sigma_m > 0`), infer the
latent growth model (mixture variant), or track the drifting productivity of
the non-stationary env. The reference has no learner of its own (sb3
RecurrentPPO fills this role externally; reconstructed).

Shape of the algorithm on device:
- Collection is the same single `lax.scan` as `agents/ppo.py`, with the
  hidden state as one more carry leaf, where-select reset to the initial
  hidden on episode end (no `lax.cond` divergence under vmap).
- The update replays whole [T, B_mb] sequences through the GRU under
  `lax.scan` (truncated BPTT over the rollout segment) — minibatches cut
  across the *env* axis only, never across time, so the recurrence stays
  intact. Sequence replay is batched matmuls on device; nothing here is
  scalar or host-side.
- GAE, the clipped PPO loss, and the distributions are shared with
  `agents/ppo.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gym_fishing_tpu.agents._flax import nn
from gym_fishing_tpu.agents.ppo import (
    action_logp_entropy,
    compute_gae,
    sample_action,
)
from gym_fishing_tpu.agents.train_state import TrainState
from gym_fishing_tpu.batch import BatchState, batched_reset, batched_step
from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams


@dataclasses.dataclass(frozen=True)
class RPPOConfig:
    num_envs: int = 256
    num_steps: int = 64          # BPTT segment length
    epochs: int = 4
    num_minibatches: int = 4     # cuts across envs; num_envs % this == 0
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: int = 64             # GRU width (also the obs embedding width)


class RecurrentActorCritic(nn.Module):
    action_dim: int
    continuous: bool
    hidden: int = 64

    @nn.compact
    def __call__(self, obs, h):
        x = nn.tanh(
            nn.Dense(self.hidden, name="embed",
                     kernel_init=nn.initializers.orthogonal(np.sqrt(2)))(obs)
        )
        h, y = nn.GRUCell(self.hidden, name="gru")(h, x)
        value = nn.Dense(1, name="v_out",
                         kernel_init=nn.initializers.orthogonal(1.0))(y)[..., 0]
        if self.continuous:
            mean = nn.Dense(self.action_dim, name="pi_mean",
                            kernel_init=nn.initializers.orthogonal(0.01))(y)
            log_std = self.param(
                "log_std", nn.initializers.zeros, (self.action_dim,), jnp.float32
            )
            return (mean, log_std), value, h
        logits = nn.Dense(self.action_dim, name="pi_logits",
                          kernel_init=nn.initializers.orthogonal(0.01))(y)
        return (logits,), value, h


def init_hidden(cfg: RPPOConfig, batch: int) -> jax.Array:
    return jnp.zeros((batch, cfg.hidden), jnp.float32)


def make_rppo_state(env: Env, cfg: RPPOConfig, key: jax.Array) -> TrainState:
    continuous = env.config.scheme == "continuous"
    action_dim = 1 if continuous else env.config.n_actions
    net = RecurrentActorCritic(action_dim, continuous, cfg.hidden)
    obs_dim = env.observation_space.shape[0]
    params = net.init(key, jnp.zeros((1, obs_dim), jnp.float32),
                      jnp.zeros((1, cfg.hidden), jnp.float32))
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(cfg.lr, eps=1e-5),
    )
    return TrainState.create(apply_fn=net.apply, params=params, tx=tx)


@dataclasses.dataclass
class RTransition:
    obs: Any
    action: Any
    logp: Any
    value: Any
    reward: Any
    done: Any
    episode_return: Any
    episode_length: Any


jax.tree_util.register_dataclass(RTransition)


def collect_rollout(env, env_params, cfg: RPPOConfig, ts: TrainState,
                    bstate: BatchState, h0: jax.Array, key: jax.Array):
    """Scan rollout carrying the GRU hidden; reset hidden on episode end.

    Returns (bstate, obs_last, h_last, h_start, traj, last_value) where
    h_start is the hidden state the segment STARTED with (needed to replay
    the sequence during the update).
    """
    continuous = env.config.scheme == "continuous"

    def body(carry, step_key):
        bstate, obs, h = carry
        k_act, k_env = jax.random.split(step_key)
        dist, value, h_next = ts.apply_fn(ts.params, obs, h)
        action, logp = sample_action(dist, k_act, continuous)
        env_action = action if continuous else action.astype(jnp.int32)
        bstate2, rs = batched_step(env, env_params, bstate, env_action, k_env)
        # episode boundary: next step starts from a fresh hidden state
        h_next = jnp.where(rs.done[:, None], jnp.zeros_like(h_next), h_next)
        tr = RTransition(
            obs=obs,
            action=action,
            logp=logp,
            value=value,
            reward=rs.reward.astype(jnp.float32),
            done=rs.done,
            episode_return=rs.episode_return.astype(jnp.float32),
            episode_length=rs.episode_length,
        )
        return (bstate2, rs.obs.astype(jnp.float32), h_next), tr

    obs0 = jax.vmap(env.get_obs, in_axes=(None, 0))(env_params, bstate.env)
    obs0 = obs0.astype(jnp.float32)
    keys = jax.random.split(key, cfg.num_steps)
    (bstate, obs_last, h_last), traj = jax.lax.scan(body, (bstate, obs0, h0), keys)
    _, last_value, _ = ts.apply_fn(ts.params, obs_last, h_last)
    return bstate, obs_last, h_last, h0, traj, last_value


def replay_sequence(apply_fn, params, obs_seq, done_seq, h0):
    """Re-run the GRU over a [T, B, ...] segment with the collection-time
    reset convention (hidden zeroed after a done step). Returns stacked
    (dist leaves, values) over time."""

    def body(h, inp):
        obs_t, done_t = inp
        dist, value, h_next = apply_fn(params, obs_t, h)
        if len(dist) == 2:  # continuous: broadcast shared log_std so the
            # time-stacked leaves keep [T, B, A] shapes for the loss
            dist = (dist[0], jnp.broadcast_to(dist[1], dist[0].shape))
        h_next = jnp.where(done_t[:, None], jnp.zeros_like(h_next), h_next)
        return h_next, (dist, value)

    _, (dists, values) = jax.lax.scan(body, h0, (obs_seq, done_seq))
    return dists, values


def rppo_loss(apply_fn, params, cfg: RPPOConfig, batch, continuous: bool):
    """Clipped PPO loss over a replayed [T, B_mb] sequence."""
    obs, action, done, old_logp, old_value, adv, ret, h0 = batch
    dists, value = replay_sequence(apply_fn, params, obs, done, h0)
    logp, entropy = action_logp_entropy(dists, action, continuous)
    ratio = jnp.exp(logp - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg1 = ratio * adv_n
    pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pg_loss = -jnp.minimum(pg1, pg2).mean()
    v_clipped = old_value + jnp.clip(value - old_value, -cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * jnp.maximum((value - ret) ** 2, (v_clipped - ret) ** 2).mean()
    ent = entropy.mean()
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    return total, {
        "loss": total, "pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent,
        "approx_kl": ((ratio - 1) - jnp.log(ratio)).mean(),
    }


def train_step(env, env_params, cfg: RPPOConfig, ts: TrainState,
               bstate: BatchState, h: jax.Array, key: jax.Array):
    """One recurrent-PPO iteration; pure and jittable."""
    continuous = env.config.scheme == "continuous"
    assert cfg.num_envs % cfg.num_minibatches == 0
    k_roll, k_perm = jax.random.split(key)
    bstate, obs_last, h_last, h_start, traj, last_value = collect_rollout(
        env, env_params, cfg, ts, bstate, h, k_roll
    )
    advantages, returns = compute_gae(cfg, traj, last_value)
    mb_envs = cfg.num_envs // cfg.num_minibatches

    def epoch(ts, ep_key):
        perm = jax.random.permutation(ep_key, cfg.num_envs)

        def take_envs(x):
            # [T, B, ...] -> [M, T, B_mb, ...] minibatches along the env axis
            g = jnp.take(x, perm, axis=1)
            g = g.reshape(g.shape[:1] + (cfg.num_minibatches, mb_envs) + g.shape[2:])
            return jnp.moveaxis(g, 1, 0)

        mbs = (
            take_envs(traj.obs), take_envs(traj.action), take_envs(traj.done),
            take_envs(traj.logp), take_envs(traj.value),
            take_envs(advantages), take_envs(returns),
            jnp.take(h_start, perm, axis=0).reshape(
                (cfg.num_minibatches, mb_envs, cfg.hidden)
            ),
        )

        def minibatch(ts, mb):
            grad_fn = jax.value_and_grad(
                lambda p: rppo_loss(ts.apply_fn, p, cfg, mb, continuous),
                has_aux=True,
            )
            (_, metrics), grads = grad_fn(ts.params)
            return ts.apply_gradients(grads=grads), metrics

        return jax.lax.scan(minibatch, ts, mbs)

    ts, metrics = jax.lax.scan(epoch, ts, jax.random.split(k_perm, cfg.epochs))
    metrics = jax.tree.map(lambda x: x.mean(), metrics)

    done_f = traj.done.astype(jnp.float32)
    n_done = done_f.sum()
    metrics["episode_return"] = jnp.where(
        n_done > 0, (traj.episode_return * done_f).sum() / jnp.maximum(n_done, 1),
        jnp.nan,
    )
    return ts, bstate, h_last, metrics


def train(env: Env, cfg: RPPOConfig, iterations: int = 32, seed: int = 0,
          env_params: Optional[EnvParams] = None):
    """Host loop over the jitted recurrent-PPO iteration."""
    if env_params is None:
        env_params = env.params()
    key = jax.random.key(seed)
    key, k_init = jax.random.split(key)
    ts = make_rppo_state(env, cfg, k_init)
    bstate = batched_reset(env, env_params, cfg.num_envs)
    h = init_hidden(cfg, cfg.num_envs)
    step = jax.jit(lambda t, b, hh, k: train_step(env, env_params, cfg, t, b, hh, k))
    history = []
    for _ in range(iterations):
        key, sub = jax.random.split(key)
        ts, bstate, h, metrics = step(ts, bstate, h, sub)
        history.append(metrics)
    history = jax.tree.map(lambda *xs: jnp.stack(xs), *history) if history else {}
    return ts, history


class RecurrentPPOPolicy:
    """sb3-style .predict; the state slot carries the GRU hidden."""

    def __init__(self, env: Env, ts: TrainState, cfg: RPPOConfig):
        self.env = env
        self.ts = ts
        self.cfg = cfg
        continuous = env.config.scheme == "continuous"

        def act(obs, h):
            dist, _, h_next = ts.apply_fn(ts.params, obs, h)
            if continuous:
                return dist[0], h_next  # deterministic mean
            return jnp.argmax(dist[0], axis=-1).astype(jnp.int32), h_next

        self._act = jax.jit(act)

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        del deterministic
        obs = jnp.asarray(obs, jnp.float32)
        B = obs.shape[0]
        h = (
            init_hidden(self.cfg, B)
            if state is None else jnp.asarray(state, jnp.float32)
        )
        if episode_start is not None:
            h = jnp.where(jnp.asarray(episode_start, bool)[:, None],
                          jnp.zeros_like(h), h)
        action, h = self._act(obs, h)
        return np.asarray(action), np.asarray(h)
