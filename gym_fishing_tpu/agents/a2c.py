"""A2C learner — synchronous advantage actor-critic, one jitted iteration.

The reference ecosystem trains its fishing envs with stable-baselines3
algorithms including A2C (reference: README sb3 usage, SURVEY.md §3.5;
reconstructed). A2C is PPO's simpler ancestor: a single unclipped
policy-gradient + value-regression update on the freshly collected on-policy
batch — no epochs, no minibatch shuffling, no ratio clipping. It therefore
reuses this package's PPO building blocks (ActorCritic network, scan rollout,
reverse-scan GAE) and swaps only the optimizer (RMSProp, sb3's A2C default)
and the update rule. The whole iteration is one jitted program: rollout +
GAE + a single full-batch gradient step, no host round-trips.

On a mesh, shard the env batch over the "envs" axis and replicate parameters;
the single gradient all-reduce per iteration is the only cross-device
communication (cheaper even than PPO's epochs×minibatches all-reduces).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import optax

from gym_fishing_tpu.agents.ppo import (
    PPOPolicy,
    action_logp_entropy,
    collect_rollout,
    compute_gae,
    episode_metrics,
    make_network,
)
from gym_fishing_tpu.agents.train_state import TrainState
from gym_fishing_tpu.batch import batched_reset
from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    num_envs: int = 1024
    num_steps: int = 16           # sb3 A2C n_steps=5 per env; batched here
    gamma: float = 0.99
    gae_lambda: float = 1.0       # sb3 A2C default: plain returns
    lr: float = 7e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    hidden: int = 64
    normalize_advantage: bool = False  # sb3 A2C default (unlike PPO)
    compute_dtype: str = "float32"


def make_a2c_state(
    env: Env, cfg: A2CConfig, key: jax.Array, params: Optional[EnvParams] = None
) -> TrainState:
    net = make_network(env, cfg)
    obs_dim = env.observation_space.shape[0]
    net_params = net.init(key, jnp.zeros((1, obs_dim), jnp.float32))
    # sb3 A2C uses TF-style RMSProp (alpha=0.99, eps=1e-5, no momentum)
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.rmsprop(cfg.lr, decay=0.99, eps=1e-5),
    )
    return TrainState.create(apply_fn=net.apply, params=net_params, tx=tx)


def a2c_loss(net_apply, params, cfg: A2CConfig, batch, continuous: bool):
    obs, action, adv, ret = batch
    dist, value = net_apply(params, obs)
    logp, entropy = action_logp_entropy(dist, action, continuous)
    if cfg.normalize_advantage:
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg_loss = -(logp * adv).mean()          # unclipped policy gradient
    v_loss = 0.5 * ((value - ret) ** 2).mean()
    ent = entropy.mean()
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    return total, {
        "loss": total,
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": ent,
    }


def a2c_train_step(
    env: Env,
    env_params: EnvParams,
    cfg: A2CConfig,
    ts: TrainState,
    bstate,
    key: jax.Array,
):
    """One A2C iteration: rollout + GAE + ONE full-batch gradient step.

    Pure and jittable. collect_rollout/compute_gae are shared with PPO
    (they read only num_steps/gamma/gae_lambda off the config).
    """
    continuous = env.config.scheme == "continuous"
    bstate, _, traj, last_value = collect_rollout(
        env, env_params, cfg, ts, bstate, key
    )
    advantages, returns = compute_gae(cfg, traj, last_value)

    def fl(x):
        return x.reshape((-1,) + x.shape[2:])

    batch = (fl(traj.obs), fl(traj.action), fl(advantages), fl(returns))
    grad_fn = jax.value_and_grad(
        lambda p: a2c_loss(ts.apply_fn, p, cfg, batch, continuous), has_aux=True
    )
    (_, metrics), grads = grad_fn(ts.params)
    ts = ts.apply_gradients(grads=grads)
    metrics.update(episode_metrics(traj))
    return ts, bstate, metrics


def a2c_train(
    env: Env,
    cfg: A2CConfig,
    seed: int = 0,
    iterations: int = 32,
    env_params: Optional[EnvParams] = None,
    verbose: bool = False,
):
    """Host loop over the jitted A2C step (single-device convenience API)."""
    if env_params is None:
        env_params = env.params()
    key = jax.random.key(seed)
    key, k_init = jax.random.split(key)
    ts = make_a2c_state(env, cfg, k_init)
    bstate = batched_reset(env, env_params, cfg.num_envs)
    step = jax.jit(partial(a2c_train_step, env, env_params, cfg))
    history = []
    for it in range(iterations):
        key, sub = jax.random.split(key)
        ts, bstate, metrics = step(ts, bstate, sub)
        history.append({k: float(v) for k, v in metrics.items()})
        if verbose:
            print(f"iter {it}: {history[-1]}")
    return ts, history


# Same network + TrainState as PPO, so the predict wrapper is shared.
A2CPolicy = PPOPolicy
