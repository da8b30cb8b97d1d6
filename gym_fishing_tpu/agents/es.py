"""OpenAI-style Evolution Strategies learner — a batched black-box trainer.

No reference counterpart (the reference trains only via external sb3,
SURVEY.md §3.5); this learner exists because ES is the algorithm the
vectorized engine is *best* shaped for: a population of antithetic
parameter perturbations, each evaluated by full-episode rollouts, is one
giant `[pop, envs_per_member]` vmap — pure batched matmuls and fused env
steps, zero sample-correlation machinery, one gradient-free update per
generation (Salimans et al. 2017, "Evolution Strategies as a Scalable
Alternative to Reinforcement Learning"; PAPERS.md).

The whole generation — perturbation sampling, population rollout, centered-
rank fitness shaping, gradient estimate, Adam update — is one jitted
program. On a mesh, shard the population over the "envs" axis; parameters
are replicated and the per-leaf `eps^T @ shaped_fitness` contraction is the
only all-reduce.

Caveat: on the bistable May tipping-point env the sustainable-harvest region
is a sliver of action space (measured: every constant quota above ~2.5% of K
collapses the stock for the default params, and all collapse policies earn
identical fitness ≈ the initial biomass), so rank-based ES gets no gradient
signal out of the deceptive optimum. Use the exact DP solver (agents/dp.py)
or PPO/escapement there; ES reaches near-optimal returns on the logistic
envs (test_es.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gym_fishing_tpu.agents._flax import nn
from gym_fishing_tpu.agents.train_state import TrainState
from gym_fishing_tpu.batch import batched_reset, batched_step
from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams


@dataclasses.dataclass(frozen=True)
class ESConfig:
    pop_size: int = 256           # must be even (antithetic pairs)
    envs_per_member: int = 4      # rollouts averaged per perturbation
    sigma: float = 0.05           # perturbation scale
    lr: float = 0.02
    weight_decay: float = 0.005   # L2 pull toward 0 (Salimans et al.)
    rank_shaping: bool = True     # centered ranks in [-0.5, 0.5]
    hidden: int = 32
    episode_len: Optional[int] = None  # default: int(params.Tmax)

    def __post_init__(self):
        if self.pop_size % 2 != 0:
            raise ValueError("pop_size must be even for antithetic sampling")


class DeterministicPolicy(nn.Module):
    """Small tanh MLP; ES needs no value head and no action distribution."""

    action_dim: int
    continuous: bool
    hidden: int = 32

    @nn.compact
    def __call__(self, obs):
        x = nn.tanh(nn.Dense(self.hidden, name="d1")(obs))
        x = nn.tanh(nn.Dense(self.hidden, name="d2")(x))
        out = nn.Dense(self.action_dim, name="out",
                       kernel_init=nn.initializers.orthogonal(0.01))(x)
        if self.continuous:
            return out  # env clips to its Box, same convention as PPO's mean
        return out      # logits; argmax at act time


def make_es_state(
    env: Env, cfg: ESConfig, key: jax.Array, params: Optional[EnvParams] = None
) -> TrainState:
    continuous = env.config.scheme == "continuous"
    action_dim = 1 if continuous else env.config.n_actions
    net = DeterministicPolicy(action_dim=action_dim, continuous=continuous,
                              hidden=cfg.hidden)
    obs_dim = env.observation_space.shape[0]
    net_params = net.init(key, jnp.zeros((1, obs_dim), jnp.float32))
    tx = optax.chain(
        optax.add_decayed_weights(cfg.weight_decay),
        optax.adam(cfg.lr),
    )
    return TrainState.create(apply_fn=net.apply, params=net_params, tx=tx)


def _centered_ranks(fitness):
    """Map fitness to evenly spaced values in [-0.5, 0.5] by rank."""
    n = fitness.shape[0]
    ranks = jnp.argsort(jnp.argsort(fitness))
    return ranks.astype(jnp.float32) / (n - 1) - 0.5


def _episode_returns(env, env_params, apply_fn, member_params, continuous,
                     steps, num_envs, key):
    """Mean first-episode return of one policy over `num_envs` rollouts.

    Fixed-length scan of `steps` with an alive mask (no data-dependent
    control flow): rewards stop accumulating at the first done.
    """
    k_reset, k_roll = jax.random.split(key)
    bstate = batched_reset(env, env_params, num_envs)
    obs0 = jax.vmap(env.get_obs, in_axes=(None, 0))(env_params, bstate.env)

    def body(carry, step_key):
        bstate, obs, alive, acc = carry
        out = apply_fn(member_params, obs.astype(jnp.float32))
        if continuous:
            action = out
        else:
            action = jnp.argmax(out, axis=-1).astype(jnp.int32)
        bstate2, rs = batched_step(env, env_params, bstate, action, step_key)
        acc = acc + rs.reward.astype(jnp.float32) * alive
        alive = alive * (1.0 - rs.done.astype(jnp.float32))
        return (bstate2, rs.obs, alive, acc), None

    alive0 = jnp.ones((num_envs,), jnp.float32)
    acc0 = jnp.zeros((num_envs,), jnp.float32)
    keys = jax.random.split(k_roll, steps)
    (_, _, _, acc), _ = jax.lax.scan(body, (bstate, obs0, alive0, acc0), keys)
    return acc.mean()


def es_train_step(
    env: Env,
    env_params: EnvParams,
    cfg: ESConfig,
    steps: int,
    ts: TrainState,
    key: jax.Array,
):
    """One ES generation. Pure and jittable; `steps` is the static horizon."""
    continuous = env.config.scheme == "continuous"
    k_eps, k_eval = jax.random.split(key)

    # Antithetic perturbations: one normal draw per parameter leaf for the
    # first half of the population, mirrored for the second half.
    leaves, treedef = jax.tree.flatten(ts.params)
    leaf_keys = jax.random.split(k_eps, len(leaves))
    half = cfg.pop_size // 2
    eps_leaves = [
        jax.random.normal(k, (half,) + l.shape, jnp.float32)
        for k, l in zip(leaf_keys, leaves)
    ]
    eps_leaves = [jnp.concatenate([e, -e], axis=0) for e in eps_leaves]
    eps = jax.tree.unflatten(treedef, eps_leaves)
    pop_params = jax.tree.map(
        lambda p, e: p[None] + cfg.sigma * e.astype(p.dtype), ts.params, eps
    )

    eval_keys = jax.random.split(k_eval, cfg.pop_size)
    fitness = jax.vmap(
        lambda mp, k: _episode_returns(
            env, env_params, ts.apply_fn, mp, continuous,
            steps, cfg.envs_per_member, k,
        )
    )(pop_params, eval_keys)

    shaped = _centered_ranks(fitness) if cfg.rank_shaping else (
        (fitness - fitness.mean()) / (fitness.std() + 1e-8)
    )
    # Gradient ASCENT estimate g = E[shaped * eps] / sigma; Adam minimizes,
    # so feed -g.
    grads = jax.tree.map(
        lambda e: -(jnp.tensordot(shaped, e, axes=1)
                    / (cfg.pop_size * cfg.sigma)).astype(jnp.float32),
        eps,
    )
    ts = ts.apply_gradients(grads=grads)
    metrics = {
        "fitness_mean": fitness.mean(),
        "fitness_max": fitness.max(),
        "fitness_std": fitness.std(),
    }
    return ts, metrics


def es_train(
    env: Env,
    cfg: ESConfig,
    seed: int = 0,
    generations: int = 50,
    env_params: Optional[EnvParams] = None,
    verbose: bool = False,
):
    """Host loop over the jitted ES generation (single-device convenience API)."""
    if env_params is None:
        env_params = env.params()
    steps = cfg.episode_len or int(np.asarray(env_params.Tmax))
    key = jax.random.key(seed)
    key, k_init = jax.random.split(key)
    ts = make_es_state(env, cfg, k_init)
    step = jax.jit(partial(es_train_step, env, env_params, cfg, steps))
    history = []
    for gen in range(generations):
        key, sub = jax.random.split(key)
        ts, metrics = step(ts, sub)
        history.append({k: float(v) for k, v in metrics.items()})
        if verbose:
            print(f"gen {gen}: {history[-1]}")
    return ts, history


class ESPolicy:
    """sb3-style .predict wrapper over the trained deterministic policy."""

    def __init__(self, env: Env, ts: TrainState):
        self.env = env
        self.ts = ts
        self.continuous = env.config.scheme == "continuous"

    def act(self, obs, carried_harvest=None):
        out = self.ts.apply_fn(self.ts.params, obs.astype(jnp.float32))
        if self.continuous:
            return out
        return jnp.argmax(out, axis=-1).astype(jnp.int32)

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        a = self.act(jnp.asarray(obs))
        return np.asarray(a), state
