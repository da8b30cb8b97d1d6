"""PPO learner co-located with the batched env engine — one jitted program.

The reference trains via external stable-baselines3, crossing the
Python<->torch<->NumPy boundary every step (reference: README usage +
SURVEY.md §3.5; reconstructed). Here the whole iteration — rollout
(policy forward + env step + trajectory buffers), GAE, and the clipped PPO
update over minibatch epochs — is a single jitted function built from three
pieces (``collect_rollout``, ``build_batch``, ``update``), with no host
round-trips (BASELINE.json north star). On a mesh, env instances shard over
the "envs" axis while parameters stay replicated. XLA then runs the rollout
sharded, all-gathers the trajectory for the global shuffle, and runs the
minibatch update on every device.

The actor-critic is a plain-JAX MLP (``ActorCritic``): two tanh layers per
head, batched as [num_envs, obs] x [obs, hidden] matmuls.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gym_fishing_tpu.agents.train_state import TrainState
from gym_fishing_tpu.batch import BatchState, batched_reset, batched_step
from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams

# Adam as stable-baselines3's PPO configures it (eps=1e-5, not optax's 1e-8).
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 1024
    num_steps: int = 128          # rollout length per iteration
    epochs: int = 4
    num_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    hidden: int = 64
    anneal_lr: bool = False
    total_iterations: int = 64    # used only for lr annealing
    # 'bfloat16' runs the hidden-layer matmuls in bf16 (f32 params, f32
    # heads/loss). Speed on the H100: not measured.
    compute_dtype: str = "float32"
    # 'exact': fresh jax.random.permutation per epoch (a full sort).
    # 'affine': index bijection i -> (a*i+b) mod N with random odd a (N a
    # power of two), computed on the fly — an O(1)-state shuffle whose
    # minibatches are strided samples across the (time, env) buffer; envs
    # are iid so the mixing loss is negligible.
    shuffle: str = "exact"


# ----------------------------------------------------------------- network
def _dense_init(key, n_in: int, n_out: int, scale: float):
    return {
        "kernel": jax.nn.initializers.orthogonal(scale)(
            key, (n_in, n_out), jnp.float32
        ),
        "bias": jnp.zeros((n_out,), jnp.float32),
    }


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    """Shared-nothing actor + critic MLPs (sb3 MlpPolicy shape).

    Parameters live in ``{"params": {name: {"kernel", "bias"}, "log_std"}}``
    with layers ``pi_d1, pi_d2, v_d1, v_d2, v_out`` and the head ``pi_mean``
    (continuous, plus a state-independent ``log_std``) or ``pi_logits``
    (discrete). Orthogonal init with gains sqrt(2) (hidden), 1.0 (value)
    and 0.01 (policy head); zero biases. Hidden layers compute in
    ``compute_dtype``; the heads stay float32, because action means, values
    and logits feed log-probs and the loss, where bf16 resolution would bite.

    ``precision`` of the matmuls: "highest" is true float32 on every backend
    (a GPU and a CPU run of one iteration agree to rounding). "default" lets
    XLA:GPU use TF32, which at hidden 64 saved no time on an H100 (41.8 ms
    per BASELINE config-5 iteration either way) and moved the result.
    """

    action_dim: int
    continuous: bool
    hidden: int = 64
    compute_dtype: Any = jnp.float32
    precision: str = "highest"

    def _layers(self, obs_dim: int):
        h, s2 = self.hidden, float(np.sqrt(2.0))
        head = "pi_mean" if self.continuous else "pi_logits"
        return (
            ("pi_d1", obs_dim, h, s2), ("pi_d2", h, h, s2),
            ("v_d1", obs_dim, h, s2), ("v_d2", h, h, s2),
            ("v_out", h, 1, 1.0), (head, h, self.action_dim, 0.01),
        )

    def init(self, key, obs):
        layers = self._layers(obs.shape[-1])
        keys = jax.random.split(key, len(layers))
        params = {
            name: _dense_init(k, n_in, n_out, scale)
            for k, (name, n_in, n_out, scale) in zip(keys, layers)
        }
        if self.continuous:
            params["log_std"] = jnp.zeros((self.action_dim,), jnp.float32)
        return {"params": params}

    def apply(self, variables, obs):
        p = variables["params"]

        def dense(x, name, dtype):
            w = p[name]
            y = jnp.dot(x.astype(dtype), w["kernel"].astype(dtype),
                        precision=self.precision)
            return y + w["bias"].astype(dtype)

        def mlp(x, name):
            x = jnp.tanh(dense(x, f"{name}_d1", self.compute_dtype))
            return jnp.tanh(dense(x, f"{name}_d2", self.compute_dtype))

        pi = mlp(obs, "pi").astype(jnp.float32)
        v = mlp(obs, "v").astype(jnp.float32)
        value = dense(v, "v_out", jnp.float32)[..., 0]
        if self.continuous:
            return (dense(pi, "pi_mean", jnp.float32), p["log_std"]), value
        return (dense(pi, "pi_logits", jnp.float32),), value


# ----------------------------------------------------------------- dists
def sample_action(dist, key, continuous: bool):
    if continuous:
        mean, log_std = dist
        noise = jax.random.normal(key, mean.shape, mean.dtype)
        action = mean + jnp.exp(log_std) * noise
        logp = _normal_logp(action, mean, log_std)
        return action, logp
    (logits,) = dist
    action = jax.random.categorical(key, logits)
    logp = jax.nn.log_softmax(logits)[
        jnp.arange(logits.shape[0]), action
    ]
    return action, logp


def action_logp_entropy(dist, action, continuous: bool):
    if continuous:
        mean, log_std = dist
        logp = _normal_logp(action, mean, log_std)
        ent = jnp.sum(log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e), axis=-1)
        ent = jnp.broadcast_to(ent, logp.shape)
        return logp, ent
    (logits,) = dist
    logps = jax.nn.log_softmax(logits)
    logp = jnp.take_along_axis(logps, action[..., None], axis=-1)[..., 0]
    probs = jax.nn.softmax(logits)
    ent = -jnp.sum(probs * logps, axis=-1)
    return logp, ent


def _normal_logp(x, mean, log_std):
    var = jnp.exp(2 * log_std)
    return jnp.sum(
        -0.5 * ((x - mean) ** 2 / var + 2 * log_std + jnp.log(2 * jnp.pi)), axis=-1
    )


# ----------------------------------------------------------------- setup
def make_network(env: Env, cfg) -> ActorCritic:
    """The actor-critic for ``env`` from a PPOConfig or A2CConfig."""
    continuous = env.config.scheme == "continuous"
    return ActorCritic(
        action_dim=1 if continuous else env.config.n_actions,
        continuous=continuous,
        hidden=cfg.hidden,
        compute_dtype=jnp.dtype(cfg.compute_dtype),
    )


def make_train_state(
    env: Env, cfg: PPOConfig, key: jax.Array, params: Optional[EnvParams] = None
) -> TrainState:
    net = make_network(env, cfg)
    obs_dim = env.observation_space.shape[0]
    net_params = net.init(key, jnp.zeros((1, obs_dim), jnp.float32))
    if cfg.anneal_lr:
        total_updates = cfg.total_iterations * cfg.epochs * cfg.num_minibatches
        schedule = optax.linear_schedule(cfg.lr, 0.0, total_updates)
    else:
        schedule = cfg.lr
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(schedule, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS),
    )
    return TrainState.create(apply_fn=net.apply, params=net_params, tx=tx)


# ------------------------------------------------------------- rollout
@dataclasses.dataclass(frozen=True)
class Transition:
    obs: Any
    action: Any
    logp: Any
    value: Any
    reward: Any
    done: Any
    episode_return: Any
    episode_length: Any


jax.tree_util.register_dataclass(Transition)


def collect_rollout(
    env: Env,
    env_params: EnvParams,
    cfg: PPOConfig,
    ts: TrainState,
    bstate: BatchState,
    key: jax.Array,
):
    """lax.scan rollout of cfg.num_steps with the current policy."""
    continuous = env.config.scheme == "continuous"

    def body(carry, step_key):
        bstate, obs = carry
        k_act, k_env = jax.random.split(step_key)
        dist, value = ts.apply_fn(ts.params, obs)
        action, logp = sample_action(dist, k_act, continuous)
        env_action = action if continuous else action.astype(jnp.int32)
        bstate2, rs = batched_step(env, env_params, bstate, env_action, k_env)
        # Cast env outputs to the learner dtype (env may run f64 in tests).
        tr = Transition(
            obs=obs,
            action=action,
            logp=logp,
            value=value,
            reward=rs.reward.astype(jnp.float32),
            done=rs.done,
            episode_return=rs.episode_return.astype(jnp.float32),
            episode_length=rs.episode_length,
        )
        return (bstate2, rs.obs.astype(jnp.float32)), tr

    obs0 = jax.vmap(env.get_obs, in_axes=(None, 0))(env_params, bstate.env)
    obs0 = obs0.astype(jnp.float32)
    keys = jax.random.split(key, cfg.num_steps)
    (bstate, obs_last), traj = jax.lax.scan(body, (bstate, obs0), keys)
    _, last_value = ts.apply_fn(ts.params, obs_last)
    return bstate, obs_last, traj, last_value


def compute_gae(cfg: PPOConfig, traj: Transition, last_value):
    """Reverse-scan GAE over the time axis."""

    def body(carry, tr):
        gae, next_value = carry
        nonterminal = 1.0 - tr.done.astype(jnp.float32)
        delta = tr.reward + cfg.gamma * next_value * nonterminal - tr.value
        gae = delta + cfg.gamma * cfg.gae_lambda * nonterminal * gae
        return (gae, tr.value), gae

    (_, _), advantages = jax.lax.scan(
        body, (jnp.zeros_like(last_value), last_value), traj, reverse=True
    )
    returns = advantages + traj.value
    return advantages, returns


# Columns of the packed sample matrix after obs and action.
PACKED_TAIL = ("logp", "value", "advantage", "return")


def build_batch(cfg: PPOConfig, traj: Transition, last_value):
    """GAE, then one [T*B, C] sample matrix: obs | action | PACKED_TAIL.

    Flattening [T, B] time-major and packing every per-sample field into one
    matrix lets a single row-gather shuffle the whole dataset. Discrete
    actions ride as f32 (exact for small n_actions) and are cast back by
    ``unpack``.
    """
    advantages, returns = compute_gae(cfg, traj, last_value)

    def fl2(x):
        x = x.reshape((-1,) + x.shape[2:])
        return x[:, None] if x.ndim == 1 else x

    return jnp.concatenate(
        [fl2(traj.obs), fl2(traj.action.astype(jnp.float32)), fl2(traj.logp),
         fl2(traj.value), fl2(advantages), fl2(returns)],
        axis=1,
    )


def unpack(mb, obs_dim: int, continuous: bool):
    """Split rows of the packed matrix into the ``ppo_loss`` batch tuple."""
    act_dim = mb.shape[1] - obs_dim - len(PACKED_TAIL)
    obs = mb[:, :obs_dim]
    action = mb[:, obs_dim:obs_dim + act_dim]
    if not continuous:
        action = action[:, 0].astype(jnp.int32)
    rest = mb[:, obs_dim + act_dim:]
    return obs, action, rest[:, 0], rest[:, 1], rest[:, 2], rest[:, 3]


def make_perm(cfg: PPOConfig, batch_size: int, key: jax.Array):
    """A permutation of [0, batch_size) for one epoch (``cfg.shuffle``)."""
    if cfg.shuffle == "affine":
        # the bijection i -> (a*i+b) mod N, N a power of two and a odd
        # (units of Z/2^k are exactly the odd residues). O(1) state, no
        # sort. uint32 wraparound is exact because N divides 2^32.
        assert batch_size & (batch_size - 1) == 0, (
            "shuffle='affine' needs num_envs*num_steps to be a power of 2"
        )
        ka, kb = jax.random.split(key)
        a = jax.random.randint(ka, (), 0, batch_size // 2).astype(
            jnp.uint32) * 2 + 1
        b = jax.random.randint(kb, (), 0, batch_size).astype(jnp.uint32)
        i = jax.lax.iota(jnp.uint32, batch_size)
        return (a * i + b) & jnp.uint32(batch_size - 1)
    return jax.random.permutation(key, batch_size)


# --------------------------------------------------------------- update
def ppo_loss(net_apply, params, cfg: PPOConfig, batch, continuous: bool):
    obs, action, old_logp, old_value, adv, ret = batch
    dist, value = net_apply(params, obs)
    logp, entropy = action_logp_entropy(dist, action, continuous)
    ratio = jnp.exp(logp - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg1 = ratio * adv_n
    pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pg_loss = -jnp.minimum(pg1, pg2).mean()
    v_clipped = old_value + jnp.clip(value - old_value, -cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * jnp.maximum(
        (value - ret) ** 2, (v_clipped - ret) ** 2
    ).mean()
    ent = entropy.mean()
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    approx_kl = ((ratio - 1) - jnp.log(ratio)).mean()
    return total, {
        "loss": total,
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": ent,
        "approx_kl": approx_kl,
    }


def update(
    cfg: PPOConfig,
    ts: TrainState,
    packed,
    key: jax.Array,
    obs_dim: int,
    continuous: bool,
):
    """cfg.epochs of shuffled minibatch SGD over the packed sample matrix.

    Returns the new TrainState and the per-minibatch loss metrics, each of
    shape [epochs, num_minibatches].
    """
    batch_size = packed.shape[0]
    mb_size = batch_size // cfg.num_minibatches

    def epoch(ts, ep_key):
        shuffled = jnp.take(
            packed, make_perm(cfg, batch_size, ep_key), axis=0
        ).reshape((cfg.num_minibatches, mb_size, packed.shape[1]))

        def minibatch(ts, mb):
            grad_fn = jax.value_and_grad(
                lambda p: ppo_loss(
                    ts.apply_fn, p, cfg, unpack(mb, obs_dim, continuous),
                    continuous,
                ),
                has_aux=True,
            )
            (_, metrics), grads = grad_fn(ts.params)
            return ts.apply_gradients(grads=grads), metrics

        return jax.lax.scan(minibatch, ts, shuffled)

    return jax.lax.scan(epoch, ts, jax.random.split(key, cfg.epochs))


def episode_metrics(traj: Transition):
    """Mean return and length of the episodes that ended in ``traj``."""
    done_f = traj.done.astype(jnp.float32)
    n_done = done_f.sum()
    denom = jnp.maximum(n_done, 1)
    return {
        "episode_return": jnp.where(
            n_done > 0, (traj.episode_return * done_f).sum() / denom, jnp.nan
        ),
        "episode_length": jnp.where(
            n_done > 0,
            (traj.episode_length.astype(jnp.float32) * done_f).sum() / denom,
            jnp.nan,
        ),
        "mean_reward": traj.reward.mean(),
    }


def train_step(
    env: Env,
    env_params: EnvParams,
    cfg: PPOConfig,
    ts: TrainState,
    bstate: BatchState,
    key: jax.Array,
):
    """One full PPO iteration (rollout + GAE + epochs of minibatch SGD).

    Pure and jittable; under a mesh, shard `bstate` on the "envs" axis and
    replicate `ts` — XLA inserts the collectives.
    """
    continuous = env.config.scheme == "continuous"
    k_roll, k_perm = jax.random.split(key)
    bstate, _, traj, last_value = collect_rollout(
        env, env_params, cfg, ts, bstate, k_roll
    )
    packed = build_batch(cfg, traj, last_value)
    ts, metrics = update(
        cfg, ts, packed, k_perm, env.observation_space.shape[0], continuous
    )
    metrics = jax.tree.map(lambda x: x.mean(), metrics)
    metrics.update(episode_metrics(traj))
    return ts, bstate, metrics


def train(
    env: Env,
    cfg: PPOConfig,
    seed: int = 0,
    iterations: int = 32,
    env_params: Optional[EnvParams] = None,
    verbose: bool = False,
):
    """Host loop over jitted train_step (single-device convenience API)."""
    if env_params is None:
        env_params = env.params()
    key = jax.random.key(seed)
    key, k_init = jax.random.split(key)
    ts = make_train_state(env, cfg, k_init)
    bstate = batched_reset(env, env_params, cfg.num_envs)
    step = jax.jit(partial(train_step, env, env_params, cfg))
    history = []
    for it in range(iterations):
        key, sub = jax.random.split(key)
        ts, bstate, metrics = step(ts, bstate, sub)
        history.append({k: float(v) for k, v in metrics.items()})
        if verbose:
            print(f"iter {it}: {history[-1]}")
    return ts, history


class PPOPolicy:
    """sb3-style .predict wrapper over a trained TrainState (for simulate)."""

    def __init__(self, env: Env, ts: TrainState):
        self.env = env
        self.ts = ts
        self.continuous = env.config.scheme == "continuous"

    def act(self, obs, carried_harvest=None):
        dist, _ = self.ts.apply_fn(self.ts.params, obs.astype(jnp.float32))
        if self.continuous:
            return dist[0]  # mean action
        return jnp.argmax(dist[0], axis=-1).astype(jnp.int32)

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        a = self.act(jnp.asarray(obs))
        return np.asarray(a), state
