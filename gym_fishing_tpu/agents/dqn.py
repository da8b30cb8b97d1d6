"""Double-DQN learner for the discrete-action envs (fishing-v0 family).

The reference trains its discrete envs with external value-based learners
(stable-baselines3 DQN in the repo's README/notebook usage; reference:
gym_fishing README, reconstructed). This is the in-framework on-device
equivalent: the whole interact-store-sample-update cycle is one jitted
program over the batched env engine — vectorized epsilon-greedy exploration
across ``num_envs`` lockstep instances, the device-resident replay buffer
shared with SAC/TD3 (``agents/sac.py``), double-Q targets, and soft target
updates. No host round-trips inside the step.

Works with both discrete decode schemes: the 3-action relative scheme
(carried harvest state lives inside the env engine) and the proportional
n-action grid. Under the relative scheme the stock observation alone is
non-Markov — the effective action depends on the carried harvest — so the
Q-network input is the observation augmented with the (scaled) carried
harvest, read from the batched env state on device.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from gym_fishing_tpu.agents._flax import nn
from gym_fishing_tpu.agents.sac import ReplayBuffer, buffer_add, buffer_init, buffer_sample
from gym_fishing_tpu.agents.train_state import TrainState
from gym_fishing_tpu.batch import batched_reset, batched_step
from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    num_envs: int = 256
    buffer_size: int = 1 << 17
    batch_size: int = 4096
    gamma: float = 0.99
    tau: float = 0.01                # soft target-update rate
    lr: float = 3e-4
    hidden: int = 64
    updates_per_step: int = 1
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 2000      # env steps to anneal epsilon over
    double: bool = True              # double-DQN action selection


class QNetwork(nn.Module):
    n_actions: int
    hidden: int = 64

    @nn.compact
    def __call__(self, obs):
        x = nn.relu(nn.Dense(self.hidden)(obs))
        x = nn.relu(nn.Dense(self.hidden)(x))
        return nn.Dense(self.n_actions)(x)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DQNState:
    q: Any                 # TrainState
    target_params: Any
    buffer: ReplayBuffer
    env_state: Any         # BatchState
    obs: Any               # (num_envs, 1) f32
    step: Any              # int32 global env-step counter (for eps anneal)


def make_dqn_state(env: Env, cfg: DQNConfig, key: jax.Array,
                   env_params: Optional[EnvParams] = None) -> DQNState:
    assert env.config.scheme != "continuous", "DQN needs a discrete action space"
    if env_params is None:
        env_params = env.params()
    n_actions = env.config.n_actions
    net = QNetwork(n_actions, cfg.hidden)
    obs_dim = env.observation_space.shape[0] + 1  # + carried-harvest feature
    obs0 = jnp.zeros((1, obs_dim), jnp.float32)
    q = TrainState.create(
        apply_fn=net.apply, params=net.init(key, obs0), tx=optax.adam(cfg.lr)
    )
    bstate = batched_reset(env, env_params, cfg.num_envs)
    obs = jax.vmap(env.get_obs, in_axes=(None, 0))(env_params, bstate.env)
    return DQNState(
        q=q,
        target_params=q.params,
        buffer=buffer_init(cfg.buffer_size, obs_dim=obs_dim, act_dim=1),
        env_state=bstate,
        obs=_augment(env_params, obs, bstate.env.harvest),
        step=jnp.asarray(0, jnp.int32),
    )


def _augment(env_params: EnvParams, obs, harvest):
    """Q-network input: [obs, carried_harvest / K] (Markov for all schemes)."""
    h = (harvest / env_params.K).astype(jnp.float32)
    return jnp.concatenate([obs.astype(jnp.float32), h[:, None]], axis=-1)


def _epsilon(cfg: DQNConfig, step):
    frac = jnp.clip(step.astype(jnp.float32) / cfg.eps_decay_steps, 0.0, 1.0)
    return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)


def dqn_train_step(
    env: Env,
    env_params: EnvParams,
    cfg: DQNConfig,
    state: DQNState,
    key: jax.Array,
) -> Tuple[DQNState, dict]:
    """One batched epsilon-greedy env step + cfg.updates_per_step updates."""
    k_eps, k_rand, k_env, k_upd = jax.random.split(key, 4)
    n_actions = env.config.n_actions

    # ---- interact (vectorized epsilon-greedy)
    qvals = state.q.apply_fn(state.q.params, state.obs)           # (B, A)
    greedy = jnp.argmax(qvals, axis=-1).astype(jnp.int32)
    rand = jax.random.randint(k_rand, greedy.shape, 0, n_actions, jnp.int32)
    explore = jax.random.uniform(k_eps, greedy.shape) < _epsilon(cfg, state.step)
    action = jnp.where(explore, rand, greedy)

    bstate2, rs = batched_step(env, env_params, state.env_state, action, k_env)
    next_obs = _augment(env_params, rs.obs, bstate2.env.harvest)
    # horizon truncation is not a true terminal: bootstrap through Tmax ends
    true_done = rs.done & (rs.episode_length < env_params.Tmax)
    buf = buffer_add(
        state.buffer, state.obs, action[:, None],
        rs.reward, next_obs, true_done,
    )
    state = dataclasses.replace(
        state, buffer=buf, env_state=bstate2, obs=next_obs, step=state.step + 1
    )

    def update(state: DQNState, k):
        obs, act, rew, nobs, done = buffer_sample(state.buffer, k, cfg.batch_size)
        a = act[:, 0].astype(jnp.int32)

        nq_target = state.q.apply_fn(state.target_params, nobs)   # (B, A)
        if cfg.double:
            nq_online = state.q.apply_fn(state.q.params, nobs)
            a_star = jnp.argmax(nq_online, axis=-1)
        else:
            a_star = jnp.argmax(nq_target, axis=-1)
        next_v = jnp.take_along_axis(nq_target, a_star[:, None], axis=-1)[:, 0]
        target = rew + cfg.gamma * (1.0 - done) * next_v

        def loss_fn(p):
            qs = state.q.apply_fn(p, obs)
            q_sa = jnp.take_along_axis(qs, a[:, None], axis=-1)[:, 0]
            return optax.huber_loss(q_sa, jax.lax.stop_gradient(target)).mean()

        loss, grads = jax.value_and_grad(loss_fn)(state.q.params)
        q = state.q.apply_gradients(grads=grads)
        target_params = jax.tree.map(
            lambda t, o: (1 - cfg.tau) * t + cfg.tau * o, state.target_params, q.params
        )
        state = dataclasses.replace(state, q=q, target_params=target_params)
        return state, {"loss": loss}

    state, metrics = jax.lax.scan(update, state, jax.random.split(k_upd, cfg.updates_per_step))
    metrics = jax.tree.map(lambda x: x.mean(), metrics)

    done_f = rs.done.astype(jnp.float32)
    n_done = done_f.sum()
    metrics["episode_return"] = jnp.where(
        n_done > 0,
        (rs.episode_return.astype(jnp.float32) * done_f).sum() / jnp.maximum(n_done, 1),
        jnp.nan,
    )
    metrics["epsilon"] = _epsilon(cfg, state.step)
    return state, metrics


def dqn_train(
    env: Env,
    cfg: DQNConfig,
    steps: int = 1000,
    seed: int = 0,
    env_params: Optional[EnvParams] = None,
    warmup_steps: int = 10,
):
    """Host loop over the jitted DQN step (single-device convenience API)."""
    if env_params is None:
        env_params = env.params()
    key = jax.random.key(seed)
    key, k_init = jax.random.split(key)
    state = make_dqn_state(env, cfg, k_init, env_params)
    step = jax.jit(partial(dqn_train_step, env, env_params, cfg))

    # warmup: fill the buffer with uniform-random transitions (eps=1 region)
    for _ in range(warmup_steps):
        key, k = jax.random.split(key)
        state, _ = step(state, k)

    history = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        state, metrics = step(state, k)
        history.append(metrics)
    history = jax.tree.map(lambda *xs: jnp.stack(xs), *history) if history else {}
    return state, history


class DQNPolicy:
    """Greedy policy over the learned Q-network (sb3 .predict contract).

    The sb3 "recurrent state" slot carries the policy's view of the current
    harvest for the relative scheme (same convention as agents/policies.py).
    """

    def __init__(self, env: Env, state: DQNState,
                 env_params: Optional[EnvParams] = None):
        self.env = env
        self.state = state
        self.params = env_params if env_params is not None else env.params()
        self._act = jax.jit(
            lambda x: jnp.argmax(
                state.q.apply_fn(state.q.params, x), axis=-1
            ).astype(jnp.int32)
        )

    def act(self, obs, carried_harvest=None):
        obs = jnp.asarray(obs, jnp.float32)
        if carried_harvest is None:
            carried_harvest = jnp.full(
                obs.shape[:-1], jnp.asarray(self.params.init_harvest, jnp.float32)
            )
        return self._act(_augment(self.params, obs, carried_harvest))

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        import numpy as np

        del episode_start, deterministic
        obs = jnp.asarray(obs, jnp.float32)
        carried = None if state is None else jnp.asarray(state, jnp.float32)
        action = self.act(obs, carried)
        if self.env.config.scheme == "relative":
            from gym_fishing_tpu.spaces.scaling import decode_action

            base = (
                jnp.full(obs.shape[:-1],
                         jnp.asarray(self.params.init_harvest, jnp.float32))
                if carried is None else carried
            )
            _, new_h = decode_action(self.env.config, self.params, base, action)
            return np.asarray(action), np.asarray(new_h)
        return np.asarray(action), None
