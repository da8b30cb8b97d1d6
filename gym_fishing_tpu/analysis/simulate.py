"""Evaluation helpers: rollouts -> tidy DataFrames, policy-function estimation.

Reference parity: gym_fishing/envs/shared_env.py `simulate_mdp(env, model,
reps)` and `estimate_policyfn(env, model, reps, n)` (reconstructed — SURVEY.md
§2.1 Ly / §3.4). Output schema matches the reference's tidy format:
columns ``[time, state, action, reward, rep]`` (state is the *unscaled*
stock; action is the raw env action).

On-device twist: instead of a per-step Python loop over one env, all `reps`
run as a vmapped batch; if the model exposes a pure ``act`` function (our
baseline policies do) the whole simulation is one jitted lax.scan and only the
final trajectory buffer crosses to the host. Models exposing only `.predict`
(e.g. sb3) fall back to a host-stepped loop that still batches the env.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from gym_fishing_tpu.batch import batched_reset, batched_step
from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvParams
from gym_fishing_tpu.spaces.scaling import stock_from_obs


def _traj_to_df(env, params, obs, actions, rewards, Tmax: int, reps: int) -> pd.DataFrame:
    """Stacked [T, reps, ...] arrays -> tidy long DataFrame."""
    obs = jnp.asarray(obs)
    if obs.shape[-1] > 1:
        # windowed observations (ObsStackEnv): latest entry is current
        obs = obs[..., -1:]
    stock = np.asarray(stock_from_obs(params, obs))  # [T, reps]
    actions = np.asarray(actions)
    if actions.ndim == 3:  # continuous (T, reps, 1)
        actions = actions[..., 0]
    rewards = np.asarray(rewards)
    T = stock.shape[0]
    time = np.tile(np.arange(T)[:, None], (1, reps))
    rep = np.tile(np.arange(reps)[None, :], (T, 1))
    return pd.DataFrame(
        {
            "time": time.ravel(order="F"),
            "state": stock.ravel(order="F"),
            "action": actions.ravel(order="F"),
            "reward": rewards.ravel(order="F"),
            "rep": rep.ravel(order="F"),
        }
    )


def simulate_mdp(
    env: Env,
    model: Any,
    reps: int = 1,
    params: Optional[EnvParams] = None,
    seed: int = 0,
) -> pd.DataFrame:
    """Roll `reps` episodes of `model` in `env`; return a tidy DataFrame.

    `model` is anything with `.predict(obs, state=...) -> (action, state)`
    (sb3 or gym_fishing_tpu.agents policies). Pure-`act` models take the
    fully-fused on-device path.
    """
    if params is None:
        params = env.params()
    Tmax = int(np.asarray(params.Tmax))
    key = jax.random.key(seed)

    if hasattr(model, "act"):
        return _simulate_fused(env, model, reps, params, Tmax, key)

    # Host-stepped fallback (sb3-style models): batched env, python policy.
    state = batched_reset(env, params, reps)
    obs = np.asarray(jax.vmap(env.get_obs, in_axes=(None, 0))(params, state.env))
    pstate = None
    step = jax.jit(
        lambda s, a, k: batched_step(env, params, s, a, k, autoreset=False)
    )
    obs_l, act_l, rew_l = [], [], []
    for t in range(Tmax):
        action, pstate = model.predict(obs, state=pstate)
        key, sub = jax.random.split(key)
        a_dev = jnp.asarray(action)
        if env.config.scheme != "continuous":
            a_dev = a_dev.astype(jnp.int32)
        state, ts = step(state, a_dev, sub)
        obs_l.append(obs)
        act_l.append(np.asarray(action))
        rew_l.append(np.asarray(ts.reward))
        obs = np.asarray(ts.obs)
    return _traj_to_df(env, params, np.stack(obs_l), np.stack(act_l), np.stack(rew_l), Tmax, reps)


def _simulate_fused(env, model, reps, params, Tmax, key):
    """One jitted lax.scan for the whole simulation (no host round-trips)."""
    init = batched_reset(env, params, reps)
    if env.config.scheme == "relative":
        h0 = jnp.broadcast_to(jnp.asarray(params.init_harvest, params.dtype), (reps,))
    else:
        h0 = None

    def body(carry, k):
        st, obs, carried = carry
        action = model.act(obs, carried)
        if carried is not None:
            from gym_fishing_tpu.spaces.scaling import decode_action

            _, carried = decode_action(env.config, params, carried, action)
        st, ts = batched_step(env, params, st, action, k, autoreset=False)
        return (st, ts.obs, carried), (obs, action, ts.reward)

    obs0 = jax.vmap(env.get_obs, in_axes=(None, 0))(params, init.env)
    keys = jax.random.split(key, Tmax)
    _, (obs, actions, rewards) = jax.lax.scan(body, (init, obs0, h0), keys)
    return _traj_to_df(env, params, obs, actions, rewards, Tmax, reps)


def estimate_policyfn(
    env: Env,
    model: Any,
    reps: int = 1,
    n: int = 50,
    params: Optional[EnvParams] = None,
    harvest: Optional[float] = None,
) -> pd.DataFrame:
    """Evaluate the policy over a grid of states (reference parity).

    Returns tidy columns ``[state, action, rep]`` — the policy's action at
    each of `n` stock levels in [0, 2K], repeated `reps` times (stochastic
    policies vary per rep; closed-form ones don't).

    For the 3-action *relative* decode scheme the policy is a function of
    (stock, carried harvest), not of stock alone; `harvest` fixes the carried
    harvest level the grid is conditioned on (default: params.init_harvest).
    It is passed to `.predict` as the sb3 recurrent `state`, which is how the
    baseline policies carry it. Ignored for the other schemes.
    """
    if params is None:
        params = env.params()
    stocks = np.linspace(0.0, 2.0 * float(np.asarray(params.K)), n)
    obs_grid = np.asarray(
        jnp.clip(jnp.asarray(stocks) / params.K - 1.0, -1.0, 1.0)
    )[:, None]
    pstate0 = None
    if env.config.scheme == "relative":
        h = float(np.asarray(params.init_harvest)) if harvest is None else float(harvest)
        pstate0 = np.full((n,), h, dtype=np.asarray(params.init_harvest).dtype)
    rows = []
    for rep in range(reps):
        action, _ = model.predict(obs_grid, state=pstate0)
        a = np.asarray(action)
        if a.ndim == 2:
            a = a[:, 0]
        rows.append(
            pd.DataFrame({"state": stocks, "action": a, "rep": rep})
        )
    return pd.concat(rows, ignore_index=True)
