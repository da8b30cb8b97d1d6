"""Per-env-id checks of the PPO learner, shared by the split test files.

``check_rollout`` replays ``collect_rollout`` + ``build_batch`` against a
NumPy loop: the float64 oracle steps each env on the rollout's own actions
and noise draws (auto-reset and episode accounting included), the NumPy
actor-critic recomputes values and log-probs, and a reverse loop recomputes
GAE and the packed sample matrix. ``check_train_step`` runs the jitted XLA
``train_step`` twice from one seed: finite, and bitwise deterministic.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import _np_ref
import gym_fishing_tpu as gft
from chip_smoke import oracle_config
from gym_fishing_tpu.agents.ppo import (
    PPOConfig,
    build_batch,
    collect_rollout,
    episode_metrics,
    make_train_state,
    train_step,
)
from gym_fishing_tpu.batch import batched_reset
from gym_fishing_tpu.oracle import oracle as orc

IDS = gft.registered_ids()


def check_rollout(env_id, num_envs=5, num_steps=23, tmax=9, seed=0):
    # float64 env, so the float64 oracle is the reference to rounding of the
    # float32 learner fields; a short horizon forces auto-resets
    env, params = gft.make(env_id, dtype=jnp.float64, Tmax=tmax)
    cfg = PPOConfig(num_envs=num_envs, num_steps=num_steps, hidden=16,
                    gamma=0.97, gae_lambda=0.9)
    continuous = env.config.scheme == "continuous"
    ts = make_train_state(env, cfg, jax.random.key(seed))
    bstate = batched_reset(env, params, num_envs)
    key = jax.random.key(seed + 1)
    _, obs_last, traj, last_value = jax.jit(
        partial(collect_rollout, env, params, cfg))(ts, bstate, key)
    packed = np.asarray(build_batch(cfg, traj, last_value))
    traj, obs_last, last_value = jax.device_get((traj, obs_last, last_value))

    # the draws batched_step made from each step's key
    def draws(k):
        _, k_env = jax.random.split(k)
        return jax.random.normal(k_env, (2, num_envs), jnp.float64)

    noise = np.asarray(jax.vmap(draws)(jax.random.split(key, num_steps)))

    ocfg = oracle_config(env, jax.device_get(params))
    n_done = 0
    for b in range(num_envs):
        st = orc.reset(ocfg)
        obs = orc.get_obs(ocfg, st.stock)
        ep_ret, ep_len = 0.0, 0
        for t in range(num_steps):
            np.testing.assert_allclose(traj.obs[t, b], obs, rtol=1e-6, atol=1e-7)
            a = traj.action[t, b] if continuous else int(traj.action[t, b])
            st, obs, r, done, _ = orc.step_xi(ocfg, st, a, noise[t, 0, b],
                                              noise[t, 1, b])
            ep_ret, ep_len = ep_ret + r, ep_len + 1
            assert bool(traj.done[t, b]) == done, (t, b)
            np.testing.assert_allclose(traj.reward[t, b], r, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(traj.episode_return[t, b], ep_ret,
                                       rtol=1e-6, atol=1e-6)
            assert int(traj.episode_length[t, b]) == ep_len
            if done:
                n_done += 1
                st = orc.reset(ocfg)
                obs = orc.get_obs(ocfg, st.stock)
                ep_ret, ep_len = 0.0, 0
        np.testing.assert_allclose(obs_last[b], obs, rtol=1e-6, atol=1e-7)
    assert n_done >= num_envs * (num_steps // tmax)

    head, log_std, value = _np_ref.forward(ts.params, traj.obs, continuous)
    np.testing.assert_allclose(traj.value, value, atol=2e-5)
    np.testing.assert_allclose(
        traj.logp, _np_ref.logp(head, log_std, traj.action, continuous),
        rtol=1e-5, atol=2e-5)
    _, _, last_ref = _np_ref.forward(ts.params, obs_last, continuous)
    np.testing.assert_allclose(last_value, last_ref, atol=2e-5)

    adv, ret = _np_ref.gae(traj.reward, traj.value, traj.done, last_value,
                           cfg.gamma, cfg.gae_lambda)
    n = num_envs * num_steps
    want = np.concatenate(
        [traj.obs.reshape(n, -1), np.asarray(traj.action, np.float64).reshape(n, -1)]
        + [x.reshape(n, 1) for x in (traj.logp, traj.value, adv, ret)], axis=1)
    assert packed.shape == want.shape and packed.dtype == np.float32
    np.testing.assert_allclose(packed, want, rtol=1e-5, atol=1e-5)

    m = episode_metrics(traj)
    done = np.asarray(traj.done)
    np.testing.assert_allclose(float(m["episode_return"]),
                               traj.episode_return[done].mean(), rtol=1e-6)
    np.testing.assert_allclose(float(m["episode_length"]),
                               traj.episode_length[done].mean(), rtol=1e-6)


def check_train_step(env_id):
    env, params = gft.make(env_id, Tmax=4)
    cfg = PPOConfig(num_envs=16, num_steps=8, epochs=2, num_minibatches=2,
                    hidden=16)
    key = jax.random.key(0)
    ts = make_train_state(env, cfg, key)
    bstate = batched_reset(env, params, cfg.num_envs)
    step = jax.jit(partial(train_step, env, params, cfg))
    ts1, b1, m1 = step(ts, bstate, key)
    ts2, b2, m2 = step(ts, bstate, key)
    for leaf in jax.tree.leaves((ts1.params, b1, m1)):
        assert np.all(np.isfinite(np.asarray(leaf, np.float64)))
    for x, y in zip(jax.tree.leaves((ts1, b1, m1)), jax.tree.leaves((ts2, b2, m2))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert int(ts1.step) == cfg.epochs * cfg.num_minibatches
    changed = [not np.array_equal(np.asarray(x), np.asarray(y)) for x, y in
               zip(jax.tree.leaves(ts.params), jax.tree.leaves(ts1.params))]
    assert any(changed)
