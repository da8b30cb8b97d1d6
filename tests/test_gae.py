"""compute_gae against the NumPy reverse-loop reference, on edge cases:
no episode end, every step an end, an end at the first or last step,
lambda 0 (one-step TD) and 1 (Monte-Carlo returns), gamma 0, and T=1."""

import jax.numpy as jnp
import numpy as np
import pytest

import _np_ref
from gym_fishing_tpu.agents.ppo import PPOConfig, Transition, compute_gae

T, B = 7, 5


def _traj(dones, seed=0):
    rng = np.random.default_rng(seed)
    T_, B_ = dones.shape
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    return Transition(
        obs=f32(rng.normal(size=(T_, B_, 1))), action=f32(np.zeros((T_, B_, 1))),
        logp=f32(np.zeros((T_, B_))), value=f32(rng.normal(size=(T_, B_))),
        reward=f32(rng.normal(size=(T_, B_))), done=jnp.asarray(dones),
        episode_return=f32(np.zeros((T_, B_))),
        episode_length=jnp.zeros((T_, B_), jnp.int32),
    ), f32(rng.normal(size=(B_,)))


def _done(kind):
    d = np.zeros((T, B), bool)
    if kind == "all":
        d[:] = True
    elif kind == "first":
        d[0] = True
    elif kind == "last":
        d[-1] = True
    elif kind == "random":
        d = np.random.default_rng(1).random((T, B)) < 0.3
    return d


CASES = [
    ("none", 0.99, 0.95),
    ("all", 0.99, 0.95),
    ("first", 0.99, 0.95),
    ("last", 0.99, 0.95),
    ("random", 0.99, 0.95),
    ("random", 0.99, 0.0),
    ("random", 0.99, 1.0),
    ("random", 0.0, 0.95),
]


@pytest.mark.parametrize("kind,gamma,lam", CASES)
def test_gae_matches_numpy(kind, gamma, lam):
    traj, last_value = _traj(_done(kind))
    cfg = PPOConfig(gamma=gamma, gae_lambda=lam)
    adv, ret = compute_gae(cfg, traj, last_value)
    adv_ref, ret_ref = _np_ref.gae(traj.reward, traj.value, traj.done,
                                   last_value, gamma, lam)
    np.testing.assert_allclose(np.asarray(adv), adv_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ret), ret_ref, rtol=1e-5, atol=1e-5)


def test_gae_single_step():
    traj, last_value = _traj(np.array([[False, True, False]]))
    adv, _ = compute_gae(PPOConfig(gamma=0.9, gae_lambda=0.8), traj, last_value)
    want = (np.asarray(traj.reward[0]) + 0.9 * np.asarray(last_value)
            * np.array([1.0, 0.0, 1.0]) - np.asarray(traj.value[0]))
    np.testing.assert_allclose(np.asarray(adv[0]), want, rtol=1e-6, atol=1e-6)


def test_gae_ends_cut_the_bootstrap():
    """With every step an episode end, the advantage is reward - value."""
    traj, last_value = _traj(_done("all"))
    adv, ret = compute_gae(PPOConfig(), traj, last_value)
    np.testing.assert_allclose(np.asarray(adv),
                               np.asarray(traj.reward) - np.asarray(traj.value),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ret), np.asarray(traj.reward),
                               rtol=1e-6, atol=1e-6)
