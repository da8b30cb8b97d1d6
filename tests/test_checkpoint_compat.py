"""Checkpoints saved before the learners moved off flax's TrainState still load.

`tests/data/legacy_checkpoints/` holds one `.save()` of each sb3-style facade
written by the flax-based release (PPO and A2C on flax modules and flax's
`TrainState`), with the predictions each model made right after saving. The
current facades must restore them through the structure check of
`utils/checkpoint` and predict the same, so users' saved models keep working.
"""

import json
import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data", "legacy_checkpoints")
with open(os.path.join(DATA, "expected.json")) as f:
    EXPECTED = json.load(f)


def _facade(name):
    import gym_fishing_tpu.agents as A

    return getattr(A, name.upper())


@pytest.mark.parametrize("name", ["ppo", "a2c", "dqn", "sac", "td3"])
def test_legacy_checkpoint_restores_and_predicts_the_same(name):
    case = EXPECTED["cases"][name]
    model = _facade(name).load(os.path.join(DATA, name), env=case["env"],
                               seed=1, **case["kwargs"])
    assert model.num_timesteps == case["num_timesteps"]
    obs = np.asarray(EXPECTED["obs"], np.float32)[:, None]
    actions, _ = model.predict(obs, deterministic=True)
    np.testing.assert_allclose(np.asarray(actions, np.float64),
                               np.asarray(case["actions"]), rtol=1e-6, atol=1e-7)


def test_legacy_dqn_checkpoint_restores_q_values():
    case = EXPECTED["cases"]["dqn"]
    model = _facade("dqn").load(os.path.join(DATA, "dqn"), env=case["env"],
                                seed=1, **case["kwargs"])
    obs = np.asarray(EXPECTED["obs"], np.float32)[:, None]
    x = np.concatenate([obs, np.full_like(obs, 0.5)], -1)
    q = model.state.q.apply_fn(model.state.q.params, x)
    np.testing.assert_allclose(np.asarray(q, np.float64),
                               np.asarray(case["q_values"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["ppo", "a2c"])
def test_legacy_on_policy_checkpoint_keeps_training(name):
    """A restored flax-era PPO/A2C model takes further steps with finite loss."""
    case = EXPECTED["cases"][name]
    model = _facade(name).load(os.path.join(DATA, name), env=case["env"],
                               seed=1, **case["kwargs"])
    per_iter = case["kwargs"]["num_envs"] * case["kwargs"]["num_steps"]
    model.learn(per_iter)
    assert model.num_timesteps == case["num_timesteps"] + per_iter
    assert np.isfinite(model.history[-1]["loss"])
