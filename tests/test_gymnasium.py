"""Gymnasium conformance — the rebuild's version of the reference's
env-checker tests (SURVEY.md §4): every registered id passes
gymnasium.utils.env_checker.check_env."""

import numpy as np
import pytest

gymnasium = pytest.importorskip("gymnasium")

import gym_fishing_tpu.envs.gymnasium_compat  # noqa: F401  (registers ids)
from gym_fishing_tpu.registry.registry import registered_ids


def test_gym_make_and_run():
    env = gymnasium.make("fishing-v1")
    obs, info = env.reset(seed=0)
    assert obs.shape == (1,)
    total = 0.0
    for _ in range(5):
        obs, reward, term, trunc, info = env.step(np.asarray([-0.9], np.float32))
        total += reward
        assert not term
    assert total > 0


@pytest.mark.parametrize("env_id", registered_ids())
def test_env_checker(env_id):
    from gymnasium.utils.env_checker import check_env

    env = gymnasium.make(f"gym_fishing_tpu/{env_id}").unwrapped
    check_env(env, skip_render_check=True)


def test_terminated_vs_truncated():
    env = gymnasium.make("fishing-v1", sigma=0.0).unwrapped
    env.reset(seed=0)
    # harvest everything -> collapse (terminated, not truncated)
    obs, r, term, trunc, info = env.step(np.asarray([1.0], np.float32))
    assert term and not trunc
    # run out the clock -> truncated
    env2 = gymnasium.make("fishing-v1", sigma=0.0, Tmax=3).unwrapped
    env2.reset(seed=0)
    for i in range(3):
        obs, r, term, trunc, info = env2.step(np.asarray([-1.0], np.float32))
    assert trunc and not term


def test_vector_env():
    from gym_fishing_tpu.envs.vector_env import FishingVectorEnv

    envs = FishingVectorEnv("fishing-v1", num_envs=8, sigma=0.0, Tmax=4)
    obs, infos = envs.reset(seed=0)
    assert obs.shape == (8, 1)
    for i in range(4):
        acts = np.full((8, 1), -0.95, np.float32)
        obs, rew, term, trunc, infos = envs.step(acts)
    assert trunc.all() and not term.any()
    assert (infos["episode_length"] == 4).all()
    # collapse -> terminated
    envs2 = FishingVectorEnv("fishing-v1", num_envs=4, sigma=0.0)
    envs2.reset(seed=0)
    obs, rew, term, trunc, infos = envs2.step(np.full((4, 1), 1.0, np.float32))
    assert term.all() and not trunc.any()


def test_vector_env_collapse_at_horizon_is_terminated():
    """Collapse on exactly the Tmax-th step must classify as terminated
    (length-based inference once called it truncation)."""
    from gym_fishing_tpu.envs.vector_env import FishingVectorEnv

    envs = FishingVectorEnv("fishing-v1", num_envs=4, sigma=0.0, Tmax=2)
    envs.reset(seed=0)
    envs.step(np.full((4, 1), -1.0, np.float32))          # t=1: no harvest
    obs, rew, term, trunc, infos = envs.step(
        np.full((4, 1), 1.0, np.float32)                   # t=Tmax: harvest all
    )
    assert term.all() and not trunc.any()
    assert (infos["episode_length"] == 2).all()


def test_vector_env_discrete():
    from gym_fishing_tpu.envs.vector_env import FishingVectorEnv

    envs = FishingVectorEnv("fishing-v0", num_envs=4, sigma=0.0)
    envs.reset(seed=0)
    obs, rew, term, trunc, infos = envs.step(np.array([0, 1, 2, 0]))
    assert obs.shape == (4, 1) and rew.shape == (4,)
