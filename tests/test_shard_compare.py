"""Sharded against single-device PPO train_step (``shard.compare_sharded``)
on 2, 4 and 8 virtual CPU devices, for a continuous and a discrete env."""

import jax
import pytest

from gym_fishing_tpu.agents.ppo import PPOConfig
from gym_fishing_tpu.shard import compare_sharded


@pytest.mark.parametrize("env_id", ["fishing-v1", "fishing-v0"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_matches_single_device(n, env_id):
    cfg = PPOConfig(num_envs=8 * n, num_steps=8, epochs=2, num_minibatches=2,
                    hidden=16)
    out = compare_sharded(env_id, cfg, jax.devices()[:n])
    assert out["ok"] and out["devices"] == n and out["env_state_bitwise"]


def test_compare_sharded_refuses_uneven_split():
    cfg = PPOConfig(num_envs=10, num_steps=4, epochs=1, num_minibatches=2)
    with pytest.raises(ValueError, match="does not divide"):
        compare_sharded("fishing-v1", cfg, jax.devices()[:4])
