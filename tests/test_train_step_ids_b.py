"""The XLA PPO train_step is finite and deterministic, for the second half of
the registered env ids (the other half is in
test_train_step_ids_a.py)."""

import pytest

import _ppo_cases


@pytest.mark.parametrize("env_id", _ppo_cases.IDS[1::2])
def test_train_step_finite_and_deterministic(env_id):
    _ppo_cases.check_train_step(env_id)
