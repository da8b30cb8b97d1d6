"""collect_rollout + GAE + packing against a NumPy loop reference, for the
first half of the registered env ids (the other half is in
test_rollout_reference_b.py)."""

import pytest

import _ppo_cases


@pytest.mark.parametrize("env_id", _ppo_cases.IDS[::2])
def test_rollout_gae_packing_match_numpy(env_id):
    _ppo_cases.check_rollout(env_id)
