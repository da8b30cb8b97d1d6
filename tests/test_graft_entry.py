"""Driver-contract tests: entry() compiles and runs; dryrun_multichip(8)
runs the sharded PPO step on the virtual 8-device CPU mesh and checks it
against the single-device step."""

import jax
import pytest

import __graft_entry__ as graft


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    bstate2, reward, value, logp = out
    assert reward.shape == (256,)
    assert value.shape == (256,)


def test_dryrun_multichip():
    out = graft.dryrun_multichip(8)
    assert out["ok"] and out["devices"] == 8
    assert out["env_state_bitwise"]
    assert out["params_max_abs_diff"] <= out["params_atol"]


def test_dryrun_multichip_refuses_too_few_devices():
    from gym_fishing_tpu.device import DeviceUnavailable

    with pytest.raises(DeviceUnavailable, match="need 8 devices, have 2"):
        graft.dryrun_multichip(8, devices=jax.devices()[:2])
