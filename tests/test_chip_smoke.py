"""chip_smoke.py's phases at tiny size on explicit CPU devices, its refusal to
run without a GPU, and its comparisons failing on a wrong engine."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def test_phase_engine_tiny(cpu):
    out = cs.phase_engine(cpu, num_envs=128, num_steps=16, reps=1,
                          oracle_rows=8, oracle_steps=105)
    assert out["env_steps_per_s"] > 0 and out["memory_analysis"]
    for env_id in ("fishing-v1", "fishing-may-v1"):
        res = out[f"oracle_{env_id}"]
        assert res["done_equal"] and res["episodes_ended"] == 8


@pytest.mark.parametrize("env_id", ["fishing-ricker-v1", "fishing-v2",
                                    "fishing-nonstationary-v1"])
def test_engine_matches_oracle_on_more_envs(cpu, env_id):
    res = cs.check_engine_against_oracle(cpu, env_id, rows=6, steps=104)
    assert res["reward_max_abs_diff"] <= cs.ORACLE_ATOL


def test_engine_oracle_check_catches_a_wrong_growth(cpu, monkeypatch):
    from gym_fishing_tpu.oracle import oracle as orc

    right = orc.growth
    monkeypatch.setattr(orc, "growth", lambda cfg, x: right(cfg, x) * (1 + 1e-9))
    with pytest.raises(AssertionError):
        cs.check_engine_against_oracle(cpu, "fishing-v1", rows=4, steps=20)


def test_phase_ppo_tiny(cpu):
    out = cs.phase_ppo(cpu, cpu, num_envs=32, num_steps=8, iterations=2, reps=1)
    assert out["reference"]["env_state_bitwise"]
    assert all(out["default_precision_gap"]["would_pass"].values())
    assert len(out["train"]) == 2
    for prec in ("highest", "default"):
        split = out[f"split_{prec}"]
        assert split["train_step_ms"] > 0 and split["trained_env_steps_per_s"] > 0


def test_ppo_reference_between_two_cpu_devices_is_bitwise():
    a, b = jax.devices("cpu")[:2]
    from gym_fishing_tpu.agents.ppo import PPOConfig

    cfg = PPOConfig(num_envs=16, num_steps=8, epochs=2, num_minibatches=2,
                    hidden=16)
    res, (ts, bstate, metrics), ref = cs.check_ppo_reference("fishing-v0", cfg, a, b)
    assert res["threefry_bits_bitwise"] and res["env_state_bitwise"]
    assert res["params_max_abs_diff"] == 0.0
    # the CPU's default matmul precision is full float32
    gap = cs.precision_gap(ref, (ts, bstate, metrics), ref)
    assert gap["params_max_abs_diff_vs_highest"] == 0.0
    assert all(gap["would_pass"].values())


@pytest.mark.parametrize("field,shift,fails", [
    ("params", cs.PPO_PARAMS_ATOL * 1.5, "params_atol"),
    ("env_state", cs.PPO_STATE_ATOL * 1.5, "env_state_atol"),
    ("loss", cs.PPO_LOSS_RTOL * 1.5, "loss_rtol"),
])
def test_precision_gap_flags_each_limit(field, shift, fails):
    """A run off the reference by 1.5x one limit fails that limit only."""
    import jax.numpy as jnp

    from gym_fishing_tpu.agents.train_state import TrainState

    ts = TrainState(step=jnp.zeros((), jnp.int32),
                    params={"w": jnp.ones(3)}, opt_state=(), apply_fn=None,
                    tx=None)
    ref = (ts, {"stock": jnp.full(4, 0.5)}, {"loss": jnp.float32(0.1)})
    ts2, b2, m2 = ref
    if field == "params":
        ts2 = ts.replace(params={"w": ts.params["w"] + shift})
    elif field == "env_state":
        b2 = {"stock": b2["stock"] + shift}
    else:
        m2 = {"loss": jnp.float32(0.1 * (1 + shift))}
    gap = cs.precision_gap((ts2, b2, m2), ref, ref)
    assert {k for k, ok in gap["would_pass"].items() if not ok} == {fails}


def test_phase_dp_small(cpu):
    res = cs.phase_dp(cpu, n_states=65, n_quotas=33)
    assert res["V_max_abs_diff"] <= cs.DP_V_ATOL
    assert res["greedy_policy_max_loss"] <= cs.DP_V_ATOL


def test_phase_multichip_on_virtual_devices():
    res = cs.phase_multichip(jax.devices()[:4], envs_per_device=8,
                             num_steps=8, reps=1)
    assert res["ok"] and res["devices"] == 4 and res["num_envs"] == 32


@pytest.mark.parametrize("argv", [[], ["--multichip"]])
def test_main_without_gpu_exits_nonzero_without_ok_line(argv, capsys):
    assert cs.main(argv) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "gpu" in out.err


def _run(script, cwd, env):
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_script_on_cpu_exits_nonzero_without_ok_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = _run(os.path.join(REPO, "chip_smoke.py"), REPO, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_script_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path), env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_optional_packages_reports_each_package():
    got = cs.optional_packages()
    assert tuple(got) == cs.OPTIONAL_PACKAGES
    assert all(isinstance(v, bool) for v in got.values())

