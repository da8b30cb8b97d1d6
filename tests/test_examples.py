"""Smoke-run every examples/ script with tiny budgets.

The seven example scripts are the documented user surface (PARITY.md maps
them to the reference's sb3 workflow scripts, SURVEY.md §1 L5); they drive
the facade APIs through argparse glue, so a facade-signature or flag drift
would otherwise ship silently while the unit suite stays green. Each script
runs in a fresh subprocess pinned to the CPU (JAX_PLATFORMS=cpu), with
budgets small enough that the whole file is a few minutes of compile-bound
CPU work. Asserts exit 0 + the documented artifacts exist.
"""

import os
import subprocess
import sys

import pytest

EXAMPLES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"
)


def _run(script, *args, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # small virtual mesh so the sharding-aware scripts exercise their mesh
    # logic; also keeps them off any real accelerator
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4"
        ).strip()
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, script), *map(str, args)],
        capture_output=True, text=True, timeout=timeout, env=env,
    )
    assert proc.returncode == 0, (
        f"{script} exited {proc.returncode}\nstdout:\n{proc.stdout[-2000:]}"
        f"\nstderr:\n{proc.stderr[-2000:]}"
    )
    return proc


@pytest.mark.slow
def test_train_ppo_example(tmp_path):
    out = tmp_path / "ppo"
    _run(
        "train_ppo.py", "--timesteps", 512, "--num-envs", 64,
        "--num-steps", 8, "--out", out,
    )
    for artifact in ("ckpt", "sim.csv", "policy.png", "mdp.png"):
        assert (out / artifact).exists(), f"missing {artifact}"


@pytest.mark.slow
def test_train_ppo_example_a2c_fused_flags(tmp_path):
    """The a2c algo switch runs; the PPO-only --shuffle flag parses and runs."""
    out = tmp_path / "a2c"
    _run(
        "train_ppo.py", "--algo", "a2c", "--timesteps", 512,
        "--num-envs", 64, "--num-steps", 8, "--out", out,
    )
    assert (out / "ckpt").exists()
    out = tmp_path / "affine"
    _run(
        "train_ppo.py", "--shuffle", "affine", "--timesteps", 512,
        "--num-envs", 64, "--num-steps", 8, "--out", out,
    )
    assert (out / "ckpt").exists()


@pytest.mark.slow
def test_dp_optimal_example(tmp_path):
    out = tmp_path / "dp.png"
    proc = _run(
        "dp_optimal.py", "--reps", 2, "--n-states", 65, "--n-quotas", 33,
        "--out", out,
    )
    assert out.exists()
    assert "dp" in proc.stdout.lower() or proc.stdout.strip()


@pytest.mark.slow
def test_simulate_baselines_example(tmp_path):
    out = tmp_path / "results"
    _run("simulate_baselines.py", "--out", out, "--reps", 2)
    assert out.is_dir() and any(out.iterdir()), "no artifacts written"


@pytest.mark.slow
def test_tipping_point_example(tmp_path):
    out = tmp_path / "may_basins.png"
    _run("tipping_point.py", "--out", out, "--horizon", 20)
    assert out.exists()


@pytest.mark.slow
def test_model_uncertainty_example():
    _run(
        "model_uncertainty.py", "--num-envs", 64, "--horizon", 8,
        "--steps", 3,
    )


@pytest.mark.slow
def test_pomdp_policies_example():
    _run(
        "pomdp_policies.py", "--iterations", 2, "--num-envs", 64,
        "--reps", 2, "--k", 3,
    )


@pytest.mark.slow
def test_multihost_train_example():
    """Single-process run degrades gracefully to the local (virtual) mesh."""
    _run(
        "multihost_train.py", "--num-envs-per-chip", 64, "--num-steps", 8,
        "--iterations", 2,
    )
