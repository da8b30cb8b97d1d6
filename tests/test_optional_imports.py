"""The main path runs with flax, pandas, matplotlib, gymnasium and orbax
blocked from import; the learners built on flax fail with an error that
names flax. Each case runs in a fresh interpreter with an import blocker."""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKER = textwrap.dedent("""
    import importlib.abc, os, sys
    BLOCKED = {"flax", "pandas", "matplotlib", "gymnasium", "orbax"}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, %r)
    os.environ["JAX_PLATFORMS"] = "cpu"
""" % REPO)


def _run(body: str):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER + textwrap.dedent(body)],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_main_path_and_chip_smoke_phases_run_blocked():
    out = _run("""
        import jax
        import gym_fishing_tpu.agents.ppo
        import chip_smoke as cs
        cpu = jax.devices("cpu")[0]
        cs.phase_engine(cpu, num_envs=64, num_steps=8, reps=1,
                        oracle_rows=3, oracle_steps=102)
        cs.phase_ppo(cpu, cpu, num_envs=16, num_steps=8, iterations=1, reps=1)
        cs.phase_dp(cpu, n_states=33, n_quotas=17)
        assert not {m.split(".")[0] for m in sys.modules} & BLOCKED
        print("MAIN PATH OK")
    """)
    assert "MAIN PATH OK" in out


def test_agents_package_and_on_policy_facades_run_blocked():
    out = _run("""
        import gym_fishing_tpu.agents as A
        model = A.PPO("MlpPolicy", "fishing-v1", num_envs=8, num_steps=4,
                      epochs=1, num_minibatches=2, hidden=8)
        model.learn(32)
        A.A2C("MlpPolicy", "fishing-v0", num_envs=8, num_steps=4).learn(32)
        A.dp(*__import__("gym_fishing_tpu").make("fishing-v1"),
             n_states=17, n_quotas=9)
        print("FACADES OK")
    """)
    assert "FACADES OK" in out


@pytest.mark.parametrize("name", ["DQNConfig", "SACConfig", "TD3Config",
                                  "ESConfig", "RPPOConfig", "DQN", "SAC", "TD3"])
def test_flax_learners_name_flax_when_it_is_missing(name):
    out = _run(f"""
        import gym_fishing_tpu.agents as A
        try:
            getattr(A, {name!r})
        except ImportError as e:
            assert "flax" in str(e), e
            print("NAMED FLAX")
    """)
    assert "NAMED FLAX" in out
