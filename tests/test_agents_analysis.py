"""Policy + analysis tests — the rebuild's analog of the reference's policy
sanity checks (SURVEY.md §4): MSY yields ~rK/4 on logistic, escapement beats
doing nothing, simulate/plot/CSV parity, gym adapter round trip."""

import numpy as np
import pytest

import gym_fishing_tpu as gft
from gym_fishing_tpu.agents import escapement, msy, surplus_production_msy
from gym_fishing_tpu.analysis import estimate_policyfn, plot_mdp, plot_policyfn, simulate_mdp
from gym_fishing_tpu.envs import GymFishingEnv


def test_msy_matches_closed_form_logistic():
    env, params = gft.make("fishing-v1", sigma=0.0)
    x_star, m = surplus_production_msy(env, params)
    assert float(x_star) == pytest.approx(0.5, abs=1e-3)
    assert float(m) == pytest.approx(0.3 / 4, abs=1e-4)


def test_msy_policy_sustains_near_msy_yield():
    env, params = gft.make("fishing-v1", sigma=0.0)
    pol = msy(env, params)
    df = simulate_mdp(env, pol, reps=2, params=params)
    # after transient, per-step reward ~ rK/4 under constant-F MSY
    tail = df[df.time > 50]
    assert tail.reward.mean() == pytest.approx(0.075, abs=0.01)
    # stock settles at K/2
    assert tail.state.mean() == pytest.approx(0.5, abs=0.05)


def test_escapement_beats_no_harvest_and_msy_is_sane():
    env, params = gft.make("fishing-v1", sigma=0.05)

    class DoNothing:
        def predict(self, obs, state=None, **kw):
            return np.full((np.asarray(obs).shape[0], 1), -1.0), state

    r_esc = simulate_mdp(env, escapement(env, params), reps=4, params=params).reward.sum()
    r_msy = simulate_mdp(env, msy(env, params), reps=4, params=params).reward.sum()
    r_nothing = simulate_mdp(env, DoNothing(), reps=4, params=params).reward.sum()
    assert r_esc > r_nothing and r_msy > r_nothing
    assert r_esc > 0.9 * r_msy  # both near-optimal on logistic


def test_escapement_policy_function_shape():
    env, params = gft.make("fishing-v1", sigma=0.0)
    pol = escapement(env, params)
    df = estimate_policyfn(env, pol, reps=1, n=41, params=params)
    assert set(df.columns) == {"state", "action", "rep"}
    # below x* the policy harvests nothing (action == -1); above, it rises
    below = df[df.state < 0.45].action
    assert np.allclose(below, -1.0, atol=1e-6)
    assert df.action.iloc[-1] > df.action.iloc[0]


def test_policies_on_discrete_relative_env():
    env, params = gft.make("fishing-v0", sigma=0.0)
    pol = msy(env, params)
    df = simulate_mdp(env, pol, reps=2, params=params)
    assert df.action.isin([0, 1, 2]).all()
    assert df.reward.sum() > 0


def test_estimate_policyfn_relative_scheme_uses_carried_harvest():
    """For the relative decode the policy function is conditional on the
    carried harvest (it was once silently evaluated at
    init_harvest with state=None, which for predict() meant a scalar
    broadcast, not a per-grid-point harvest)."""
    env, params = gft.make("fishing-v0", sigma=0.0)
    pol = escapement(env, params)
    # tiny carried harvest: even where stock > x*, the best of {1, 1.2, 0.8}x
    # a near-zero harvest is the increase action (1)
    df_small = estimate_policyfn(env, pol, n=21, params=params, harvest=1e-3)
    # huge carried harvest: the policy wants far less -> decrease action (2)
    df_big = estimate_policyfn(env, pol, n=21, params=params, harvest=10.0)
    assert df_small.action.isin([0, 1, 2]).all()
    high_stock = df_small.state > 1.2
    assert (df_small[high_stock].action == 1).all()
    assert (df_big[high_stock].action == 2).all()
    # default (no harvest kwarg) conditions on init_harvest and must not crash
    df_def = estimate_policyfn(env, pol, n=21, params=params)
    assert len(df_def) == 21


def test_env_file_logging_writes_tidy_csv(tmp_path):
    """Reference surface: env ctor file= path writes one row per step
    (SURVEY §5.5)."""
    import pandas as pd

    path = tmp_path / "episode.csv"
    env = GymFishingEnv("fishing-v1", sigma=0.0, file=str(path))
    env.reset(seed=0)
    for t in range(5):
        env.step(np.asarray([-0.5], np.float32))
    env.reset()
    env.step(np.asarray([-0.5], np.float32))
    env.close()
    df = pd.read_csv(path)
    assert list(df.columns) == ["time", "state", "action", "reward", "rep"]
    assert len(df) == 6
    assert list(df.time[:5]) == [0, 1, 2, 3, 4]
    assert set(df.rep) == {1, 2}  # ctor reset is rep 0; two manual resets
    assert df.state.iloc[0] == pytest.approx(0.75)
    assert (df.action == -0.5).all()


def test_legacy_gym_shim_degrades_gracefully():
    """Classic `gym` is not in this image: the shim module must import
    cleanly and report that registration did not run."""
    import gym_fishing_tpu.envs.gym_registration as reg

    try:
        import gym  # noqa: F401

        assert reg.REGISTERED is True
        env = gym.make("fishing-v1")
        obs = env.reset()
        out = env.step(np.asarray([-0.5], np.float32))
        assert len(out) == 4  # classic 4-tuple protocol
    except ImportError:
        assert reg.REGISTERED is False
        assert reg.register_with_gym() is False
    # the shim class itself is usable directly either way
    env = reg.LegacyGymFishingEnv("fishing-v0", sigma=0.0)
    obs = env.reset()
    obs, reward, done, info = env.step(1)
    assert not done and "harvest" in info


def test_simulate_df_schema_and_plots(tmp_path):
    env, params = gft.make("fishing-v1", sigma=0.05)
    df = simulate_mdp(env, msy(env, params), reps=3, params=params)
    assert list(df.columns) == ["time", "state", "action", "reward", "rep"]
    assert df.rep.nunique() == 3
    assert len(df) == 3 * int(np.asarray(params.Tmax))
    p1 = tmp_path / "mdp.png"
    plot_mdp(df, str(p1))
    assert p1.exists() and p1.stat().st_size > 0
    dfp = estimate_policyfn(env, msy(env, params), reps=2, n=20, params=params)
    p2 = tmp_path / "policy.png"
    plot_policyfn(dfp, str(p2))
    assert p2.exists()


def test_fused_and_host_paths_agree():
    """The fused lax.scan simulate path equals the host predict() loop."""
    env, params = gft.make("fishing-v1", sigma=0.0)
    pol = msy(env, params)
    df_fused = simulate_mdp(env, pol, reps=2, params=params, seed=5)

    class HostOnly:
        def predict(self, obs, state=None, **kw):
            return pol.predict(obs, state)

    df_host = simulate_mdp(env, HostOnly(), reps=2, params=params, seed=5)
    np.testing.assert_allclose(df_fused.state, df_host.state, atol=1e-6)
    np.testing.assert_allclose(df_fused.reward, df_host.reward, atol=1e-6)


def test_gym_adapter_roundtrip(tmp_path):
    env = GymFishingEnv("fishing-v1", sigma=0.05, seed=1)
    obs = env.reset()
    assert obs.shape == (1,) and -1 <= obs[0] <= 1
    total = 0.0
    for _ in range(10):
        obs, reward, done, info = env.step(np.asarray([-0.9]))
        total += reward
        assert "harvest" in info and "quota" in info
    assert env.years_passed == 10
    assert env.fish_population > 0
    assert "stock" in env.render()
    # reference-parity helpers
    a = env.get_action(0.3)
    assert env.get_quota(a) == pytest.approx(0.3, abs=1e-6)
    df = env.simulate(msy(env.env, env.params), reps=2, file=str(tmp_path / "sim.csv"))
    assert (tmp_path / "sim.csv").exists()
    env.plot(df, str(tmp_path / "sim.png"))
    assert (tmp_path / "sim.png").exists()


def test_gym_adapter_discrete():
    env = GymFishingEnv("fishing-v0", sigma=0.0)
    obs, reward, done, info = env.step(1)  # +20%
    assert env.harvest == pytest.approx(0.0125 * 1.2, rel=1e-5)
