"""Trajectory-exactness harness: JAX engine vs NumPy float64 oracle.

Both sides consume an identical injected N(0,1) stream (SURVEY.md §7.4 — this
sidesteps the MT19937-vs-threefry mismatch), run in float64 on CPU, and must
agree to near-bit tolerance across every growth model × decode scheme × noise
form, including the May tipping-point model started near its unstable
equilibrium (BASELINE correctness bar).
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gym_fishing_tpu as gft
from gym_fishing_tpu.core.types import GROWTH_MODELS
from gym_fishing_tpu.oracle import oracle as orc

ATOL64 = 1e-12


def engine_env(cfg: orc.OracleConfig):
    env = gft.make_env(
        "exactness",
        growth=cfg.growth,
        noise_form=cfg.noise_form,
        scheme=cfg.scheme,
        n_actions=cfg.n_actions,
    )
    overrides = {
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(gft.EnvParams)
    }
    params = gft.EnvParams(**overrides).astype(jnp.float64)
    return env, params


def run_engine(env, params, actions, xis, etas):
    state = env.reset(params)
    step = jax.jit(env.step_xi)
    out = []
    for a, xi, eta in zip(actions, xis, etas):
        state, ts = step(params, state, a, jnp.float64(xi), jnp.float64(eta))
        out.append(
            (
                float(state.stock),
                float(ts.obs[0]),
                float(ts.reward),
                bool(ts.done),
                float(ts.harvest),
                float(ts.quota),
            )
        )
    return np.asarray(out, dtype=object)


def compare(cfg: orc.OracleConfig, actions, xis, etas, atol=ATOL64):
    env, params = engine_env(cfg)
    if cfg.scheme == "continuous":
        eng_actions = [jnp.asarray(a, jnp.float64) for a in actions]
    else:
        eng_actions = [jnp.asarray(a, jnp.int32) for a in actions]
    eng = run_engine(env, params, eng_actions, xis, etas)
    o = orc.rollout_xi(cfg, actions, xis, etas)
    np.testing.assert_allclose([r[0] for r in eng], o["stock"], atol=atol, rtol=0)
    np.testing.assert_allclose([r[1] for r in eng], o["obs"], atol=atol, rtol=0)
    np.testing.assert_allclose([r[2] for r in eng], o["reward"], atol=atol, rtol=0)
    np.testing.assert_array_equal([r[3] for r in eng], o["done"])
    np.testing.assert_allclose([r[4] for r in eng], o["harvest"], atol=atol, rtol=0)
    np.testing.assert_allclose([r[5] for r in eng], o["quota"], atol=atol, rtol=0)


def make_streams(cfg, T, seed):
    rng = np.random.default_rng(seed)
    xis = rng.standard_normal(T)
    etas = rng.standard_normal(T)
    if cfg.scheme == "continuous":
        actions = [np.asarray([a]) for a in rng.uniform(-1.0, -0.4, T)]
    else:
        actions = list(rng.integers(0, cfg.n_actions, T))
    return actions, xis, etas


@pytest.mark.parametrize("growth", GROWTH_MODELS)
@pytest.mark.parametrize("noise_form", ["additive", "lognormal"])
def test_continuous_exactness(growth, noise_form):
    r = 3.0 if growth == "myers" else (0.75 if growth == "may" else 0.3)
    cfg = orc.OracleConfig(
        growth=growth, noise_form=noise_form, scheme="continuous", sigma=0.08, r=r
    )
    seed = zlib.crc32(f"{growth}/{noise_form}".encode())
    actions, xis, etas = make_streams(cfg, 50, seed=seed)
    compare(cfg, actions, xis, etas)


@pytest.mark.parametrize("scheme,n_actions", [("relative", 3), ("proportional", 100)])
def test_discrete_exactness(scheme, n_actions):
    cfg = orc.OracleConfig(
        growth="logistic", scheme=scheme, n_actions=n_actions, sigma=0.1
    )
    actions, xis, etas = make_streams(cfg, 60, seed=7)
    compare(cfg, actions, xis, etas)


def test_obs_noise_exactness():
    cfg = orc.OracleConfig(growth="may", r=0.75, sigma=0.05, sigma_m=0.1)
    actions, xis, etas = make_streams(cfg, 40, seed=11)
    compare(cfg, actions, xis, etas)


def test_may_near_unstable_equilibrium():
    """BASELINE correctness bar: May dynamics near the ~0.30 tipping point.

    Chaotic-adjacent — compare short horizons in float64 (SURVEY.md §7.4).
    """
    for x0 in (0.29, 0.30, 0.31):
        cfg = orc.OracleConfig(
            growth="may", r=0.75, sigma=0.0, init_state=x0, scheme="continuous"
        )
        actions = [np.asarray([-1.0])] * 20  # zero quota: pure dynamics
        compare(cfg, actions, np.zeros(20), np.zeros(20))


def test_reward_shaping_exactness():
    # BASELINE config #3: Ricker / Beverton-Holt with harvest cost + price.
    for growth in ("ricker", "beverton_holt"):
        cfg = orc.OracleConfig(
            growth=growth, scheme="continuous", sigma=0.05, price=1.5, cost=0.3
        )
        actions, xis, etas = make_streams(cfg, 50, seed=13)
        compare(cfg, actions, xis, etas)


def test_float32_tolerance():
    """The accelerator dtype path (f32) stays within loose tolerance of the oracle."""
    cfg = orc.OracleConfig(growth="logistic", scheme="continuous", sigma=0.1)
    actions, xis, etas = make_streams(cfg, 30, seed=17)
    env = gft.make_env("f32", growth="logistic", scheme="continuous")
    params = gft.EnvParams(sigma=0.1).astype(jnp.float32)
    state = env.reset(params)
    step = jax.jit(env.step_xi)
    stocks = []
    for a, xi, eta in zip(actions, xis, etas):
        state, ts = step(
            params, state, jnp.asarray(a, jnp.float32), jnp.float32(xi), jnp.float32(eta)
        )
        stocks.append(float(state.stock))
    o = orc.rollout_xi(cfg, actions, xis, etas)
    np.testing.assert_allclose(stocks, o["stock"], atol=1e-4, rtol=1e-4)


def test_episode_return_exactness():
    """Full-episode returns (sum of rewards to done) match the oracle
    bit-level in float64 (BASELINE: 'rewards and episode returns match')."""
    cfg = orc.OracleConfig(growth="logistic", scheme="continuous", sigma=0.1, Tmax=30)
    actions, xis, etas = make_streams(cfg, 30, seed=23)
    env, params = engine_env(cfg)
    state = env.reset(params)
    step = jax.jit(env.step_xi)
    eng_ret = 0.0
    for a, xi, eta in zip(actions, xis, etas):
        state, ts = step(params, state, jnp.asarray(a, jnp.float64),
                         jnp.float64(xi), jnp.float64(eta))
        eng_ret += float(ts.reward)
        if bool(ts.done):
            break
    o = orc.rollout_xi(cfg, actions, xis, etas)
    done_idx = int(np.argmax(o["done"])) if o["done"].any() else len(actions) - 1
    orc_ret = float(o["reward"][: done_idx + 1].sum())
    assert eng_ret == pytest.approx(orc_ret, abs=1e-12)


def test_collapse_penalty_all_implementations():
    """collapse_penalty applies on the collapse step in engine, NumPy oracle,
    and C oracle identically (pinned addendum, ORACLE_SEMANTICS.md)."""
    cfg = orc.OracleConfig(sigma=0.0, collapse_penalty=2.5)
    st = orc.reset(cfg)
    a = orc.get_action(cfg, st, 2.0)  # harvest everything -> collapse
    _, _, r_py, done, _ = orc.step_xi(cfg, st, a, 0.0)
    assert done and r_py == pytest.approx(0.75 - 2.5, abs=1e-12)

    env, params = engine_env(cfg)
    state = env.reset(params)
    _, ts = env.step_xi(params, state, jnp.asarray(a, jnp.float64), 0.0, 0.0)
    assert float(ts.reward) == pytest.approx(r_py, abs=1e-12)

    from gym_fishing_tpu.native import COracle, available

    if available():
        c = COracle(cfg).rollout_xi([a], np.zeros(1))
        assert c["reward"][0] == r_py


def test_nonstationary_drift_exactness():
    """Non-stationary variant (r_eff = r + r_drift * t): engine == oracle,
    and the drift measurably changes the trajectory."""
    cfg = orc.OracleConfig(growth="logistic", r_drift=-0.002, sigma=0.05)
    actions, xis, etas = make_streams(cfg, 60, seed=11)
    compare(cfg, actions, xis, etas)
    cfg0 = dataclasses.replace(cfg, r_drift=0.0)
    o_d = orc.rollout_xi(cfg, actions, xis, etas)
    o_0 = orc.rollout_xi(cfg0, actions, xis, etas)
    assert np.max(np.abs(np.asarray(o_d["stock"]) - np.asarray(o_0["stock"]))) > 1e-4


def test_nonstationary_registry_id():
    env, params = gft.make("fishing-nonstationary-v1", dtype=jnp.float64)
    assert float(np.asarray(params.r_drift)) == -0.002
    cfg = orc.OracleConfig(growth="logistic", r_drift=-0.002)
    actions, xis, etas = make_streams(cfg, 40, seed=12)
    compare(cfg, actions, xis, etas)
