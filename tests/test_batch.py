"""Batch-engine tests (SURVEY.md §7.5): vmapped batch ≡ independent singles,
auto-reset ≡ manual reset, rollout shapes + episode bookkeeping."""

import jax
import jax.numpy as jnp
import numpy as np

import gym_fishing_tpu as gft
from gym_fishing_tpu.batch import batched_reset, batched_step, batched_step_xi, rollout


def test_batched_step_xi_equals_independent_singles():
    env, params = gft.make("fishing-v1", dtype=jnp.float64, sigma=0.1)
    B = 16
    rng = np.random.default_rng(0)
    state = batched_reset(env, params, B)
    # desynchronize stocks
    stocks = jnp.asarray(rng.uniform(0.2, 1.5, B))
    st = state.env.replace(stock=stocks)
    actions = jnp.asarray(rng.uniform(-1, 0, (B, 1)))
    xi = jnp.asarray(rng.standard_normal(B))
    eta = jnp.asarray(rng.standard_normal(B))

    bstate, bts = batched_step_xi(env, params, st, actions, xi, eta)
    for i in range(B):
        s_i = jax.tree.map(lambda x: x[i], st)
        ss, ts = env.step_xi(params, s_i, actions[i], xi[i], eta[i])
        assert float(ss.stock) == float(bstate.stock[i])
        assert float(ts.reward) == float(bts.reward[i])
        assert float(ts.obs[0]) == float(bts.obs[i, 0])


def test_autoreset_resets_done_instances():
    env, params = gft.make("fishing-v1", dtype=jnp.float64, sigma=0.0, Tmax=5)
    B = 4
    state = batched_reset(env, params, B)
    key = jax.random.key(0)
    # harvest everything in env 0 -> collapse + reset; others idle
    actions = jnp.asarray([[1.0], [-1.0], [-1.0], [-1.0]])
    state, ts = batched_step(env, params, state, actions, key)
    assert bool(ts.done[0]) and not bool(ts.done[1])
    # instance 0 was reset: state/obs back to init
    assert float(state.env.stock[0]) == float(params.init_state)
    assert float(ts.obs[0, 0]) == float(params.init_state / params.K - 1.0)
    assert int(state.env.t[0]) == 0 and int(state.env.t[1]) == 1
    assert float(state.episode_return[0]) == 0.0
    # the completed episode's stats are surfaced in the timestep
    assert float(ts.episode_return[0]) == float(ts.reward[0])
    assert int(ts.episode_length[0]) == 1


def test_autoreset_keeps_measurement_noise_on_live_instances():
    """With sigma_m > 0, the obs returned by batched_step(autoreset=True)
    must keep each live instance's noisy measurement (the policy trains on
    it); only done instances observe the reset state."""
    env, params = gft.make(
        "fishing-v1", dtype=jnp.float64, sigma=0.0, sigma_m=0.3, Tmax=5
    )
    B = 512
    state = batched_reset(env, params, B)
    actions = jnp.full((B, 1), -1.0)  # q=0: nothing harvested, nothing done
    state2, ts = batched_step(env, params, state, actions, jax.random.key(1))
    assert not bool(ts.done.any())
    clean = jax.vmap(env.get_obs, in_axes=(None, 0))(params, state2.env)
    # noisy obs: essentially all instances differ from the noise-free obs
    frac_noisy = float(jnp.mean(jnp.abs(ts.obs - clean) > 1e-9))
    assert frac_noisy > 0.99
    # ...and match the exact step_xi measurement law given the drawn etas
    noise = jax.random.normal(jax.random.key(1), (2, B), params.dtype)
    measured = state2.env.stock * jnp.exp(params.sigma_m * noise[1])
    expected = jnp.clip(measured / params.K - 1.0, -1.0, 1.0)
    np.testing.assert_allclose(
        np.asarray(ts.obs[:, 0]), np.asarray(expected), rtol=1e-12
    )
    # a done instance still observes the (noise-free) reset state
    env3, params3 = gft.make(
        "fishing-v1", dtype=jnp.float64, sigma=0.0, sigma_m=0.3, Tmax=1
    )
    st3 = batched_reset(env3, params3, 4)
    st3, ts3 = batched_step(env3, params3, st3, jnp.full((4, 1), -1.0),
                            jax.random.key(2))
    assert bool(ts3.done.all())
    np.testing.assert_allclose(
        np.asarray(ts3.obs[:, 0]),
        float(params3.init_state / params3.K - 1.0),
        rtol=1e-12,
    )


def test_autoreset_at_Tmax_matches_manual_reset():
    env, params = gft.make("fishing-v1", dtype=jnp.float64, sigma=0.05, Tmax=7)
    B, T = 8, 21  # 3 episodes exactly
    key = jax.random.key(42)
    policy = lambda obs, k: jnp.full((B, 1), -0.95, params.dtype)  # q=0.05, sustainable

    state = batched_reset(env, params, B)
    _, traj = rollout(env, params, policy, state, key, T, autoreset=True)
    done = np.asarray(traj.done)
    # episodes end exactly every Tmax steps (no collapse at this quota)
    assert done[6].all() and done[13].all() and done[20].all()
    assert done.sum() == 3 * B
    # episode lengths surfaced at done steps equal Tmax
    assert (np.asarray(traj.episode_length)[6] == 7).all()
    # manual-reset equivalence: second episode == first (same policy, but new
    # noise keys; check bookkeeping not values): returns reset to 0 after done
    ep_ret = np.asarray(traj.episode_return)
    assert (ep_ret[7] == np.asarray(traj.reward)[7]).all()


def test_rollout_shapes_and_device_residency():
    env, params = gft.make("fishing-may-obs-v1", sigma=0.05)
    B, T = 32, 10
    state = batched_reset(env, params, B)
    policy = lambda obs, k: jax.random.uniform(k, (B, 1), params.dtype, -1.0, 0.0)
    run = jax.jit(lambda s, k: rollout(env, params, policy, s, k, T))
    fin, traj = run(state, jax.random.key(1))
    assert traj.obs.shape == (T, B, 1)
    assert traj.reward.shape == (T, B)
    assert traj.action.shape == (T, B, 1)
    assert np.all(np.asarray(traj.obs) >= -1.0) and np.all(np.asarray(traj.obs) <= 1.0)


def test_param_vmap_sweep():
    """One compiled step serves a vmapped sweep over EnvParams (domain
    randomization / param-batch capability, new vs reference)."""
    env, params = gft.make("fishing-v1", dtype=jnp.float64, sigma=0.0)
    rs = jnp.linspace(0.1, 0.5, 5)
    sweep = jax.vmap(lambda r: params.replace(r=r))(rs)
    state = jax.vmap(env.reset)(sweep)
    action = jnp.zeros((5, 1), jnp.float64) - 1.0
    xi = jnp.zeros(5)
    ns, ts = jax.vmap(env.step_xi)(sweep, state, action, xi, xi)
    x = 0.75
    expected = x + rs * x * (1 - x)
    np.testing.assert_allclose(np.asarray(ns.stock), np.asarray(expected), atol=1e-12)


def test_mixture_growth_model_uncertainty():
    """'mixture' growth: params.model_idx selects the model per instance;
    matches each pure model exactly, and resamples per episode via the
    randomized machinery (SURVEY.md §2.1 model-uncertainty variant)."""
    from gym_fishing_tpu.core.types import GROWTH_MODELS
    from gym_fishing_tpu.batch import make_param_sampler, randomized_reset, randomized_rollout

    mix_env, mix_params = gft.make("fishing-mixture-v1", dtype=jnp.float64, sigma=0.0)
    for idx, name in enumerate(GROWTH_MODELS):
        pure = gft.make_env("pure", growth=name, scheme="continuous")
        p_pure = pure.params(jnp.float64, sigma=0.0)
        p_mix = mix_params.replace(model_idx=idx)
        s1 = mix_env.reset(p_mix)
        s2 = pure.reset(p_pure)
        a = jnp.asarray([-0.8], jnp.float64)
        n1, t1 = mix_env.step_xi(p_mix, s1, a, 0.0, 0.0)
        n2, t2 = pure.step_xi(p_pure, s2, a, 0.0, 0.0)
        assert float(n1.stock) == float(n2.stock), name

    # per-episode model resampling
    sampler = make_param_sampler(
        mix_params.replace(Tmax=4), {"model_idx": (0, len(GROWTH_MODELS) - 1)}
    )
    key = jax.random.key(0)
    state, bp = randomized_reset(mix_env, sampler, 32, key)
    assert bp.model_idx.dtype == jnp.int32
    idx_before = np.asarray(bp.model_idx)
    policy = lambda obs, k: jnp.full((32, 1), -0.95, jnp.float64)
    _, bp2, _ = jax.jit(
        lambda s, b, k: randomized_rollout(mix_env, sampler, policy, s, b, k, 9)
    )(state, bp, key)
    assert not np.array_equal(np.asarray(bp2.model_idx), idx_before)
    assert set(np.asarray(bp2.model_idx)).issubset(set(range(len(GROWTH_MODELS))))


def test_engine_rbg_keys_match_threefry_distributionally():
    """The engine is key-impl-agnostic: jax.random.key(seed, impl="rbg")
    (XLA's RngBitGenerator) must produce the same trajectory DISTRIBUTION as threefry at matched
    (B, T, sigma), though not the same streams."""
    import gym_fishing_tpu as gft
    from gym_fishing_tpu.batch import batched_reset, batched_step

    env, params = gft.make("fishing-v1", dtype=jnp.float32, sigma=0.1)
    B, T = 4096, 30

    def final_stocks(impl):
        state = batched_reset(env, params, B)

        def body(carry, k):
            st = carry
            a = jnp.full((B, 1), -0.9, jnp.float32)
            st, _ = batched_step(env, params, st, a, k, autoreset=True)
            return st, None

        keys = jax.random.split(jax.random.key(0, impl=impl), T)
        state, _ = jax.lax.scan(body, state, keys)
        return np.sort(np.asarray(state.env.stock, np.float64))

    a = final_stocks("threefry2x32")
    b = final_stocks("rbg")
    grid = np.concatenate([a, b])
    ks = np.abs(
        np.searchsorted(a, grid, side="right") / a.size
        - np.searchsorted(b, grid, side="right") / b.size
    ).max()
    assert ks < 0.045, f"KS {ks} between rbg and threefry trajectories"
    assert abs(a.mean() - b.mean()) < 4 * (a.std() + b.std()) / np.sqrt(a.size)
