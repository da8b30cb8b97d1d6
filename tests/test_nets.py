"""The plain-JAX actor-critic and TrainState against NumPy references:
forward pass and log-probs, orthogonal init and the parameter tree, and
one clipped Adam step through ``TrainState.apply_gradients``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import _np_ref
import gym_fishing_tpu as gft
from gym_fishing_tpu.agents.ppo import (
    ADAM_EPS,
    PPOConfig,
    action_logp_entropy,
    make_train_state,
    sample_action,
)
from gym_fishing_tpu.agents.train_state import TrainState

SCHEMES = {
    "continuous": ("fishing-v1", {}),
    "relative": ("fishing-v0", {}),
    "proportional": ("fishing-v0", {"n_actions": 10}),
}
# bf16 hidden layers round to ~3 significant digits
TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _setup(scheme, dtype, seed=0, hidden=32):
    env_id, kw = SCHEMES[scheme]
    env, params = gft.make(env_id, **kw)
    cfg = PPOConfig(hidden=hidden, compute_dtype=dtype)
    ts = make_train_state(env, cfg, jax.random.key(seed))
    obs = jax.random.uniform(jax.random.key(seed + 1), (33, 1), jnp.float32,
                             -1.0, 1.0)
    return env, cfg, ts, obs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_forward_matches_numpy(scheme, dtype):
    env, cfg, ts, obs = _setup(scheme, dtype)
    continuous = scheme == "continuous"
    dist, value = ts.apply_fn(ts.params, obs)
    head, log_std, v_ref = _np_ref.forward(ts.params, obs, continuous)
    # heads and value stay float32 whatever the hidden compute dtype
    assert dist[0].dtype == jnp.float32 and value.dtype == jnp.float32
    assert value.shape == (33,)
    np.testing.assert_allclose(np.asarray(value), v_ref, atol=TOL[dtype])
    np.testing.assert_allclose(np.asarray(dist[0]), head, atol=TOL[dtype])
    if continuous:
        np.testing.assert_array_equal(np.asarray(dist[1]), log_std)
    action, logp = sample_action(dist, jax.random.key(5), continuous)
    lp_ref = _np_ref.logp(np.asarray(dist[0]), None if log_std is None
                          else np.asarray(dist[1]), np.asarray(action),
                          continuous)
    np.testing.assert_allclose(np.asarray(logp), lp_ref, rtol=1e-5, atol=1e-5)
    lp2, _ = action_logp_entropy(dist, action, continuous)
    np.testing.assert_allclose(np.asarray(lp2), np.asarray(logp), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_train_state_step_matches_numpy_adam(scheme, dtype):
    env, cfg, ts, obs = _setup(scheme, dtype, seed=3)
    continuous = scheme == "continuous"

    def loss(p):
        dist, value = ts.apply_fn(p, obs)
        return jnp.sum(dist[0] ** 2) + jnp.sum((value - 1.0) ** 2)

    grads = jax.grad(loss)(ts.params)
    ts2 = ts.apply_gradients(grads=grads)
    assert int(ts2.step) == int(ts.step) + 1 == 1
    leaves, treedef = jax.tree.flatten(ts.params)
    ref = _np_ref.clipped_adam_first_step(
        leaves, jax.tree.leaves(grads), cfg.lr, cfg.max_grad_norm, ADAM_EPS
    )
    for got, want in zip(jax.tree.leaves(ts2.params), ref):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-7)
    # and it is exactly optax's chain applied by hand
    updates, opt_state = ts.tx.update(grads, ts.opt_state, ts.params)
    by_hand = optax.apply_updates(ts.params, updates)
    for got, want in zip(jax.tree.leaves(ts2.params), jax.tree.leaves(by_hand)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert continuous == ("log_std" in ts2.params["params"])


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_init_tree_names_and_orthogonal_scales(scheme):
    env, cfg, ts, obs = _setup(scheme, "float32", hidden=16)
    p = ts.params["params"]
    continuous = scheme == "continuous"
    head = "pi_mean" if continuous else "pi_logits"
    names = {"pi_d1", "pi_d2", "v_d1", "v_d2", "v_out", head}
    assert set(p) == names | ({"log_std"} if continuous else set())
    n_act = 1 if continuous else env.config.n_actions
    shapes = {"pi_d1": (1, 16), "pi_d2": (16, 16), "v_d1": (1, 16),
              "v_d2": (16, 16), "v_out": (16, 1), head: (16, n_act)}
    scales = {"pi_d1": 2.0, "pi_d2": 2.0, "v_d1": 2.0, "v_d2": 2.0,
              "v_out": 1.0, head: 1e-4}
    for name, shape in shapes.items():
        w = np.asarray(p[name]["kernel"], np.float64)
        assert w.shape == shape and p[name]["kernel"].dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(p[name]["bias"]), 0.0)
        gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
        np.testing.assert_allclose(gram, scales[name] * np.eye(len(gram)),
                                   atol=1e-5 * max(scales[name], 1e-2))
    if continuous:
        np.testing.assert_array_equal(np.asarray(p["log_std"]), 0.0)


def test_train_state_is_a_pytree_with_static_fns():
    env, cfg, ts, _ = _setup("continuous", "float32")
    leaves = jax.tree.leaves(ts)
    assert len(leaves) == (1 + len(jax.tree.leaves(ts.params))
                           + len(jax.tree.leaves(ts.opt_state)))
    ts2 = jax.jit(lambda t: t.replace(step=t.step + 2))(ts)
    assert isinstance(ts2, TrainState) and int(ts2.step) == 2
    assert ts2.apply_fn == ts.apply_fn and ts2.tx is ts.tx
