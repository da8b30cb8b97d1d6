"""The epoch shuffle (``make_perm``) is a bijection for both schemes, depends
on its key, and the 'affine' scheme refuses batch sizes that are not powers
of two; an epoch of ``update`` visits every sample exactly once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gym_fishing_tpu as gft
from gym_fishing_tpu.agents.ppo import PPOConfig, make_perm, make_train_state, update


@pytest.mark.parametrize("n", [8, 256, 4096])
@pytest.mark.parametrize("shuffle", ["exact", "affine"])
def test_perm_is_a_bijection(shuffle, n):
    cfg = PPOConfig(shuffle=shuffle)
    for seed in range(3):
        perm = np.asarray(make_perm(cfg, n, jax.random.key(seed)))
        assert perm.shape == (n,)
        np.testing.assert_array_equal(np.sort(perm), np.arange(n))


@pytest.mark.parametrize("shuffle", ["exact", "affine"])
def test_perm_depends_on_key(shuffle):
    cfg = PPOConfig(shuffle=shuffle)
    perms = {tuple(np.asarray(make_perm(cfg, 1024, jax.random.key(s))))
             for s in range(4)}
    assert len(perms) == 4


def test_affine_refuses_non_power_of_two():
    with pytest.raises(AssertionError, match="power of 2"):
        make_perm(PPOConfig(shuffle="affine"), 96, jax.random.key(0))


@pytest.mark.parametrize("shuffle", ["exact", "affine"])
def test_update_epoch_visits_every_sample_once(shuffle):
    """Rows are tagged by their index in the obs column; the loss sees each
    minibatch, and their union over one epoch is every row exactly once."""
    env, _ = gft.make("fishing-v1")
    cfg = PPOConfig(epochs=1, num_minibatches=4, hidden=8, shuffle=shuffle)
    ts = make_train_state(env, cfg, jax.random.key(0))
    n = 64
    packed = jnp.zeros((n, 6), jnp.float32).at[:, 0].set(jnp.arange(n))
    seen = []

    def apply_fn(params, obs):
        jax.debug.callback(lambda o: seen.append(np.asarray(o)[:, 0]), obs)
        return ts.apply_fn(params, obs)

    update(cfg, ts.replace(apply_fn=apply_fn), packed, jax.random.key(1),
           obs_dim=1, continuous=True)
    jax.effects_barrier()
    rows = np.concatenate(seen)
    np.testing.assert_array_equal(np.sort(rows), np.arange(n))
