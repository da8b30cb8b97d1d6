"""The DP solvers at Precision.HIGHEST against float64 NumPy references:
value iteration, policy evaluation and backward induction on the same MDP,
and every contraction of the three solvers pinned to HIGHEST in the jaxpr."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gym_fishing_tpu as gft
from chip_smoke import numpy_value_iteration
from gym_fishing_tpu.agents import policy_evaluation
from gym_fishing_tpu.agents.dp import build_mdp, finite_horizon, value_iteration
from gym_fishing_tpu.agents.policies import escapement


CASES = {
    "logistic": ("fishing-v1", {"sigma": 0.05}),
    "ricker": ("fishing-ricker-v1", {"sigma": 0.1}),
    "lognormal": ("fishing-v1", {"sigma": 0.1, "noise_form": "lognormal"}),
    "may": ("fishing-may-v1", {"sigma": 0.05}),
}


def _mdp(case, n_states=65, n_quotas=33):
    env_id, kw = CASES[case]
    env, params = gft.make(env_id, dtype=jnp.float64, **kw)
    return env, params, build_mdp(env, params, n_states=n_states, n_quotas=n_quotas)


@pytest.mark.parametrize("case", list(CASES))
def test_value_iteration_matches_numpy_float64(case):
    env, params, mdp = _mdp(case)
    sol = value_iteration(env, params, gamma=0.97, tol=1e-9, mdp=mdp)
    V_ref, Q_ref, _ = numpy_value_iteration(mdp.P, mdp.R, 0.97, 1e-9)
    assert np.asarray(sol.V).dtype == np.float64
    np.testing.assert_allclose(np.asarray(sol.V), V_ref, atol=1e-8)
    np.testing.assert_allclose(np.asarray(sol.Q), Q_ref, atol=1e-8)


def test_policy_evaluation_matches_linear_solve():
    env, params, mdp = _mdp("logistic")
    gamma = 0.95
    V, _ = policy_evaluation(env, escapement(env, params).quota, params,
                             gamma=gamma, tol=1e-12, mdp=mdp)
    S = mdp.grid.shape[0]
    q = np.asarray(escapement(env, params).quota(mdp.grid))
    a = np.argmin(np.abs(q[:, None] - np.asarray(mdp.quotas)[None, :]), axis=1)
    P = np.asarray(mdp.P)[a, np.arange(S)]
    R = np.asarray(mdp.R)[a, np.arange(S)]
    P[0], R[0] = 0.0, 0.0          # collapsed state: absorbing, zero value
    V_ref = np.linalg.solve(np.eye(S) - gamma * P, R)
    np.testing.assert_allclose(np.asarray(V), V_ref, atol=1e-9)


def test_finite_horizon_matches_numpy_backward_induction():
    env, params, mdp = _mdp("logistic", n_states=33, n_quotas=17)
    V, pol, _ = finite_horizon(env, params, T=12, gamma=1.0, mdp=mdp)
    P, R = np.asarray(mdp.P), np.asarray(mdp.R)
    Vt = np.zeros(P.shape[1])
    want = []
    for _ in range(12):
        Q = R + np.einsum("asj,j->as", P, Vt)
        Vt = Q.max(axis=0)
        Vt[0] = 0.0
        want.append(Vt)
    np.testing.assert_allclose(np.asarray(V), np.stack(want[::-1]), atol=1e-10)


@pytest.mark.parametrize("solver", ["value_iteration", "finite_horizon",
                                    "policy_evaluation"])
def test_every_contraction_is_pinned_to_highest(solver):
    env, params = gft.make("fishing-v1")
    fn = {
        "value_iteration": lambda: value_iteration(env, params, n_states=9,
                                                   n_quotas=5),
        "finite_horizon": lambda: finite_horizon(env, params, T=3, n_states=9,
                                                 n_quotas=5),
        "policy_evaluation": lambda: policy_evaluation(
            env, escapement(env, params).quota, params, n_states=9, n_quotas=5),
    }[solver]
    # each dot_general prints its precision (None when unpinned)
    dots = str(jax.make_jaxpr(fn)()).split("dot_general[")[1:]
    assert dots, "no contraction found"
    for d in dots:
        prec = re.search(r"precision=(\S+)", d).group(1)
        assert prec.startswith("(Precision.HIGHEST"), prec
