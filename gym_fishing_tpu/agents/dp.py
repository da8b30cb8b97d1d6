"""Exact dynamic-programming solvers for the fishing MDP, on device.

The reference has no solver — its closed-form baselines (msy, escapement;
reference: gym_fishing/models/policies.py, reconstructed) are heuristics that
happen to be optimal only in special cases. The Boettiger-lab workflow these
envs exist for, however, is *comparing RL agents against the true MDP
optimum* computed by dynamic programming on a discretized state space. This
module supplies that missing capability, on device:

- ``build_mdp`` discretizes stock into S cells and quota into A levels, then
  integrates the engine's exact process-noise law (additive-normal or
  lognormal, ``dynamics/noise.py``) over the cells to produce a dense
  transition tensor ``P[A, S, S]`` and reward matrix ``R[A, S]`` — all
  vectorized jnp, no Python loops over states.
- ``value_iteration`` runs the Bellman operator to a fixed point under
  ``lax.while_loop``; the contraction is one ``[A*S, S] @ [S]`` contraction
  per sweep, at ``Precision.HIGHEST``. Its time on the H100: not measured.
- ``finite_horizon`` does exact backward induction over the episode horizon
  (``lax.scan``), supporting gamma=1 — the true episodic optimum for the
  Tmax-terminated envs.
- ``dp`` wraps the solved policy in the same sb3 ``.predict`` contract as
  ``msy``/``escapement``, so it plugs into ``simulate_mdp`` and the plotting
  helpers unchanged.

Semantics pinned to the engine (core/env.py step order): harvest first
(h = min(x, q)), then growth, then noise, clip at 0; reward
``price*h - cost*q^2 - collapse_penalty*[x'<=0]``; stock 0 is absorbing with
zero reward (collapse terminates the episode, and every growth model maps
0 -> 0, so the absorbing encoding is exact).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.stats import norm

from gym_fishing_tpu.agents.policies import _PolicyBase
from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import MIXTURE, EnvParams
from gym_fishing_tpu.dynamics.growth import get_growth_fn

_DET_EPS = 1e-12  # noise scale below which a transition is treated as a delta
# An exact solver: full float32 (or float64) products. The default precision
# lets XLA:GPU run float32 contractions in TF32, whose ~3 significant digits
# would stall the sup-norm stopping rule.
_EXACT = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MDP:
    """Discretized MDP. grid[0] = 0 is the absorbing collapsed state."""

    grid: Any    # [S] stock levels (cell representatives)
    quotas: Any  # [A] quota levels
    P: Any       # [A, S, S] transition probabilities (rows sum to 1)
    R: Any       # [A, S] expected one-step reward


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DPSolution:
    grid: Any          # [S] stock grid
    quotas: Any        # [A] quota grid
    V: Any             # [S] optimal value
    Q: Any             # [A, S] optimal state-action value
    policy_quota: Any  # [S] greedy quota per state
    iterations: Any    # int32 Bellman sweeps performed
    residual: Any      # float sup-norm of the final sweep


def _interp_rows(grid, mu):
    """Delta-at-mu rows: linear-interpolation weights of mu onto `grid`.

    mu: [...] -> rows [..., S]; exact two-point hat weights on the (possibly
    non-uniform) sorted grid, clipped to the grid range.
    """
    S = grid.shape[0]
    mu = jnp.clip(mu, grid[0], grid[-1])
    hi = jnp.clip(jnp.searchsorted(grid, mu, side="right"), 1, S - 1)
    lo = hi - 1
    w = (mu - grid[lo]) / (grid[hi] - grid[lo])
    eye = jnp.eye(S, dtype=mu.dtype)
    return eye[lo] * (1.0 - w)[..., None] + eye[hi] * w[..., None]


def build_mdp(
    env: Env,
    params: Optional[EnvParams] = None,
    *,
    n_states: int = 256,
    n_quotas: int = 128,
    x_max: Optional[float] = None,
) -> MDP:
    """Discretize the env into a dense tabular MDP.

    State cells: state 0 is exactly x=0 (collapsed, absorbing); states
    1..S-1 are uniform cells over (0, x_max] represented by their midpoints.
    Transition mass below 0 lands in state 0 (matching the engine's
    ``x_next = max(x2, 0)`` + collapse test); mass above x_max lumps into the
    top cell. x_max defaults to 2K (the observation-scaling range).
    """
    if env.config.growth == MIXTURE:
        raise ValueError(
            "build_mdp needs a single growth model; solve each mixture "
            "component separately (growth=GROWTH_MODELS[model_idx])"
        )
    p = params if params is not None else env.default_params
    dtype = p.dtype
    K = jnp.asarray(p.K, dtype)
    xm = jnp.asarray(2.0 * K if x_max is None else x_max, dtype)

    S, A = n_states, n_quotas
    dx = xm / (S - 1)
    grid = jnp.concatenate([jnp.zeros((1,), dtype), (jnp.arange(1, S) - 0.5) * dx])
    # Cell edges for binning x2: (-inf, 0], (0, dx], ..., ((S-2)dx, +inf).
    inner = jnp.arange(0, S - 1, dtype=dtype) * dx  # 0, dx, ..., (S-2)dx
    quotas = jnp.linspace(0.0, xm, A, dtype=dtype)

    growth = get_growth_fn(env.config.growth)

    x = grid[None, :]                      # [1, S]
    q = quotas[:, None]                    # [A, 1]
    h = jnp.minimum(x, q)                  # [A, S]
    x1 = x - h
    mu = growth(p, x1)

    if env.config.noise_form == "additive":
        # x2 ~ Normal(mu, sigma*x1)
        scale = jnp.asarray(p.sigma, dtype) * x1
        det = scale <= _DET_EPS
        safe = jnp.where(det, jnp.ones((), dtype), scale)
        cdf_inner = norm.cdf((inner[None, None, :] - mu[..., None]) / safe[..., None])
    else:  # lognormal: x2 = mu * exp(sigma * xi), support (0, inf) for mu > 0
        scale = jnp.broadcast_to(jnp.asarray(p.sigma, dtype), mu.shape)
        det = (scale <= _DET_EPS) | (mu <= 0.0)
        safe_mu = jnp.where(mu > 0.0, mu, jnp.ones((), dtype))
        safe = jnp.where(det, jnp.ones((), dtype), scale)
        with jax.numpy_dtype_promotion("standard"):
            z = jnp.where(
                inner[None, None, :] > 0.0,
                jnp.log(jnp.maximum(inner[None, None, :], _DET_EPS) / safe_mu[..., None])
                / safe[..., None],
                jnp.asarray(-jnp.inf, dtype),
            )
        cdf_inner = norm.cdf(z)

    # CDF at all S+1 edges: F(-inf)=0, F(inner edges), F(+inf)=1.
    zeros = jnp.zeros(mu.shape + (1,), dtype)
    ones = jnp.ones(mu.shape + (1,), dtype)
    cdf = jnp.concatenate([zeros, cdf_inner, ones], axis=-1)  # [A, S, S+1]
    P_noisy = jnp.diff(cdf, axis=-1)                          # [A, S, S]

    P_det = _interp_rows(grid, jnp.maximum(mu, 0.0))          # [A, S, S]
    P = jnp.where(det[..., None], P_det, P_noisy)

    p_collapse = P[..., 0]
    R = (
        jnp.asarray(p.price, dtype) * h
        - jnp.asarray(p.cost, dtype) * q * q
        - jnp.asarray(p.collapse_penalty, dtype) * p_collapse
    )
    # Absorbing collapsed state: no reward, stays at 0 (already a delta at 0
    # by construction since growth(0) = 0 and the noise scale vanishes).
    R = R.at[:, 0].set(0.0)
    return MDP(grid=grid, quotas=quotas, P=P, R=R)


def _greedy(mdp: MDP, Q):
    best = jnp.argmax(Q, axis=0)                       # [S]
    return mdp.quotas[best]


def value_iteration(
    env: Env,
    params: Optional[EnvParams] = None,
    *,
    gamma: float = 0.99,
    tol: float = 1e-6,
    max_iters: int = 20_000,
    n_states: int = 256,
    n_quotas: int = 128,
    x_max: Optional[float] = None,
    mdp: Optional[MDP] = None,
) -> DPSolution:
    """Infinite-horizon discounted value iteration (gamma < 1 required).

    One sweep is ``Q = R + gamma * P @ V`` — a single [A*S, S] x [S]
    contraction — under ``lax.while_loop`` until the sup-norm
    residual falls below ``tol * (1 - gamma) / gamma`` (standard stopping rule
    giving a value function within ``tol`` of optimal).
    """
    if not (0.0 < gamma < 1.0):
        raise ValueError("value_iteration requires 0 < gamma < 1; "
                         "use finite_horizon for gamma=1 episodic optima")
    if mdp is None:
        mdp = build_mdp(env, params, n_states=n_states, n_quotas=n_quotas, x_max=x_max)
    S = mdp.grid.shape[0]
    dtype = mdp.R.dtype
    g = jnp.asarray(gamma, dtype)
    stop = jnp.asarray(tol * (1.0 - gamma) / gamma, dtype)

    def sweep(V):
        Q = mdp.R + g * jnp.einsum("asj,j->as", mdp.P, V, precision=_EXACT)
        Vn = jnp.max(Q, axis=0).at[0].set(0.0)
        return Q, Vn

    def cond(carry):
        _, resid, i = carry
        return (resid > stop) & (i < max_iters)

    def body(carry):
        V, _, i = carry
        _, Vn = sweep(V)
        return Vn, jnp.max(jnp.abs(Vn - V)), i + 1

    V0 = jnp.zeros((S,), dtype)
    V, resid, iters = jax.lax.while_loop(
        cond, body, (V0, jnp.asarray(jnp.inf, dtype), jnp.asarray(0, jnp.int32))
    )
    Q, V = sweep(V)
    return DPSolution(
        grid=mdp.grid, quotas=mdp.quotas, V=V, Q=Q,
        policy_quota=_greedy(mdp, Q), iterations=iters, residual=resid,
    )


def finite_horizon(
    env: Env,
    params: Optional[EnvParams] = None,
    *,
    T: Optional[int] = None,
    gamma: float = 1.0,
    n_states: int = 256,
    n_quotas: int = 128,
    x_max: Optional[float] = None,
    mdp: Optional[MDP] = None,
) -> Tuple[Any, Any, MDP]:
    """Exact backward induction over T steps (default: params.Tmax).

    Returns ``(V, policy_quota, mdp)`` where ``V[t, s]`` is the optimal
    value with ``T - t`` steps remaining *before* step t (so ``V[0]`` is the
    value of a fresh episode) and ``policy_quota[t, s]`` the optimal quota at
    step t. Supports gamma=1 — the true optimum of the Tmax-terminated
    episodic envs.
    """
    p = params if params is not None else env.default_params
    if T is None:
        T = int(p.Tmax)
    if mdp is None:
        mdp = build_mdp(env, p, n_states=n_states, n_quotas=n_quotas, x_max=x_max)
    dtype = mdp.R.dtype
    g = jnp.asarray(gamma, dtype)

    def backup(V, _):
        Q = mdp.R + g * jnp.einsum("asj,j->as", mdp.P, V, precision=_EXACT)
        Vn = jnp.max(Q, axis=0).at[0].set(0.0)
        return Vn, (Vn, _greedy(mdp, Q))

    VT = jnp.zeros((mdp.grid.shape[0],), dtype)
    _, (Vs, pols) = jax.lax.scan(backup, VT, None, length=T)
    # scan yields values for steps-remaining 1..T; flip to time order so
    # index t is the policy/value used at episode step t.
    return Vs[::-1], pols[::-1], mdp


def policy_evaluation(
    env: Env,
    policy_quota,
    params: Optional[EnvParams] = None,
    *,
    gamma: float = 0.99,
    tol: float = 1e-9,
    max_iters: int = 100_000,
    n_states: int = 256,
    n_quotas: int = 128,
    x_max: Optional[float] = None,
    mdp: Optional[MDP] = None,
):
    """Exact discounted value V^pi of a quota rule (no Monte Carlo).

    ``policy_quota`` is either a callable ``stock -> quota`` (e.g.
    ``msy(env, params).quota`` or ``escapement(env, params).quota``) or an
    array of per-state quotas on the MDP grid. Each state's quota snaps to
    the nearest level of the quota grid; the evaluation then iterates
    ``V = R_pi + gamma * P_pi V`` to the fixed point under lax.while_loop.

    Returns ``(V, mdp)`` — interpolate V on ``mdp.grid`` for arbitrary
    stocks.
    """
    if not (0.0 < gamma < 1.0):
        raise ValueError("policy_evaluation requires 0 < gamma < 1")
    if mdp is None:
        mdp = build_mdp(env, params, n_states=n_states, n_quotas=n_quotas, x_max=x_max)
    S = mdp.grid.shape[0]
    dtype = mdp.R.dtype
    q = jnp.asarray(policy_quota(mdp.grid) if callable(policy_quota) else policy_quota, dtype)
    if q.shape != (S,):
        raise ValueError(f"policy quota must have shape ({S},), got {q.shape}")
    a_idx = jnp.argmin(jnp.abs(q[:, None] - mdp.quotas[None, :]), axis=-1)  # [S]
    sel = jnp.arange(S)
    P_pi = mdp.P[a_idx, sel, :]   # [S, S]
    R_pi = mdp.R[a_idx, sel]      # [S]
    g = jnp.asarray(gamma, dtype)
    stop = jnp.asarray(tol * (1.0 - gamma) / gamma, dtype)

    def cond(carry):
        _, resid, i = carry
        return (resid > stop) & (i < max_iters)

    def body(carry):
        V, _, i = carry
        Vn = (R_pi + g * jnp.dot(P_pi, V, precision=_EXACT)).at[0].set(0.0)
        return Vn, jnp.max(jnp.abs(Vn - V)), i + 1

    V, _, _ = jax.lax.while_loop(
        cond, body,
        (jnp.zeros((S,), dtype), jnp.asarray(jnp.inf, dtype), jnp.asarray(0, jnp.int32)),
    )
    return V, mdp


class dp(_PolicyBase):
    """Optimal DP policy with the sb3 ``.predict`` contract.

    Solves the discretized MDP by discounted value iteration at construction
    and answers queries by linear interpolation of the greedy quota on the
    stock grid. Drop-in wherever ``msy``/``escapement`` go (simulate_mdp,
    plot_policyfn, sb3-style eval loops).
    """

    def __init__(
        self,
        env: Env,
        params: Optional[EnvParams] = None,
        *,
        gamma: float = 0.99,
        n_states: int = 256,
        n_quotas: int = 128,
        **vi_kwargs,
    ):
        super().__init__(env, params)
        self.solution = value_iteration(
            env, self.params, gamma=gamma,
            n_states=n_states, n_quotas=n_quotas, **vi_kwargs,
        )

    def quota(self, stock):
        s = self.solution
        return jnp.interp(stock, s.grid, s.policy_quota)
