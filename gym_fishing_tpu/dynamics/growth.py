"""Pure stock-recruitment growth functions (JAX, branch-free, vmap-safe).

Equations per ORACLE_SEMANTICS.md / SURVEY.md §2.3 (reference:
gym_fishing/envs/base_fishing_env.py `population_draw` and the growth-model
subclasses; reconstructed — reference mount empty).

Every function maps (params, post-harvest stock x) -> deterministic next
stock, elementwise, with no data-dependent control flow, so the whole family
fuses into a single XLA kernel under jit+vmap.
"""

from __future__ import annotations

from typing import Callable, Dict

import jax.numpy as jnp

from gym_fishing_tpu.core.types import EnvParams


def logistic(p: EnvParams, x):
    return x + p.r * x * (1.0 - x / p.K)


def ricker(p: EnvParams, x):
    return x * jnp.exp(p.r * (1.0 - x / p.K))


def beverton_holt(p: EnvParams, x):
    return p.A * x / (1.0 + p.B * x)


def allen(p: EnvParams, x):
    return x * jnp.exp(p.r * (1.0 - x / p.K) * (x - p.C) / p.K)


def myers(p: EnvParams, x):
    xt = x**p.theta
    return p.r * xt / (1.0 + xt / p.K)


def may(p: EnvParams, x):
    xq = x**p.q
    return x + p.r * x * (1.0 - x / p.K) - p.a * xq / (xq + p.b**p.q)


GROWTH_FNS: Dict[str, Callable] = {
    "logistic": logistic,
    "ricker": ricker,
    "beverton_holt": beverton_holt,
    "allen": allen,
    "myers": myers,
    "may": may,
}


def mixture(p: EnvParams, x):
    """Growth-model-uncertainty variant (SURVEY.md §2.1, TBV->pinned):
    the effective model is selected by ``p.model_idx`` (index into
    GROWTH_MODELS). All six updates are computed and where-selected —
    branchless, so per-instance model indices vectorize under vmap and can
    be resampled per episode (see batch.randomized)."""
    candidates = [GROWTH_FNS[name](p, x) for name in
                  ("logistic", "ricker", "beverton_holt", "allen", "myers", "may")]
    idx = jnp.asarray(p.model_idx, jnp.int32)
    out = candidates[0]
    for k in range(1, len(candidates)):
        out = jnp.where(idx == k, candidates[k], out)
    return out


GROWTH_FNS["mixture"] = mixture


def get_growth_fn(name: str) -> Callable:
    try:
        return GROWTH_FNS[name]
    except KeyError:
        raise ValueError(f"unknown growth model {name!r}; known: {sorted(GROWTH_FNS)}")
