"""Environment registry: id string -> assembled Env (+ default params).

Replaces the reference's gym registration (reference: gym_fishing/__init__.py
`register(id="fishing-v0", entry_point="gym_fishing.envs:FishingEnv")` etc.;
reconstructed — SURVEY.md §2.1 notes the exact id<->class map is TBV, so the
mapping below is pinned and documented).

Reference-compatible ids:

- ``fishing-v0``  — discrete quota env, logistic growth. Default n_actions=3
  uses the *relative* (maintain/+20%/-20%) decode with carried harvest state;
  pass ``n_actions>3`` to get the proportional grid decode (both reference
  schemes, SURVEY.md §2.3).
- ``fishing-v1``  — continuous Box(-1,1) quota env, logistic growth.

Growth-model and observation-noise variants get explicit ids (the reference's
numbered variants are TBV, so we use descriptive ids; both -v0 discrete and
-v1 continuous forms are registered):

``fishing-ricker-v0/1, fishing-beverton-holt-v0/1, fishing-allen-v0/1,
fishing-myers-v0/1, fishing-may-v0/1, fishing-may-obs-v0/1`` (May tipping
point + lognormal observation noise, BASELINE config #4).

Numbered aliases reconstruct the reference's numbered registry (map TBV,
pinned in ``_register_all``): ``fishing-v2`` (obs error), ``fishing-v4``
(Allen) … ``fishing-v10`` (model-uncertainty mixture); each is the continuous
form of its descriptive id.

`make(id, **overrides)` mirrors `gym.make(id, sigma=0.1, ...)`: overrides are
split between static config keys (growth/noise_form/scheme/n_actions) and
EnvParams fields.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax.numpy as jnp

from gym_fishing_tpu.core.env import Env
from gym_fishing_tpu.core.types import EnvConfig, EnvParams

_STATIC_KEYS = ("growth", "noise_form", "scheme", "n_actions")
_PARAM_KEYS = tuple(f.name for f in dataclasses.fields(EnvParams))

_REGISTRY: Dict[str, Tuple[EnvConfig, EnvParams]] = {}


def register(env_id: str, config: EnvConfig, params: EnvParams = EnvParams()) -> None:
    if env_id in _REGISTRY:
        raise ValueError(f"env id {env_id!r} already registered")
    _REGISTRY[env_id] = (config, params)


def registered_ids():
    return sorted(_REGISTRY)


def make(env_id: str, dtype=jnp.float32, **overrides) -> Tuple[Env, EnvParams]:
    """Build (env, params) for a registered id, gym.make-style.

    Static overrides (growth, noise_form, scheme, n_actions) rebuild the
    EnvConfig; everything else overrides EnvParams fields. Params are returned
    cast to `dtype` (float32 for the accelerator, float64 for the CPU exactness harness).
    """
    if env_id not in _REGISTRY:
        raise ValueError(f"unknown env id {env_id!r}; known: {registered_ids()}")
    config, params = _REGISTRY[env_id]

    static = {k: v for k, v in overrides.items() if k in _STATIC_KEYS}
    dyn = {k: v for k, v in overrides.items() if k not in _STATIC_KEYS}
    unknown = [k for k in dyn if k not in _PARAM_KEYS]
    if unknown:
        raise TypeError(f"unknown override(s) {unknown} for {env_id!r}")

    # Reference semantics: the discrete env's decode is n_actions-driven —
    # n_actions=3 is the relative (maintain/±20%) scheme, larger n is the
    # proportional quota grid (SURVEY.md §2.3 schemes (a)/(b)). Passing
    # n_actions != 3 without an explicit scheme switches accordingly.
    if (
        "n_actions" in static
        and "scheme" not in static
        and config.scheme == "relative"
        and static["n_actions"] != 3
    ):
        static["scheme"] = "proportional"

    if static:
        config = dataclasses.replace(config, **static)
    if dyn:
        params = params.replace(**dyn)

    env = Env(id=env_id, config=config, default_params=params)
    return env, params.astype(dtype)


def _register_all() -> None:
    growth_defaults = {
        "logistic": {},
        "ricker": {},
        "beverton_holt": {},
        "allen": {},
        "myers": {"r": 3.0},
        "may": {"r": 0.75, "sigma": 0.05},
    }
    # Reference-named flagship ids (logistic).
    register("fishing-v0", EnvConfig(scheme="relative", growth="logistic"))
    register("fishing-v1", EnvConfig(scheme="continuous", growth="logistic"))
    # Descriptive growth-variant ids, discrete (-v0) and continuous (-v1).
    for g, overrides in growth_defaults.items():
        if g == "logistic":
            continue
        p = EnvParams().replace(**overrides)
        register(f"fishing-{g.replace('_', '-')}-v0", EnvConfig(scheme="relative", growth=g), p)
        register(f"fishing-{g.replace('_', '-')}-v1", EnvConfig(scheme="continuous", growth=g), p)
    # Growth-model-uncertainty (mixture) variant: model_idx selects the
    # effective model per instance; resample per episode via batch.randomized.
    register("fishing-mixture-v0", EnvConfig(scheme="relative", growth="mixture"))
    register("fishing-mixture-v1", EnvConfig(scheme="continuous", growth="mixture"))
    # May tipping point + observation noise (BASELINE config #4).
    p_obs = EnvParams().replace(r=0.75, sigma=0.05, sigma_m=0.05)
    register("fishing-may-obs-v0", EnvConfig(scheme="relative", growth="may"), p_obs)
    register("fishing-may-obs-v1", EnvConfig(scheme="continuous", growth="may"), p_obs)
    # Non-stationary variant: productivity declines linearly, r 0.3 -> 0.1
    # over the default 100-step horizon (r_eff = r + r_drift * t).
    p_ns = EnvParams().replace(r_drift=-0.002)
    register("fishing-nonstationary-v0", EnvConfig(scheme="relative"), p_ns)
    register("fishing-nonstationary-v1", EnvConfig(scheme="continuous"), p_ns)

    # Numbered alias ids. The reference registers its growth/noise variants
    # under numbered ids (reference: gym_fishing/__init__.py; reconstructed —
    # SURVEY.md §2.1 marks the exact number<->class map TBV, so this map is
    # pinned here and each alias also exists under its descriptive id above).
    # fishing-v3 is deliberately absent (no known reference env behind it).
    for alias, target in {
        "fishing-v2": "fishing-v1",             # + observation error, below
        "fishing-v4": "fishing-allen-v1",
        "fishing-v5": "fishing-beverton-holt-v1",
        "fishing-v6": "fishing-may-v1",
        "fishing-v7": "fishing-myers-v1",
        "fishing-v8": "fishing-ricker-v1",
        "fishing-v9": "fishing-nonstationary-v1",
        "fishing-v10": "fishing-mixture-v1",
    }.items():
        config, params = _REGISTRY[target]
        if alias == "fishing-v2":
            # observation-error variant of the flagship logistic env
            params = params.replace(sigma_m=0.05)
        register(alias, config, params)


_register_all()
