"""Core pytree types for the on-device fishing environment engine.

Design (SURVEY.md §7.1): the reference keeps all state as mutable Python
attributes on a gym.Env instance (reference: gym_fishing/envs/
base_fishing_env.py — self.fish_population / self.harvest / self.years_passed).
The on-device design inverts that: state is an explicit, immutable pytree
threaded through pure functions, so the whole MDP jit-compiles, vmaps over a
leading [num_envs] axis, and shards over a device mesh.

Two kinds of configuration, split deliberately:

- ``EnvConfig`` — *static* (plain frozen dataclass, hashable, NOT a pytree):
  anything that changes the compiled program (growth-model choice, noise form,
  action-decode scheme, number of discrete actions). Baked into the jitted
  step via closure; changing it recompiles.
- ``EnvParams`` — *dynamic* (pytree of array leaves): every numeric rate and
  bound. One compiled step serves any parameter values, and params themselves
  can be vmapped for parameter sweeps / domain randomization. The computation
  dtype follows the dtype of these leaves (float32 on the accelerator; float64 on CPU for
  the exactness harness).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp

GROWTH_MODELS = ("logistic", "ricker", "beverton_holt", "allen", "myers", "may")
# "mixture" selects among GROWTH_MODELS per instance via params.model_idx
# (the model-uncertainty variant, SURVEY.md §2.1); valid in EnvConfig.growth
# but not itself a member of GROWTH_MODELS.
MIXTURE = "mixture"
NOISE_FORMS = ("additive", "lognormal")
DECODE_SCHEMES = ("continuous", "proportional", "relative")

# Relative (3-action) scheme multipliers: maintain / +20% / -20%.
# Reference: gym_fishing/envs/fishing_env.py discrete decode (reconstructed,
# ORACLE_SEMANTICS.md).
RELATIVE_MULTIPLIERS = (1.0, 1.2, 0.8)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (hashable; baked into the jit)."""

    growth: str = "logistic"
    noise_form: str = "additive"
    scheme: str = "continuous"
    n_actions: int = 3  # discrete schemes only

    def __post_init__(self) -> None:
        if self.growth not in GROWTH_MODELS + (MIXTURE,):
            raise ValueError(f"unknown growth model {self.growth!r}")
        if self.noise_form not in NOISE_FORMS:
            raise ValueError(f"unknown noise form {self.noise_form!r}")
        if self.scheme not in DECODE_SCHEMES:
            raise ValueError(f"unknown decode scheme {self.scheme!r}")
        if self.n_actions < 2:
            raise ValueError("n_actions must be >= 2")


def _field(default: float):
    return dataclasses.field(default=default)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Dynamic environment parameters — a flat pytree of scalars.

    All growth models share one parameter record (unused fields are inert),
    so a single registry / checkpoint / sweep machinery covers every variant.
    Defaults are the pinned reference defaults (ORACLE_SEMANTICS.md).
    """

    r: Any = _field(0.3)
    # non-stationary variant: effective growth rate at step t is
    # r + r_drift * t (reference family's non-stationary env; reconstructed)
    r_drift: Any = _field(0.0)
    K: Any = _field(1.0)
    sigma: Any = _field(0.05)
    sigma_m: Any = _field(0.0)
    price: Any = _field(1.0)
    cost: Any = _field(0.0)
    init_state: Any = _field(0.75)
    init_harvest: Any = _field(0.0125)
    Tmax: Any = _field(100)
    action_scale: Any = _field(1.0)
    # beverton_holt
    A: Any = _field(1.5)
    B: Any = _field(0.5)
    # allen (Allee threshold)
    C: Any = _field(0.2)
    # myers
    theta: Any = _field(2.0)
    # may
    a: Any = _field(0.175)
    b: Any = _field(0.1)
    q: Any = _field(2.0)
    # growth-model-uncertainty variant: index into GROWTH_MODELS, used only
    # when EnvConfig.growth == "mixture" (int32; per-instance when batched)
    model_idx: Any = _field(0)
    # penalty subtracted from reward when the stock collapses to 0 this step
    # (SURVEY.md §2.3 step 5 "possibly with a terminal penalty, TBV";
    # default 0 = reference-pinned behavior)
    collapse_penalty: Any = _field(0.0)

    def replace(self, **kw) -> "EnvParams":
        return dataclasses.replace(self, **kw)

    def astype(self, dtype) -> "EnvParams":
        """Cast all float leaves to `dtype` (Tmax stays integral)."""
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name in ("Tmax", "model_idx"):
                out[f.name] = jnp.asarray(v, jnp.int32)
            else:
                out[f.name] = jnp.asarray(v, dtype)
        return EnvParams(**out)

    @property
    def dtype(self):
        return jnp.result_type(self.K)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EnvState:
    """Per-instance MDP state pytree.

    `harvest` is carried state for the 3-action relative decode scheme
    (SURVEY.md §2.3: "the rebuild must carry `harvest` in the state pytree");
    for other schemes it records the last realized harvest.
    """

    stock: Any
    harvest: Any
    t: Any  # int32 years passed

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TimeStep:
    """Output of one env step (the gym `(obs, reward, done, info)` tuple,
    as a pytree; info is flattened into explicit fields for jit-friendliness).
    """

    obs: Any        # shape (..., 1), in [-1, 1]
    reward: Any
    done: Any       # bool: collapse OR horizon
    quota: Any      # decoded quota (info)
    harvest: Any    # realized harvest (info)
    collapsed: Any  # bool: stock hit 0 this step (gymnasium "terminated";
                    # done & ~collapsed is the horizon truncation)

    def replace(self, **kw) -> "TimeStep":
        return dataclasses.replace(self, **kw)
