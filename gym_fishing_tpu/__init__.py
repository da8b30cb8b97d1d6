"""gym_fishing_tpu — an accelerator-native rebuild of boettiger-lab/gym_fishing.

A vectorized, mesh-shardable fisheries-management environment engine:
pure-JAX ``step(params, state, action, key)`` dynamics that jit+vmap to
millions of lockstep instances per chip, with auto-reset, episode
bookkeeping, baseline policies (MSY / constant escapement), a co-located PPO
learner, analysis/plotting parity with the reference, and a NumPy float64
oracle anchoring trajectory exactness. See SURVEY.md and ORACLE_SEMANTICS.md.
"""

from gym_fishing_tpu.core.env import Env, make_env
from gym_fishing_tpu.core.types import EnvConfig, EnvParams, EnvState, TimeStep
from gym_fishing_tpu.registry.registry import make, register, registered_ids

__version__ = "0.1.0"

__all__ = [
    "Env",
    "EnvConfig",
    "EnvParams",
    "EnvState",
    "TimeStep",
    "make",
    "make_env",
    "register",
    "registered_ids",
    "__version__",
]
