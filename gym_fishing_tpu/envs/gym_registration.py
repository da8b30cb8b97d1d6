"""Legacy OpenAI `gym` registration shim (reference `gym.make` parity).

The reference's actual user surface is classic-gym registration:
`gym.make("fishing-v0")` (reference: gym_fishing/__init__.py registers every
env id with `gym.envs.registration.register`; reconstructed — SURVEY.md §2.1,
§3.1). Modern installs use gymnasium (see envs/gymnasium_compat.py); this
module closes the literal drop-in claim for codebases still on `gym`:

    import gym, gym_fishing_tpu.envs.gym_registration  # noqa
    env = gym.make("fishing-v0")

Import is optional and degrades gracefully: when classic `gym` is not
installed (it is not in this image — gymnasium only), importing this module
is a no-op and `register_with_gym()` reports False.

The returned env is a `LegacyGymFishingEnv`: the old 4-tuple step API
(`obs, reward, done, info`) over the same JAX engine, matching the
reference's pre-gymnasium behavior exactly (the reference predates the
terminated/truncated split).
"""

from __future__ import annotations

from gym_fishing_tpu.envs.gym_adapter import GymFishingEnv
from gym_fishing_tpu.registry.registry import registered_ids

try:  # pragma: no cover - classic gym absent in this image
    import gym as _gym
except Exception:  # ImportError or any gym-internal breakage
    _gym = None


class LegacyGymFishingEnv(GymFishingEnv):
    """GymFishingEnv with the classic-gym Env base when available.

    GymFishingEnv already speaks the old protocol (4-tuple step, seed(),
    reset() -> obs); subclassing gym.Env only adds the isinstance checks
    classic-gym's `make` performs.
    """


if _gym is not None:  # pragma: no cover - classic gym absent in this image
    # re-parent so gym.make's isinstance(env, gym.Env) checks pass
    LegacyGymFishingEnv = type(
        "LegacyGymFishingEnv", (GymFishingEnv, _gym.Env), {}
    )


def register_with_gym() -> bool:
    """Register every engine env id with classic `gym` (idempotent).

    Returns True iff classic gym is importable and registration ran.
    """
    if _gym is None:
        return False
    existing = set(getattr(_gym.envs.registry, "env_specs", _gym.envs.registry))
    for env_id in registered_ids():
        if env_id in existing:
            continue
        _gym.register(
            id=env_id,
            entry_point="gym_fishing_tpu.envs.gym_registration:LegacyGymFishingEnv",
            kwargs={"env_id": env_id},
        )
    return True


REGISTERED = register_with_gym()
