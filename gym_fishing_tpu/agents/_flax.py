"""flax.linen for the learners whose networks are flax modules.

DQN, SAC, TD3, ES and recurrent PPO need flax; PPO, A2C and the DP solver do
not. Importing one of the former without flax installed fails here, with an
error that names flax and the extra that installs it.
"""

try:
    import flax.linen as nn
except ImportError as e:
    raise ImportError(
        "this learner needs flax: pip install 'gym_fishing_tpu[flax]' "
        "(PPO, A2C and the DP solver run without it)"
    ) from e

__all__ = ["nn"]
