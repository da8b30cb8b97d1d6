"""Learners, baseline policies and the exact DP solver.

Importing this package loads no learner built on flax: DQN, SAC, TD3, ES and
recurrent PPO (and the sb3 facades over them) load on first attribute
access, so PPO, A2C and the DP solver run where flax is not installed.
"""

import importlib

from gym_fishing_tpu.agents.dp import (
    MDP,
    DPSolution,
    build_mdp,
    dp,
    finite_horizon,
    policy_evaluation,
    value_iteration,
)
from gym_fishing_tpu.agents.a2c import A2CConfig, A2CPolicy, a2c_train
from gym_fishing_tpu.agents.policies import escapement, msy, surplus_production_msy, user_action
from gym_fishing_tpu.agents.ppo import PPOConfig, PPOPolicy, train
from gym_fishing_tpu.agents.sb3_like import A2C, PPO

# name -> (module, attribute) of the flax-based learners, loaded on access
_LAZY = {
    "DQNConfig": ("dqn", "DQNConfig"),
    "DQNPolicy": ("dqn", "DQNPolicy"),
    "dqn_train": ("dqn", "dqn_train"),
    "ESConfig": ("es", "ESConfig"),
    "ESPolicy": ("es", "ESPolicy"),
    "es_train": ("es", "es_train"),
    "RecurrentPPOPolicy": ("ppo_rnn", "RecurrentPPOPolicy"),
    "RPPOConfig": ("ppo_rnn", "RPPOConfig"),
    "rppo_train": ("ppo_rnn", "train"),
    "SACConfig": ("sac", "SACConfig"),
    "SACPolicy": ("sac", "SACPolicy"),
    "sac_train": ("sac", "sac_train"),
    "TD3Config": ("td3", "TD3Config"),
    "TD3Policy": ("td3", "TD3Policy"),
    "td3_train": ("td3", "td3_train"),
    "DQN": ("sb3_offpolicy", "DQN"),
    "SAC": ("sb3_offpolicy", "SAC"),
    "TD3": ("sb3_offpolicy", "TD3"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    return getattr(importlib.import_module(f"{__name__}.{module}"), attr)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
