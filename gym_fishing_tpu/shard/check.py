"""Sharded against single-device PPO: the check behind every mesh run.

One GSPMD ``train_step`` over a 1-D mesh of ``devices`` must give what the
same global batch gives on ``devices[0]`` alone. The env state after the
iteration is compared bit for bit: threefry's partitionable bits and every
per-env operation are the same on each shard. The parameters are compared
within a tolerance, so that an update which all-reduces per-shard gradients
(summing in another order than one device does) still passes; today's
program gathers the trajectory and updates on every device, and agrees
bitwise.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import numpy as np


def _max_abs_diff(a, b) -> float:
    return max(
        (float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))))
         for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))),
        default=0.0,
    )


def _bitwise_equal(a, b) -> bool:
    return all(
        np.array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


def compare_sharded(
    env_id: str,
    cfg,
    devices: Sequence[jax.Device],
    *,
    seed: int = 0,
    sigma: float = 0.05,
    params_atol: float = 1e-5,
    loss_rtol: float = 1e-5,
) -> dict:
    """One PPO iteration sharded over ``devices`` vs on ``devices[0]``.

    ``cfg.num_envs`` is the global batch; it must divide evenly over the
    devices. The result's ``"ok"`` says whether the losses are finite, the
    env states bitwise equal, no parameter differs by more than
    ``params_atol`` and the loss by no more than ``loss_rtol`` relative;
    the caller asserts it.
    """
    import gym_fishing_tpu as gft
    from gym_fishing_tpu.agents.ppo import make_train_state, train_step
    from gym_fishing_tpu.batch import batched_reset
    from gym_fishing_tpu.shard.mesh import make_mesh, replicate, shard_batch

    devices = list(devices)
    if cfg.num_envs % len(devices):
        raise ValueError(
            f"num_envs={cfg.num_envs} does not divide over {len(devices)} devices"
        )
    env, params = gft.make(env_id, sigma=sigma)
    mesh = make_mesh(devices=devices)
    step = jax.jit(partial(train_step, env, params, cfg))
    with jax.default_device(devices[0]):
        k_init, k_step = jax.random.split(jax.random.key(seed))
        ts0 = make_train_state(env, cfg, k_init)
        b0 = batched_reset(env, params, cfg.num_envs)
        ts_1, b_1, m_1 = step(ts0, b0, k_step)
        jax.block_until_ready((ts_1, b_1, m_1))
    ts_n, b_n, m_n = step(replicate(ts0, mesh), shard_batch(b0, mesh), k_step)
    jax.block_until_ready((ts_n, b_n, m_n))

    loss_1, loss_n = float(m_1["loss"]), float(m_n["loss"])
    out = {
        "devices": len(devices),
        "num_envs": cfg.num_envs,
        "env_state_bitwise": _bitwise_equal(b_1, b_n),
        "env_state_max_abs_diff": _max_abs_diff(b_1, b_n),
        "params_max_abs_diff": _max_abs_diff(ts_1.params, ts_n.params),
        "params_atol": params_atol,
        "loss_single": loss_1,
        "loss_sharded": loss_n,
        "loss_rel_diff": abs(loss_n - loss_1) / max(abs(loss_1), 1e-30),
        "loss_rtol": loss_rtol,
    }
    out["ok"] = bool(
        np.isfinite(loss_1) and np.isfinite(loss_n)
        and out["env_state_bitwise"]
        and out["params_max_abs_diff"] <= params_atol
        and out["loss_rel_diff"] <= loss_rtol
    )
    return out
