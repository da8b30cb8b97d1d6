"""Scaling-efficiency benchmark: fixed per-device load, 1 -> N devices.

BASELINE.md's second north star is >=90% efficiency from 1 to 4 hosts. Env
shards never communicate (embarrassingly parallel), so rollout scaling is
limited only by SPMD dispatch overhead; PPO adds one gradient all-reduce per
minibatch. This harness measures weak-scaling efficiency on whatever devices
exist: the cards of a host (or several hosts through jax.distributed) in
production, the 8-virtual-CPU-device mesh in the tests, where the numbers
measure core contention, not an interconnect.
"""

from __future__ import annotations

import time
from typing import List, Optional

import jax

import gym_fishing_tpu as gft
from gym_fishing_tpu.agents.policies import escapement
from gym_fishing_tpu.batch import batched_reset, batched_step
from gym_fishing_tpu.shard import make_mesh, shard_batch


def _throughput(env, params, pol, num_envs, num_steps, iters, mesh) -> float:
    def run(state, key):
        obs0 = jax.vmap(env.get_obs, in_axes=(None, 0))(params, state.env)

        def body(carry, k):
            st, obs = carry
            st, ts = batched_step(env, params, st, pol.act(obs), k, autoreset=True)
            return (st, ts.obs), ts.reward.sum()

        keys = jax.random.split(key, num_steps)
        (state2, _), rew = jax.lax.scan(body, (state, obs0), keys)
        return state2, rew.sum()

    run = jax.jit(run, donate_argnums=(0,))
    state = batched_reset(env, params, num_envs)
    if mesh is not None:
        state = shard_batch(state, mesh)
    key = jax.random.key(0)
    for _ in range(2):
        key, sub = jax.random.split(key)
        out = run(state, sub)
        jax.block_until_ready(out)
        state = out[0]
    # the fastest of ``iters`` timed calls: on a shared host a slow call says
    # more about the neighbours than about the program
    best = float("inf")
    for _ in range(iters):
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        out = run(state, sub)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
        state = out[0]
    return num_envs * num_steps / best


def weak_scaling(
    envs_per_device: int = 1 << 14,
    num_steps: int = 64,
    iters: int = 5,
    device_counts: Optional[List[int]] = None,
    devices=None,
) -> dict:
    """Throughput at fixed per-device batch as device count grows.

    efficiency(N) = throughput(N) / (N * throughput(1)).
    """
    if devices is None:
        devices = jax.devices()
    if device_counts is None:
        n = len(devices)
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n]
    env, params = gft.make("fishing-v1", sigma=0.05)
    pol = escapement(env, params)

    results = {}
    for n in device_counts:
        mesh = make_mesh(devices=devices[:n])
        results[n] = _throughput(env, params, pol, envs_per_device * n,
                                 num_steps, iters, mesh)
    base = results[device_counts[0]] / device_counts[0]
    return {
        "throughput": results,
        "efficiency": {n: results[n] / (n * base) for n in device_counts},
        "envs_per_device": envs_per_device,
    }
