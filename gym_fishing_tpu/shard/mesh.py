"""Device-mesh sharding for the env engine + learner (SURVEY.md §2.4).

The reference has no parallelism of any kind (single Python process; SURVEY.md
§2.4 "reference: none exist"). This module is the build-side equivalent of a
distributed runtime, on device:

- env instances shard over a 1-D ``("envs",)`` mesh (embarrassingly parallel
  — env shards never communicate);
- learner parameters are replicated; XLA inserts the collectives from the
  sharding annotations (NCCL between the GPUs of a host and across hosts).
  For PPO it currently all-gathers the trajectory and runs the whole update
  on every device;
- multi-host entry is standard SPMD: `jax.distributed.initialize()`, one
  process per host, every process runs the same jitted program.

TP/PP/SP/EP are deliberately N/A (SURVEY.md §2.4): the policy MLP is tiny and
pure-DP; there is no large model to shard. Documented, not built.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENVS_AXIS = "envs"


def is_distributed_initialized() -> bool:
    """True iff `jax.distributed.initialize` has already run in this process.

    Checked via the distributed client handle — NEVER via
    `jax.process_count()`, which initializes the local backend as a side
    effect (after which `initialize()` raises).
    """
    try:
        from jax._src import distributed as _dist

        return _dist.global_state.client is not None
    except Exception:  # pragma: no cover - private-API drift safety net
        return False


def distributed_init(**kwargs) -> None:
    """Multi-host SPMD entry: call once per host process BEFORE any device use.

    Thin wrapper over `jax.distributed.initialize` — XLA's collectives are
    the comms backend; no MPI layer is needed.
    No-op when already initialized or when no coordinator is configured
    (single-host). Must run before anything touches the backend (including
    `jax.devices()` / `jax.process_count()`).

    kwargs: `coordinator_address`, `num_processes`, `process_id` (all
    forwarded); coordinator may also come from $JAX_COORDINATOR. Nothing is
    autodetected: without a coordinator this is single-host.
    """
    if is_distributed_initialized():
        return
    coord = kwargs.pop("coordinator_address", None) or os.environ.get(
        "JAX_COORDINATOR"
    )
    if coord is None:
        return  # single-host
    jax.distributed.initialize(coordinator_address=coord, **kwargs)


def make_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """1-D mesh over the env axis. Uses all addressable devices by default."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (ENVS_AXIS,))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding for batched env state / trajectories."""
    return NamedSharding(mesh, P(ENVS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully-replicated sharding (learner params, scalars)."""
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh):
    """Place a *globally sized* batched pytree sharded over the mesh.

    Single-process only: `device_put` of a host array onto a sharding that
    spans non-addressable devices is invalid. In a multi-process program,
    build each host's local slice and use `host_local_to_global` instead.
    """
    if jax.process_count() > 1:
        raise RuntimeError(
            "shard_batch is single-process only; build the per-host slice "
            "and call host_local_to_global(tree, mesh) in multi-host programs"
        )
    return jax.device_put(tree, env_sharding(mesh))


def host_local_to_global(tree, mesh: Mesh):
    """Per-process local batch -> one global jax.Array per leaf.

    Each process passes its OWN slice (leading axis = its share of the global
    env count, identical layout across processes); leaves assemble into global
    arrays sharded over the mesh's env axis via
    `jax.make_array_from_process_local_data` — the only correct way to build a
    sharded array spanning non-addressable devices. Degenerates to a plain
    device_put layout under one process.
    """
    s = env_sharding(mesh)
    nproc = jax.process_count()

    def conv(x):
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(
            s, x, (x.shape[0] * nproc,) + x.shape[1:]
        )

    return jax.tree.map(conv, tree)


def replicate(tree, mesh: Mesh):
    """Replicate a (host-identical) pytree over every device of the mesh.

    Multi-process safe: with >1 process the full per-host value IS the local
    data of a fully-replicated global array.
    """
    s = replicated(mesh)
    if jax.process_count() == 1:
        return jax.device_put(tree, s)
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            s, np.asarray(x), np.shape(x)
        ),
        tree,
    )


def constrain_envs(tree, mesh: Mesh):
    """In-graph sharding constraint on the env axis (use inside jit)."""
    s = env_sharding(mesh)
    return jax.tree.map(lambda x: jax.lax.with_sharding_constraint(x, s), tree)


def state_checksum(tree) -> jnp.ndarray:
    """Debug-mode cross-host divergence check (SURVEY.md §5.2).

    Sum-reduce every float leaf to one scalar; in SPMD every process must
    compute the same value (jit of this under the mesh all-reduces
    automatically). Compare across hosts to detect divergence.

    Accumulates in the widest float actually enabled (f64 needs jax_enable_x64;
    asking for f64 with x64 off silently downcasts to f32, so be explicit).
    """
    acc = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    leaves = [jnp.sum(x.astype(acc)) for x in jax.tree.leaves(tree)
              if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)]
    return jnp.sum(jnp.stack(leaves)) if leaves else jnp.zeros(())
