"""Learner state: parameters, optimizer state and step count as one pytree.

``params``, ``opt_state`` and ``step`` are pytree leaves (they shard,
checkpoint and cross ``jit`` as arrays); ``apply_fn`` and ``tx`` are static
metadata, fixed for the life of a run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: Any
    params: Any
    opt_state: Any
    apply_fn: Callable = dataclasses.field(metadata=dict(static=True))
    tx: optax.GradientTransformation = dataclasses.field(
        metadata=dict(static=True)
    )

    @classmethod
    def create(cls, *, apply_fn: Callable, params: Any,
               tx: optax.GradientTransformation) -> "TrainState":
        return cls(
            step=jnp.zeros((), jnp.int32),
            params=params,
            opt_state=tx.init(params),
            apply_fn=apply_fn,
            tx=tx,
        )

    def apply_gradients(self, *, grads) -> "TrainState":
        """One optimizer update of ``params`` by ``grads``; ``step`` + 1."""
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(
            step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            opt_state=opt_state,
        )

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)
