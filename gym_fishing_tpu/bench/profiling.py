"""Tracing / profiling harness (SURVEY.md §5.1).

The reference has no profiling story; here: a context manager around
`jax.profiler` producing Perfetto/TensorBoard traces of the rollout or train
step, plus a timing helper that brackets device work with block_until_ready
(the only correct way to time XLA programs).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace into ``logdir``, viewable in TensorBoard /
    Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kw) -> dict:
    """Wall-time a jitted function with proper device synchronization."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
        jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return {"seconds_total": dt, "seconds_per_call": dt / iters, "iters": iters}
