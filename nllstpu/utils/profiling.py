"""Profiling / timing helpers.

Reference parity: the reference embeds nanosecond timers around cost,
gradient and solve phases (src/utils.jl:54-60, src/structs.jl:86-92).  Under
jit those phases fuse into one XLA computation, so the equivalents here are
(a) a wall timer for whole compiled calls that waits for the device with
``jax.block_until_ready``, and (b) a thin wrapper over ``jax.profiler``
traces for op-level attribution.
"""

from __future__ import annotations

import contextlib
import time

import jax


def timed(fn, *args, repeats: int = 3):
    """Best-of-N wall time of a compiled call, each run waited for with
    ``jax.block_until_ready``.

    Returns ``(best_seconds, last_output)``."""
    best = float("inf")
    out = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler`` trace context (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
