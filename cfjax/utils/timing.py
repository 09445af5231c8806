"""Wall-clock timing of device work."""

from __future__ import annotations

import statistics
import time

import jax


def time_call(fn, *args, warmup: int = 2, reps: int = 7) -> float:
    """Median seconds per call of `fn(*args)`. The first `warmup` calls
    (compilation included) are not timed; every timed call ends in
    `block_until_ready`, so the time covers the device work, not only
    its dispatch."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)
