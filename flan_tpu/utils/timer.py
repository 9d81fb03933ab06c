"""Timer: wall-clock stopwatch + device-honest timing helper.

Port of the reference Timer (reference: src/flan/Utility/Timer.h). JAX
dispatch is asynchronous, so device timing waits on the results with
block_until_ready (SURVEY.md section 5 suggests jax profiler traces;
`time_jax` is the quick equivalent of the reference's manual "ms per
call" helper, tests/flanTest.cpp:59-68).
"""
from __future__ import annotations

import time
from typing import Callable


class Timer:
    """Chrono-style stopwatch (reference Utility/Timer.h)."""

    def __init__(self):
        self._start = None
        self._elapsed = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None
        return self._elapsed

    def reset(self) -> None:
        self._start = None
        self._elapsed = 0.0

    @property
    def elapsed(self) -> float:
        if self._start is not None:
            return self._elapsed + (time.perf_counter() - self._start)
        return self._elapsed


def sync(tree) -> None:
    """Wait for every device array in `tree` to finish computing."""
    import jax
    jax.block_until_ready(tree)


def time_jax(fn: Callable, *args, reps: int = 3, warmup: int = 1) -> float:
    """Best-of-reps wall time of fn(*args), waiting on the device."""
    for _ in range(warmup):
        sync(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best
