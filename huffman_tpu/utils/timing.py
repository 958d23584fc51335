"""Timing and profiling harness.

Counterpart of the reference's CUDA-event timing loops
(reference: main_test_cu.cu:117-156 — 10-run kernel average with
cudaEventRecord — and hist.cu:92-117) and gettimeofday CPU timing
(main_test_cu.cu:32-36): async dispatch is fenced with
jax.block_until_ready, warmup runs absorb compilation, and an optional
jax.profiler trace covers what nvprof did for the reference.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

import jax


def time_fn(fn: Callable[[], Any], iters: int = 10, warmup: int = 2) -> dict:
    """Average wall time of fn over `iters` runs after `warmup` runs.

    Mirrors the reference's 10-iteration kernel timing loop
    (main_test_cu.cu:117,141-156), with block_until_ready standing in for
    cudaEventSynchronize.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "mean_ms": 1e3 * sum(times) / len(times),
        "min_ms": 1e3 * times[0],
        "median_ms": 1e3 * times[len(times) // 2],
        "iters": iters,
    }


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Optional jax.profiler trace (view with TensorBoard/XProf)."""
    if not log_dir:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


class HostTimer:
    """gettimeofday-style host timer (reference: main_test_cu.cu:32-36)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = 1e3 * (time.perf_counter() - self.t0)
        return False
