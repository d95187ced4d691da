"""Profiling helpers.

PyTorch port of ``sip_optimal_control_tpu/utils/profiling.py``: the JAX
package traces with jax.profiler, this package with torch.profiler (the
reference measures performance only through its google_benchmark
binaries, SURVEY section 5).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace_solve(log_dir: str):
    """Capture a torch.profiler trace (host ops, and the card's kernels
    when there is one) around the block; on exit it is written to
    ``log_dir/trace.json`` in the Chrome trace format (chrome://tracing,
    Perfetto).  Yields the profiler, whose ``key_averages()`` sums the
    time by op and kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed_block_until_ready(fn, *args, reps: int = 5):
    """Best and median wall time of ``fn(*args)`` over ``reps`` calls after
    one untimed call (kernel builds excluded), each call ended by a
    synchronize of the card so that the time covers its device work."""
    out = fn(*args)
    _synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return out, {"best_s": times[0], "p50_s": times[len(times) // 2]}
