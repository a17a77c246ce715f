"""Profiling helpers on torch.profiler and CUDA events (port of
kinfu_tpu/utils/profiling.py, which wraps jax.profiler).

  - `trace(logdir)`: context manager around `torch.profiler.profile` that
    writes a Chrome trace of the host and device timeline
    (`logdir/trace.json`, viewable in Perfetto or chrome://tracing).
  - `device_time(fn, *args)`: the best of `reps` timed calls of fn(*args).
    When an argument is a CUDA tensor, each call is bracketed by CUDA
    events on the current stream (the device's time from the first event
    to the second); otherwise by the host clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Tuple

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write its Chrome trace to logdir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.device.type == "cuda" for a in args)


def device_time(fn: Callable, *args, reps: int = 3) -> Tuple[float, Any]:
    """Best-of-reps seconds for fn(*args), after one warm-up call. Returns
    (seconds, last_result)."""
    out = fn(*args)  # warm-up (a kernel library builds at its first launch)
    best = float("inf")
    if _on_cuda(args):
        torch.cuda.synchronize()
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) * 1e-3)
        return best, out
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best, out
