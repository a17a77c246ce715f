"""Profiling helpers on torch.profiler and CUDA events (port of
kinfu_tpu/utils/profiling.py, which wraps jax.profiler).

  - `span(name, frame=None, **args)`: a named range of the program (the
    session's and the step's stages, the sharded step's exchanges),
    recorded on the host's timeline while a torch profiler records, and
    the shared null context otherwise;
  - `cut_at_spans(cuts)`: while it is open, each outermost span calls
    `cuts` at its boundaries instead (`Cuts`; the CUDA graph capture of
    the step cuts its work there, pipeline/graphed.py);
  - `trace(logdir)`: context manager around `torch.profiler.profile` that
    writes a Chrome trace of the host and device timeline, the spans
    included (`logdir/trace.json`, viewable in Perfetto or
    chrome://tracing).
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
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
#: the `Cuts` that spans call while `cut_at_spans` is open
_cuts = None


def profiler_enabled() -> bool:
    """True while a torch profiler records (torch.profiler.profile, the
    autograd profiler). Reads torch's private flag, here alone."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, frame=None, **args):
    """A context manager around one stage of the program, named `name`.

    While a profiler records it is a host range of the profiler (torch's
    `_RecordFunctionFast`, a "cpu_op" event of the Chrome trace) on the
    trace's own clock, with {"frame": frame} and `args` (counters such as
    the bytes a collective moves) as its args where given (the trace
    shows them under `record_shapes=True`); each device operation
    ties to the span that launched it through its launch call's
    `correlation` id. Not `torch.profiler.record_function`: kineto copies
    a user annotation onto the device's timeline as well, where it reads
    as one more device operation. Otherwise `span` is one shared
    `contextlib.nullcontext`, and costs the flag check. While
    `cut_at_spans` is open, it is the boundary of a `Cuts` instead.
    """
    if _cuts is not None:
        return _cuts.span(name)
    if not profiler_enabled():
        return _OFF
    if frame is not None:
        args["frame"] = frame
    if not args:  # torch aborts on keyword_values=None
        return _RecordFunctionFast(name)
    return _RecordFunctionFast(name, keyword_values=args)


class Cuts:
    """The boundaries of the outermost spans opened while `cut_at_spans`
    is open: `enter(name)` as one opens, `leave(name)` as it closes.
    Spans inside it are not cut. Subclasses act at the boundaries; this
    one records the names in order (`names`)."""

    def __init__(self):
        self.names = []
        self._depth = 0

    def enter(self, name: str) -> None:
        self.names.append(name)

    def leave(self, name: str) -> None:
        pass

    @contextlib.contextmanager
    def span(self, name: str):
        self._depth += 1
        outermost = self._depth == 1
        try:
            if outermost:
                self.enter(name)
            yield
        finally:
            self._depth -= 1
        if outermost:
            self.leave(name)


@contextlib.contextmanager
def cut_at_spans(cuts: Cuts):
    """Within the block, `span` calls `cuts` at its boundaries."""
    global _cuts
    if _cuts is not None:
        raise RuntimeError("spans are already being cut")
    _cuts = cuts
    try:
        yield cuts
    finally:
        _cuts = None


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
