"""Reduce a torch.profiler trace of the traced frames to what the
per-layer readers take.

The benchmark's own span is `kfbench.frame`, a `record_function` range
around each `pipeline()` call. Inside a frame the host's time is split by
the CUDA runtime calls the trace holds: until the last copy that starts
before the frame's first kernel launch the host uploads the frame; after
the first copy that starts after its last launch it fetches the pose;
in between it enqueues the step. Outside the frames it runs the harness.

  - window: from the first frame's start to the last frame's end;
  - busy: the union of the device's operations (kernels, copies, sets)
    within the window;
  - launches: the kernels among them;
  - idle gaps: the rest of the window, each labelled by what the host did
    at its middle.
The chrome trace goes to the checkout's build/kfbench/ (gzip).
"""

from __future__ import annotations

import bisect
import collections
from pathlib import Path
from typing import Dict, List, Optional, Tuple

FRAME = "kfbench.frame"
TRACE_DIR = Path(__file__).resolve().parent.parent / "build" / "kfbench"


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _phases(frames, runtime) -> List[Tuple[float, float, str]]:
    """(start, end, label) of the host's phases over the frames."""
    out = []
    starts = [r[0] for r in runtime]
    for fs, fe in frames:
        lo, hi = bisect.bisect_left(starts, fs), bisect.bisect_right(starts, fe)
        inside = runtime[lo:hi]
        launches = [r for r in inside if "LaunchKernel" in r[2] or "cuLaunch" in r[2]]
        copies = [r for r in inside if "Memcpy" in r[2]]
        first_l = launches[0][0] if launches else fe
        last_l = launches[-1][0] if launches else fs
        up = max([r[1] for r in copies if r[0] < first_l], default=fs)
        fetch = min([r[0] for r in copies if r[0] > last_l], default=fe)
        up = min(max(up, fs), fe)
        fetch = min(max(fetch, up), fe)
        out += [(fs, up, "upload"), (up, fetch, "step enqueue"), (fetch, fe, "pose fetch")]
    return out


def _events(prof):
    """(name, is_device, start us, end us) of every event, from the raw
    kineto results (`prof.events()` builds a tree of them first, which
    takes far longer)."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns() * 1e-3,
             e.end_ns() * 1e-3) for e in prof.profiler.kineto_results.events()]


def reduce(prof, file: Optional[str] = "trace.json.gz") -> dict:
    """The trace's reduction; the chrome trace is written to TRACE_DIR /
    `file` (not at all where `file` is None)."""
    frames, device_ops, runtime = [], [], []
    for name, on_device, a, b in _events(prof):
        if name == FRAME:
            if not on_device:
                frames.append((a, b))
            continue
        if on_device:
            device_ops.append((a, b, name))
        elif name.startswith("cu"):
            runtime.append((a, b, name))
    frames.sort()
    runtime.sort()
    ctx: Dict = {"frames": len(frames), "log": []}
    if not frames:
        ctx.update(busy_s=0.0, window_s=0.0, breakdown={"device_ops": [], "idle_gaps": []})
        return ctx
    w0, w1 = frames[0][0], frames[-1][1]
    ops = [(max(a, w0), min(b, w1), n) for a, b, n in device_ops if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in ops])
    busy_us = sum(b - a for a, b in busy)
    kernels = [o for o in ops if not _is_copy(o[2])]
    per_name: Dict[str, float] = collections.defaultdict(float)
    for a, b, n in ops:
        per_name[n] += b - a
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]

    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    phases = _phases(frames, runtime)
    pstarts = [p[0] for p in phases]

    def label(mid):
        i = bisect.bisect_right(pstarts, mid) - 1
        if i >= 0 and phases[i][0] <= mid <= phases[i][1]:
            return phases[i][2]
        return "harness"

    by_label: Dict[str, float] = collections.defaultdict(float)
    longest = []
    for a, b in gaps:
        lab = label(0.5 * (a + b))
        by_label[lab] += b - a
        longest.append((b - a, lab))
    longest.sort(reverse=True)
    idle = [[f"total {k}", v * 1e-6] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])]
    idle += [[f"longest {lab}", d * 1e-6] for d, lab in longest[:10 - len(idle)]]
    ctx.update(
        busy_s=busy_us * 1e-6, window_s=(w1 - w0) * 1e-6, launches=len(kernels),
        breakdown={"device_ops": [[n[:120], t * 1e-6] for n, t in top], "idle_gaps": idle})
    if file is None:
        return ctx
    try:
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        path = TRACE_DIR / file
        prof.export_chrome_trace(str(path))
        ctx["log"].append(f"chrome trace written to {path}")
    except Exception as exc:  # the trace file is for people; the metrics do not need it
        ctx["log"].append(f"chrome trace not written: {exc}")
    return ctx
