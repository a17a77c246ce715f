"""The program's own spans in a run's Chrome trace: per-frame host and
device time of each `kinfu.*` stage.

`kinfu_tpu_torch` opens a span (`utils/profiling.py::span`, a host range
of the profiler, "cpu_op" in the trace) at each stage of a frame, all
under one `kinfu.session.pipeline` root a frame. For each span name this
gives, a frame (each sum divided by the count of roots), in the order the
spans first open:

  - host_ms: its durations; self_ms: less the parts its `kinfu.*`
    children cover;
  - device_ms: the kernels, copies and sets whose launch call lies inside
    it (a device operation is matched to its launch call by the trace's
    `correlation` id, on `cuda*` and `cu*` calls alike: the port's
    kernels are launched with `cuLaunchKernel`); device_self_ms: those
    whose innermost span it is;
  - launches: the kernels among them;
  - idle_ms: the device's idle gaps, within the window from the first
    root's start to the last root's end, whose middle falls inside it
    while no child does. Gaps outside every span are `harness`; a trace
    with no device operation has no gaps.

The spans of one host thread are assumed: a launch or a gap is placed by
time alone. Device operations count within the window only (clipped to
it): `device_ms` is their sum, `outside_ms` the part launched outside
every span, `busy_ms` their union.

    python -m kfbench.spans [trace.json[.gz]]

prints the table (by default the last traced run's, build/kfbench/).
The per-layer readers (metrics/) call `read(ctx)`, which parses the trace
once a run, and only if that run wrote it.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from kfbench import trace

ROOT = "kinfu.session.pipeline"
PREFIX = "kinfu."
HARNESS = "harness"
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_WRITTEN = "chrome trace written to "


def _load(path: Path) -> list:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def _events(events: list):
    """(spans, launch start by correlation, device operations) of the
    trace: spans (start, end, name) sorted by start, outer first;
    operations (start, end, correlation, is_kernel)."""
    spans, launch_at, ops = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "cpu_op":
            if e["name"].startswith(PREFIX):
                a = float(e["ts"])
                spans.append((a, a + float(e["dur"]), e["name"]))
        elif cat in _LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                a = float(e["ts"])
                launch_at[c] = min(a, launch_at.get(c, a))
        elif cat in _DEVICE_CATS:
            a = float(e["ts"])
            ops.append((a, a + float(e["dur"]), (e.get("args") or {}).get("correlation"),
                        cat == "kernel"))
    spans.sort(key=lambda s: (s[0], -s[1]))
    return spans, launch_at, ops


def _nesting(spans) -> Tuple[List[int], List[float], List[int]]:
    """Each span's parent (-1 at the top) and the host's innermost span as
    steps: from times[k] on, span inner[k] (-1: none)."""
    parent, times, inner, stack = [], [], [], []

    def close_until(t):
        while stack and spans[stack[-1]][1] <= t:
            j = stack.pop()
            times.append(spans[j][1])
            inner.append(stack[-1] if stack else -1)

    for i, (a, _, _) in enumerate(spans):
        close_until(a)
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
        times.append(a)
        inner.append(i)
    close_until(float("inf"))
    return parent, times, inner


def _union(iv) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(b, out[-1][1]))
        else:
            out.append((a, b))
    return out


def table(events: list) -> Optional[dict]:
    """The per-frame table of a trace's events (the Chrome trace's
    `traceEvents`), or None when it holds no root span."""
    spans, launch_at, ops = _events(events)
    roots = [s for s in spans if s[2] == ROOT]
    if not roots:
        return None
    parent, times, inner = _nesting(spans)

    def innermost(t: float) -> int:
        k = bisect.bisect_right(times, t) - 1
        return inner[k] if k >= 0 else -1

    n = len(spans)
    dev_self, dev_all, kernels = [0.0] * n, [0.0] * n, [0] * n
    child_host = [0.0] * n
    for i, p in enumerate(parent):
        if p >= 0:
            child_host[p] += spans[i][1] - spans[i][0]
    w0, w1 = roots[0][0], roots[-1][1]
    inside = [(max(a, w0), min(b, w1), c, k) for a, b, c, k in ops if b > w0 and a < w1]
    outside = 0.0
    for a, b, corr, is_kernel in inside:
        t = launch_at.get(corr)
        i = innermost(t) if t is not None else -1
        if i < 0:
            outside += b - a
            continue
        dev_self[i] += b - a
        while i >= 0:
            dev_all[i] += b - a
            kernels[i] += is_kernel
            i = parent[i]
    busy = _union([(a, b) for a, b, _, _ in inside])

    idle: Dict[str, float] = collections.defaultdict(float)
    prev = w0
    for a, b in (busy + [(w1, w1)]) if ops else []:
        if a > prev:
            i = innermost(0.5 * (prev + a))
            idle[spans[i][2] if i >= 0 else HARNESS] += a - prev
        prev = max(prev, b)

    frames = len(roots)
    rows: Dict[str, Dict[str, float]] = {}
    for i, (a, b, name) in enumerate(spans):
        r = rows.setdefault(name, dict.fromkeys(
            ("count", "host_ms", "self_ms", "device_ms", "device_self_ms", "launches"), 0.0))
        r["count"] += 1
        r["host_ms"] += b - a
        r["self_ms"] += b - a - child_host[i]
        r["device_ms"] += dev_all[i]
        r["device_self_ms"] += dev_self[i]
        r["launches"] += kernels[i]
    for name, r in rows.items():
        for k in ("host_ms", "self_ms", "device_ms", "device_self_ms"):
            r[k] *= 1e-3 / frames
        r["launches"] /= frames
        r["count"] /= frames
        r["idle_ms"] = idle.get(name, 0.0) * 1e-3 / frames
    return {"frames": frames, "spans": rows, "has_device": bool(ops),
            "device_ms": sum(b - a for a, b, _, _ in inside) * 1e-3 / frames,
            "outside_ms": outside * 1e-3 / frames,
            "busy_ms": sum(b - a for a, b in busy) * 1e-3 / frames,
            "window_ms": (w1 - w0) * 1e-3 / frames,
            "idle_ms": {k: v * 1e-3 / frames for k, v in idle.items()}}


def parse(path) -> Optional[dict]:
    """`table` of the Chrome trace at `path` (.json or .json.gz)."""
    return table(_load(Path(path)))


def read(ctx) -> Optional[dict]:
    """The run's table, parsed once and kept in the run's trace context;
    None where the run wrote no trace or the trace holds no span."""
    tr = (ctx or {}).get("trace") or {}
    if "kinfu_spans" not in tr:
        path = next((line[len(_WRITTEN):] for line in tr.get("log", [])
                     if line.startswith(_WRITTEN)), None)
        tr["kinfu_spans"] = None
        if path is not None:
            t0 = time.perf_counter()
            try:
                tr["kinfu_spans"] = parse(path)
            except (OSError, EOFError, ValueError) as exc:  # a run's metrics outlive its trace
                tr["log"].append(f"kinfu spans not read: {exc!r}")
            else:
                tr["log"].append(f"kinfu spans read from the chrome trace in "
                                 f"{time.perf_counter() - t0:.3f} s")
    return tr.get("kinfu_spans")


def span_value(ctx, names, key: str, device: bool = False) -> Optional[float]:
    """The sum of `key` over the spans `names` a frame; None where none of
    them ran, or for a device reading where the trace holds no device
    operation."""
    t = read(ctx)
    if t is None or (device and not t["has_device"]):
        return None
    rows = [t["spans"][n] for n in names if n in t["spans"]]
    return sum(r[key] for r in rows) if rows else None


def format_table(t: dict) -> str:
    cols = ("host_ms", "self_ms", "device_ms", "device_self_ms", "launches", "idle_ms")
    lines = [f"{t['frames']} frames; ms a frame: window {t['window_ms']:.4f}, device busy "
             f"{t['busy_ms']:.4f}, device operations {t['device_ms']:.4f}, of them launched "
             f"outside every span {t['outside_ms']:.4f}; idle outside every span "
             f"({HARNESS}) {t['idle_ms'].get(HARNESS, 0.0):.4f}",
             f"{'span':<26}" + "".join(f"{c:>15}" for c in cols)]
    for name, r in t["spans"].items():
        lines.append(f"{name:<26}" + "".join(f"{r[c]:>15.4f}" for c in cols))
    return "\n".join(lines)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    path = Path(args[0]) if args else trace.TRACE_DIR / "trace.json.gz"
    t = parse(path)
    if t is None:
        print(f"kfbench.spans: no {ROOT} span in {path}", file=sys.stderr)
        return 1
    print(format_table(t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
