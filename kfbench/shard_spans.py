"""The sharded step's spans in rank 0's Chrome trace, for the `shard.*`
readers (metrics/).

A rank of a sharded cell (`ranks.py`) runs no session: its frame is the
program's span `kinfu.shard.step` (`parallel/sharded.py`), which holds the
stage spans, the halo exchange `kinfu.shard.halo` and each collective
`kinfu.shard.collective` (`parallel/mesh.py`). `table` is `spans.table`
with that span as the root of a frame where the one-card table takes
`kinfu.session.pipeline`: the same per-frame rows (host, device and
launches of each span, divided by the count of roots). Only rank 0 writes
its Chrome trace; the other ranks' reduced traces (`ctx["rank_traces"]`,
`trace.reduce`) hold their busy time and their largest device operations.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

from kfbench import spans

ROOT = "kinfu.shard.step"
HALO = "kinfu.shard.halo"
COLLECTIVE = "kinfu.shard.collective"


def table(events: list) -> Optional[dict]:
    """`spans.table` of a trace's events with each `ROOT` span as a frame's
    root; None where the trace holds no `ROOT` span (a one-card session's
    trace, or a program without the span)."""
    if not any(e.get("name") == ROOT and e.get("cat") == "cpu_op" for e in events):
        return None
    return spans.table([dict(e, name=spans.ROOT) if e.get("name") == ROOT else e
                        for e in events if e.get("name") != spans.ROOT])


def read(ctx) -> Optional[dict]:
    """Rank 0's table, parsed once and kept in its trace context; None where
    the run was not sharded (its context has no "rank_traces"), wrote no
    trace, or its trace holds no `ROOT` span."""
    if (ctx or {}).get("rank_traces") is None:
        return None
    tr = ctx.get("trace") or {}
    if "kinfu_shard_spans" not in tr:
        path = next((line[len(spans._WRITTEN):] for line in tr.get("log", [])
                     if line.startswith(spans._WRITTEN)), None)
        tr["kinfu_shard_spans"] = None
        if path is not None:
            t0 = time.perf_counter()
            try:
                tr["kinfu_shard_spans"] = table(spans._load(Path(path)))
            except (OSError, EOFError, ValueError) as exc:  # a run's metrics outlive its trace
                tr.setdefault("log", []).append(f"shard spans not read: {exc!r}")
            else:
                tr.setdefault("log", []).append(
                    f"shard spans read from the chrome trace in {time.perf_counter() - t0:.3f} s")
    return tr.get("kinfu_shard_spans")


def device_ms(ctx, name: str) -> Optional[float]:
    """Rank 0's device ms a frame of the operations launched inside the
    spans `name`; None where they did not run or the trace holds no device
    operation."""
    t = read(ctx)
    if t is None or not t["has_device"] or name not in t["spans"]:
        return None
    return t["spans"][name]["device_ms"]
