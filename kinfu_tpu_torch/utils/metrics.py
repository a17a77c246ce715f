"""Structured per-frame metrics (after kinfu_tpu/utils/metrics.py: json
only).

The reference's entire observability story is one std::cout wall-clock line
per frame (kinectfusion.cpp:122-123). Here every frame yields a structured
record (ms, ICP inliers, tracking state) that can stream to JSONL for
offline analysis, plus running aggregates. The time of each stage inside a
frame is in a profiler's trace (utils/profiling.py, `span`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class FrameMetrics:
    frame: int
    tracking_ok: bool
    total_ms: float
    icp_inliers: int = 0

    def to_json(self) -> str:
        return json.dumps(
            {
                "frame": self.frame,
                "tracking_ok": self.tracking_ok,
                "total_ms": round(self.total_ms, 3),
                "icp_inliers": self.icp_inliers,
            }
        )


class MetricsRecorder:
    """Collects per-frame metrics; optionally streams JSONL to a file."""

    def __init__(self, jsonl_path: Optional[str] = None, echo: bool = False):
        self.frames: List[FrameMetrics] = []
        self._file = open(jsonl_path, "w") if jsonl_path else None
        self.echo = echo

    def record(self, m: FrameMetrics) -> None:
        self.frames.append(m)
        if self._file:
            self._file.write(m.to_json() + "\n")
            self._file.flush()
        if self.echo:
            # reference-parity console line (kinectfusion.cpp:122-123)
            print(f"Frame:{m.frame}||Time:{m.total_ms:.1f} ms")

    def summary(self) -> Dict[str, float]:
        if not self.frames:
            return {}
        times = [m.total_ms for m in self.frames]
        # skip the first frame (compile) for the steady-state figure
        steady = times[1:] if len(times) > 1 else times
        return {
            "frames": len(self.frames),
            "tracking_failures": sum(not m.tracking_ok for m in self.frames),
            "mean_ms": sum(steady) / len(steady),
            "median_ms": sorted(steady)[len(steady) // 2],
            "max_ms": max(steady),
        }

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
