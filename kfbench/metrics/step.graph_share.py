"""step.graph_share: the share of the traced frames, in %, whose program
span `kinfu.session.step` (`pipeline/session.py`) holds at least one CUDA
graph launch, a `cudaGraphLaunch` or `cuGraphLaunch` call of the run's
Chrome trace: 100 where the step replays from CUDA graphs, 0 where its
kernels are launched one by one. None where the run wrote no trace or the
trace holds no such span."""

import bisect
from pathlib import Path

from kfbench import spans

STEP = "kinfu.session.step"
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def share(events):
    """The share, in %, of a Chrome trace's `STEP` spans that hold a graph
    launch; None where it has none."""
    steps, launches = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "cpu_op" and e.get("name") == STEP:
            steps.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                str(e.get("name", "")).startswith(GRAPH_LAUNCHES):
            launches.append(float(e["ts"]))
    if not steps:
        return None
    launches.sort()
    held = sum(bisect.bisect_left(launches, a) < bisect.bisect_right(launches, b)
               for a, b in steps)
    return 100.0 * held / len(steps)


def read(ctx):
    tr = (ctx or {}).get("trace") or {}
    path = next((line[len(spans._WRITTEN):] for line in tr.get("log", [])
                 if line.startswith(spans._WRITTEN)), None)
    if path is None:
        return None
    try:
        return share(spans._load(Path(path)))
    except (OSError, EOFError, ValueError):  # a run's metrics outlive its trace
        return None
