"""The reader `metrics/step.graph_share.py` on hand-built Chrome traces:
0 where no step span holds a graph launch, 100 where each holds one, the
share in between, and None with no trace."""

import gzip
import json

import pytest

from kfbench import harness


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur,
            "args": {"correlation": int(ts)}}


def _frame(t0, graphed):
    """A frame at t0 (us): the step span [10, 80] with a stage span inside
    it, a kernel launch or graph launches in both, and a graph launch in
    the upload, outside the step, in either case."""
    ev = [_x("cpu_op", "kinfu.session.pipeline", t0, 100),
          _x("cpu_op", "kinfu.session.upload", t0, 10),
          _x("cuda_runtime", "cudaGraphLaunch", t0 + 5, 1),
          _x("cpu_op", "kinfu.session.step", t0 + 10, 70),
          _x("cpu_op", "kinfu.step.icp", t0 + 20, 20)]
    if graphed:
        ev += [_x("cuda_runtime", "cudaGraphLaunch", t0 + 12, 2),
               _x("cuda_driver", "cuGraphLaunch", t0 + 25, 2)]
    else:
        ev += [_x("cuda_runtime", "cudaLaunchKernel", t0 + 12, 1),
               _x("cuda_driver", "cuLaunchKernel", t0 + 25, 1)]
    return ev


def _ctx(tmp_path, events):
    path = tmp_path / "trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return {"trace": {"log": [f"chrome trace written to {path}"]}}


@pytest.mark.parametrize("graphed, want", [
    ((False, False, False), 0.0),
    ((True, True, True), 100.0),
    ((True, False, True, False), 50.0),
], ids=["eager", "graphed", "half"])
def test_share(tmp_path, graphed, want):
    events = [e for k, g in enumerate(graphed) for e in _frame(110.0 * k, g)]
    assert harness.read_metric("step.graph_share", _ctx(tmp_path, events)) == pytest.approx(want)


def test_no_trace(tmp_path):
    assert harness.read_metric("step.graph_share", {}) is None
    assert harness.read_metric("step.graph_share", {"trace": {"log": []}}) is None
    # a trace with no step span, and one that cannot be read
    events = [e for e in _frame(0.0, True) if e["name"] != "kinfu.session.step"]
    assert harness.read_metric("step.graph_share", _ctx(tmp_path, events)) is None
    bad = tmp_path / "bad.json.gz"
    bad.write_bytes(b"not gzip")
    ctx = {"trace": {"log": [f"chrome trace written to {bad}"]}}
    assert harness.read_metric("step.graph_share", ctx) is None
