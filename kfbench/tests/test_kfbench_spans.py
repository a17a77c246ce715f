"""The readers of the program's spans (`kfbench/spans.py`, the metrics that
read it): on a hand-built Chrome trace, the attribution of device
operations to spans by correlation id, host self time, the division by
frames and the idle-gap labels; on a traced CPU run of a cell, the host
readers give a value and the device readers none."""

import time

import pytest
import torch

from kfbench import harness, spans

from .conftest import small_entry

torch.set_num_threads(2)


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur,
         "args": {"External id": 0}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _frame(t0, corr0):
    """One frame at t0 (us): root [0, 100], upload [0, 10], step [10, 80]
    holding icp [20, 40] and integrate [40, 60], fetch [85, 100]; a copy in
    the upload, a `cudaLaunchKernel` in icp, a `cuLaunchKernel` in integrate and
    a launch in the step's own time."""
    op = "cpu_op"
    ev = [_x("user_annotation", "kfbench.frame", t0, 100),
          _x(op, "kinfu.session.pipeline", t0, 100),
          _x(op, "kinfu.session.upload", t0, 10),
          _x(op, "kinfu.session.step", t0 + 10, 70),
          _x(op, "kinfu.step.icp", t0 + 20, 20),
          _x(op, "kinfu.step.integrate", t0 + 40, 20),
          _x(op, "kinfu.session.fetch", t0 + 85, 15),
          _x("gpu_user_annotation", "kinfu.step.icp", t0 + 30, 20),
          _x(op, "aten::add", t0 + 24, 2),
          _x("cuda_runtime", "cudaMemcpyAsync", t0 + 5, 1, corr0),
          _x("gpu_memcpy", "Memcpy HtoD", t0 + 6, 2, corr0),
          _x("cuda_runtime", "cudaLaunchKernel", t0 + 25, 1, corr0 + 1),
          _x("kernel", "icp_kernel", t0 + 30, 20, corr0 + 1),
          _x("cuda_driver", "cuLaunchKernel", t0 + 45, 1, corr0 + 2),
          _x("kernel", "face_integrate_kernel", t0 + 50, 20, corr0 + 2),
          _x("cuda_runtime", "cudaLaunchKernel", t0 + 15, 1, corr0 + 3),
          _x("kernel", "where_kernel", t0 + 70, 5, corr0 + 3)]
    return ev


def _trace():
    """Two frames, at 0 and 110 us, and two operations launched outside
    every span: one running [-5, 2] (clipped to the window at 0), one
    [101, 103] between the frames."""
    return (_frame(0.0, 10) + _frame(110.0, 20)
            + [_x("cuda_runtime", "cudaLaunchKernel", -10, 1, 1),
               _x("kernel", "harness_kernel", -5, 7, 1),
               _x("cuda_runtime", "cudaLaunchKernel", 100.5, 0.2, 2),
               _x("kernel", "harness_kernel", 101, 2, 2),
               {"ph": "s", "cat": "ac2g", "name": "flow", "id": 10, "ts": 5}])


def test_hand_built_trace():
    t = spans.table(_trace())
    assert t["frames"] == 2 and t["has_device"]
    s = t["spans"]
    approx = pytest.approx
    assert set(s) == {"kinfu.session.pipeline", "kinfu.session.upload", "kinfu.session.step",
                      "kinfu.step.icp", "kinfu.step.integrate", "kinfu.session.fetch"}
    assert all(r["count"] == 1 for r in s.values())
    # host ms a frame, and self time: the parts the kinfu children cover
    assert s["kinfu.session.pipeline"]["host_ms"] == approx(0.100)
    assert s["kinfu.session.pipeline"]["self_ms"] == approx(0.005)
    assert s["kinfu.session.step"]["host_ms"] == approx(0.070)
    assert s["kinfu.session.step"]["self_ms"] == approx(0.030)
    assert s["kinfu.step.icp"]["self_ms"] == approx(0.020)
    # device ms a frame, by the launch call's correlation id
    assert s["kinfu.step.icp"]["device_ms"] == approx(0.020)
    assert s["kinfu.step.integrate"]["device_ms"] == approx(0.020)
    assert s["kinfu.session.upload"]["device_ms"] == approx(0.002)
    assert s["kinfu.session.upload"]["launches"] == 0
    assert s["kinfu.session.step"]["device_ms"] == approx(0.045)
    assert s["kinfu.session.step"]["device_self_ms"] == approx(0.005)
    assert s["kinfu.session.step"]["launches"] == 3
    assert s["kinfu.session.pipeline"]["device_ms"] == approx(0.047)
    assert s["kinfu.session.fetch"]["device_ms"] == 0
    # the window [0, 210]: the early operation clipped to 2 us, the other 2 us
    assert t["outside_ms"] == approx(0.002)
    assert t["device_ms"] == approx(0.049)
    assert sum(r["device_self_ms"] for r in s.values()) + t["outside_ms"] == approx(0.049)
    assert t["busy_ms"] == approx(0.049)
    assert t["window_ms"] == approx(0.105)
    # idle gaps by the innermost span at their middle: [2, 6] upload,
    # [8, 30] and [118, 140] step, [75, 101] and [185, 210] fetch,
    # [103, 116] between the frames
    assert t["idle_ms"] == approx({"kinfu.session.upload": 0.002, "kinfu.session.step": 0.022,
                                   "kinfu.session.fetch": 0.0255, "harness": 0.0065})
    assert s["kinfu.session.step"]["idle_ms"] == approx(0.022)
    assert sum(t["idle_ms"].values()) + t["busy_ms"] == approx(t["window_ms"])
    assert "kinfu.step.icp" in spans.format_table(t)


def test_readers_on_hand_built_trace(tmp_path):
    import gzip
    import json

    path = tmp_path / "trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": _trace()}, f)
    ctx = {"trace": {"log": [f"chrome trace written to {path}"]}}
    assert harness.read_metric("step.enqueue_ms", ctx) == pytest.approx(0.070)
    assert harness.read_metric("session.fetch_wait_ms", ctx) == pytest.approx(0.015)
    assert harness.read_metric("icp.ms", ctx) == pytest.approx(0.020)
    assert harness.read_metric("fusion.ms", ctx) == pytest.approx(0.020)
    assert harness.read_metric("raycast.ms", ctx) is None
    assert harness.read_metric("stream.shift_ms", ctx) is None
    assert spans.main([str(path)]) == 0
    # a trace that cannot be read gives nothing; one this run did not write is not read
    path.write_bytes(b"not gzip")
    ctx = {"trace": {"log": [f"chrome trace written to {path}"]}}
    assert harness.read_metric("icp.ms", ctx) is None and "not read" in ctx["trace"]["log"][-1]
    assert harness.read_metric("step.enqueue_ms", {"trace": {"log": []}}) is None
    assert harness.read_metric("step.enqueue_ms", {}) is None


def test_traced_cpu_run(monkeypatch):
    parsed = []
    parse = spans.parse
    monkeypatch.setattr(spans, "parse", lambda p: parsed.append(p) or parse(p))
    monkeypatch.setattr(harness, "TRACE_FRAMES", 3)
    res = harness.run(small_entry("stream512.orbit"), 2**33 + 5, 0.3, True, torch.device("cpu"),
                      time.perf_counter(), check_span=3, max_warmup=120)
    m = res["metrics"]
    assert m["step.enqueue_ms"]["value"] > 0 and m["session.fetch_wait_ms"]["value"] > 0
    for name in ("icp.ms", "fusion.ms", "raycast.ms", "stream.shift_ms"):
        assert name not in m
    assert len(parsed) == 1
    assert any(line.startswith("kinfu spans read from the chrome trace") for line in res["log"])
