"""The cell shard.big-orbit on the CPU, scaled down: its configuration
(kinfu-shard-floor, four Y slabs) and its mix (corridor-orbit) through the
sharded run (`kfbench/ranks.py`) on four gloo ranks, rank 0 in this
process; and the readers of the sharded step's spans (`shard_spans.py`,
`metrics/shard.*.py`) on hand-built traces.

The floor is cut to a 256x64x384 grid of 12 x 3 x 18 m (4.69 cm voxels):
the floor plan's 2:3, the reference's 3 m of height with the ceiling, the
walls, the blocks and the floor in the four 0.75 m bands, 16 rows a rank.
At this size, and 160x120 frames, the CPU runs the fused update's plain
versions (`fused_mode="on"`; the card runs the same update on its
kernels) with a 512 px raycast face. Its readings are this size's, not
the cell's: the fused integrate misses 8.6-9.4% of the reference's voxels
(the cell's limit, 12%, is kept) and the raycast 15-17% of its pixels
(test_kfbench_faults.py's small limit, 25%, is kept)."""

import copy
import gzip
import json
import re
import time

import pytest
import torch

from kfbench import harness, ranks, shard_spans, spans
from kfbench.reference import compare
from kinfu_tpu_torch.parallel import mesh as pmesh

from .conftest import ROOT
from .test_kfbench_faults import SMALL_LIMITS
from . import test_kfbench_ranks
from .test_kfbench_ranks import SEED, _bounded, frozen_slab
from .test_kfbench_spans import _trace as one_card_trace

torch.set_num_threads(2)

WORLD = 4
#: seconds a whole run of four ranks may take here before the test fails
RUN_LIMIT_S = 600
DIMS = [256, 64, 384]
LIMITS = dict(SMALL_LIMITS, fuse_miss_pct=12.0)
#: the stage spans of a rank's frame, each once under `kinfu.shard.step`
STAGES = ("kinfu.step.frontend", "kinfu.step.icp", "kinfu.step.integrate", "kinfu.step.raycast",
          "kinfu.step.reset", "kinfu.shard.halo")


def floor_entry() -> dict:
    e = copy.deepcopy(harness.load_cell("shard.big-orbit", ROOT))
    c = e["config"]
    c["sensor"] = {"width": 160, "height": 120, "fx": 131.25, "fy": 131.25, "cx": 79.5,
                   "cy": 59.5}
    c["params"].update(volume_dims=DIMS, volume_range=[12.0, 3.0, 18.0],
                       volume_origin=[-6.0, -1.5, 0.5], pyramid_height=2, icp_iters=[3, 4],
                       fused_mode="on", icp_mode="warped", raycast_face=(512, 208.0))
    c["session"] = dict(c["session"], backend="gloo")
    m = e["mix"]
    m["camera"]["unique_frames"] = 8
    m["warmup_frames"] = 2
    e["limits"] = dict(LIMITS)
    return e


def _updated_per_rank(log) -> list:
    """Each checked frame's voxels updated or changed, a list a rank."""
    out = []
    for line in log:
        m = re.match(r"fuse, .*: per rank \[([\d, ]+)\] voxels updated", line)
        if m:
            out.append([int(v) for v in m.group(1).split(",")])
    return out


def test_floor_run_is_correct_on_every_rank_and_control_is_not(monkeypatch, tmp_path):
    from kfbench import trace

    monkeypatch.setattr(harness, "TRACE_FRAMES", 3)
    monkeypatch.setattr(trace, "TRACE_DIR", tmp_path)
    monkeypatch.setattr(test_kfbench_ranks, "RUN_LIMIT_S", RUN_LIMIT_S)
    pmesh.reset_collective_counts()  # rank 0's counter, in this process
    e = floor_entry()
    t0 = time.perf_counter()
    out = _bounded(lambda: harness.run(e, SEED, 0.5, True, torch.device("cpu"), t0,
                                       check_span=3, control_dt=torch.bfloat16))
    assert "err" not in out, out.get("err")
    res = out["res"]
    nums = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"], (nums, res["log"])
    assert all(0 <= nums[k] <= LIMITS[k] for k in LIMITS)
    assert res["failed"] == 0 and res["device"]["count"] == WORLD
    line = next(x for x in res["log"] if "frames run" in x)
    assert "slabs along array dim 1" in line and "the same on every rank: True" in line
    # every rank fuses its band at the bootstrap and at both drawn frames
    per = _updated_per_rank(res["log"])
    assert len(per) == 3 and all(len(p) == WORLD and min(p) > 0 for p in per), per
    # the control fails every number, by far
    ctl = res["control"]
    assert all(ctl[k] > LIMITS[k] for k in LIMITS)
    assert ctl["pose_gap_mm"] > 10 * LIMITS["pose_gap_mm"]
    assert ctl["fuse_miss_pct"] > 5 * LIMITS["fuse_miss_pct"]

    # rank 0's spans: each stage and the halo exchange once a frame under the
    # sharded step, the collectives (the ICP's sums, the halo's, the hit
    # composite's minimum) inside it
    t = shard_spans.table(spans._load(tmp_path / "trace.json.gz"))
    assert t["frames"] == harness.TRACE_FRAMES
    rows = t["spans"]
    for name in STAGES:
        assert rows[name]["count"] == 1, (name, rows[name])
    assert rows["kinfu.shard.collective"]["count"] >= 3
    # the halo's MB a frame: ranks x two slots x 8 rows x Z x X int32
    Z, X = DIMS[2], DIMS[0]
    m = res["metrics"]
    assert m["shard.halo_mb"]["value"] == WORLD * 2 * 8 * Z * X * 4 / 1e6
    # the CPU has no device time: the device readers give nothing
    for name in ("shard.halo_ms", "shard.collective_ms", "shard.busy_spread"):
        assert name not in m


def test_floor_frozen_slab_is_not_correct(monkeypatch):
    monkeypatch.setattr(test_kfbench_ranks, "RUN_LIMIT_S", RUN_LIMIT_S)
    out = _bounded(lambda: ranks.run(floor_entry(), SEED, 0.5, False, "cpu",
                                     time.perf_counter(), check_span=3,
                                     step_factory=frozen_slab))
    assert "err" not in out, out.get("err")
    res = out["res"]
    assert not res["correct"]
    assert res["checks"]["fuse_miss_pct"]["value"] > LIMITS["fuse_miss_pct"]
    assert not compare.verdict({k: v["value"] for k, v in res["checks"].items()}, LIMITS)


# ---------------------------------------------------------------- the readers

def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _shard_frame(t0, c):
    """A rank's frame at t0 (us): the step [0, 100] holding icp [10, 30]
    with a collective [15, 20], raycast [40, 80] with the halo [45, 65]
    and its collective [50, 60], and a collective [70, 75] of its own; a
    kernel of 10 us in icp, the halo's fill of 4 us, an nccl kernel of 8
    us in each collective."""
    op = "cpu_op"
    return [_x("user_annotation", "kfbench.frame", t0, 100),
            _x(op, "kinfu.shard.step", t0, 100),
            _x(op, "kinfu.step.icp", t0 + 10, 20),
            _x(op, "kinfu.shard.collective", t0 + 15, 5),
            _x(op, "kinfu.step.raycast", t0 + 40, 40),
            _x(op, "kinfu.shard.halo", t0 + 45, 20),
            _x(op, "kinfu.shard.collective", t0 + 50, 10),
            _x(op, "kinfu.shard.collective", t0 + 70, 5),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 11, 1, c),
            _x("kernel", "icp_kernel", t0 + 12, 10, c),
            _x("cuda_runtime", "cudaLaunchKernelExC", t0 + 16, 1, c + 1),
            _x("kernel", "ncclDevKernel_AllReduce_Sum_f32", t0 + 22, 8, c + 1),
            _x("cuda_runtime", "cudaLaunchKernel", t0 + 46, 1, c + 2),
            _x("kernel", "fill_kernel", t0 + 46, 4, c + 2),
            _x("cuda_runtime", "cudaLaunchKernelExC", t0 + 51, 1, c + 3),
            _x("kernel", "ncclDevKernel_AllReduce_Sum_i32", t0 + 52, 8, c + 3),
            _x("cuda_runtime", "cudaLaunchKernelExC", t0 + 71, 1, c + 4),
            _x("kernel", "ncclDevKernel_AllReduce_Min_f32", t0 + 72, 8, c + 4)]


def _ctx(path, events, rank_traces):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return {"trace": {"log": [f"chrome trace written to {path}"], "frames": 2, "busy_s": 76e-6,
                      "breakdown": {"device_ops": [["ncclDevKernel_AllReduce_Sum_f32", 16e-6],
                                                   ["icp_kernel", 20e-6]]}},
            "rank_traces": rank_traces}


def test_shard_readers_on_hand_built_trace(tmp_path, monkeypatch):
    read = harness.read_metric
    # rank 1's trace keeps torch's range around its collectives (40 us) and
    # their kernels (30 us of them among its largest operations)
    other = {"frames": 2, "busy_s": 100e-6,
             "breakdown": {"device_ops": [["nccl:all_reduce", 40e-6],
                                          ["ncclDevKernel_AllReduce_Sum_i32", 30e-6]]}}
    ctx = _ctx(tmp_path / "t.json.gz", _shard_frame(0.0, 10) + _shard_frame(110.0, 20), [other])
    # device us a frame: the collectives' three nccl kernels; the halo's fill
    # and its collective's kernel
    assert read("shard.collective_ms", ctx) == pytest.approx(0.024)
    assert read("shard.halo_ms", ctx) == pytest.approx(0.012)
    # own ms a frame: rank 0 (76 - 16) / 2 us, rank 1 (100 - 40) / 2 us
    assert read("shard.busy_spread", ctx) == pytest.approx(1.0)
    other["busy_s"] = 130e-6
    assert read("shard.busy_spread", ctx) == pytest.approx(1.5)
    monkeypatch.setattr(pmesh, "COLLECTIVES", pmesh.COLLECTIVES.__class__(
        halo=3, halo_bytes=3 * 25_165_824, psum=9, psum_bytes=9 * 172))
    assert read("shard.halo_mb", ctx) == pytest.approx(25.165824)
    # a run with no device time (gloo on the CPU) gives no device reading
    cpu = _ctx(tmp_path / "c.json.gz", [e for e in _shard_frame(0.0, 10)
                                       if e["cat"] not in ("kernel", "cuda_runtime")],
               [dict(other, busy_s=0.0)])
    cpu["trace"]["busy_s"] = 0.0
    for name in ("shard.halo_ms", "shard.collective_ms", "shard.busy_spread"):
        assert read(name, cpu) is None
    assert read("shard.halo_mb", cpu) == pytest.approx(25.165824)


def test_shard_readers_silent_without_the_sharded_step(tmp_path):
    names = ("shard.halo_ms", "shard.collective_ms", "shard.halo_mb", "shard.busy_spread")
    # a one-card session's trace: no "rank_traces", no sharded step
    one = _ctx(tmp_path / "one.json.gz", one_card_trace(), None)
    del one["rank_traces"]
    assert all(harness.read_metric(n, one) is None for n in names)
    assert harness.read_metric("icp.ms", one) == pytest.approx(0.020)
    # a sharded run of a program without the span (the parent of the spans)
    bare = _ctx(tmp_path / "bare.json.gz", [e for e in _shard_frame(0.0, 10)
                                           if not e["name"].startswith("kinfu.")], [{}])
    assert all(harness.read_metric(n, bare) is None for n in names)
    assert all(harness.read_metric(n, {}) is None for n in names)
