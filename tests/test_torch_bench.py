"""The port's bench command (`kinfu_tpu_torch/bench.py`) against bench.py.

  - `workload` builds bench.py's parameters, intrinsics and frames: every
    field of KinFuParams and Intrinsics equals the JAX package's built as
    bench.py:94-112 builds them, and the depths and colours equal
    kinfu_tpu.data.synthetic's render bit for bit, on the orbit and on
    `--corner`, at 160x120;
  - `main` prints one JSON line with exactly bench.py's four keys;
  - `run` times the very step that tests/test_torch_step.py holds to JAX:
    its poses equal `tools/accuracy_run.py::track`'s bit for bit;
  - a frame that does not track prints bench.py's per-frame trace to
    stderr and raises its AssertionError;
  - without CUDA the default device raises and nothing runs on the CPU.

All at 160x120 / 128^3 with 2 levels on the CPU's default path (the
non-fused step)."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from kinfu_tpu.config import KinFuParams as JaxParams
from kinfu_tpu.data import synthetic as jsynthetic
from kinfu_tpu.geometry.intrinsics import Intrinsics as JaxIntrinsics
from kinfu_tpu_torch import bench
from kinfu_tpu_torch.pipeline.state import StepOutput
from kinfu_tpu_torch.tools import accuracy_run

torch.set_num_threads(2)

#: the tests' size: 4 frames (1 short, 3 more in the long run)
TINY = ["--device", "cpu", "--dim", "128", "--width", "160", "--height", "120",
        "--levels", "2", "--frames", "3", "--warmup", "1"]
CASES = pytest.mark.parametrize("corner", [False, True], ids=["orbit", "corner"])


def _bench_py_workload(args):
    """bench.py:94-118 with the JAX package: (params, intr, depths, colors)
    as numpy arrays."""
    params = JaxParams(
        pyramid_height=args.levels,
        icp_iters=(4, 5, 10)[: args.levels],
        volume_dims=(args.dim, args.dim, args.dim),
        fused_mode=args.fused,
        integrate_mode=args.integrate,
        raycast_mode=args.raycast,
        icp_mode=args.icp,
    )
    intr = JaxIntrinsics(
        width=args.width,
        height=args.height,
        fx=525.0 * args.width / 640,
        fy=525.0 * args.width / 640,
        cx=args.width / 2 - 0.5,
        cy=args.height / 2 - 0.5,
    )
    traj = jsynthetic.make_orbit_trajectory(args.warmup + args.frames, angle_step_deg=0.3)
    if args.corner:
        scene, traj = jsynthetic.corner_test_scene(), jsynthetic.yaw_trajectory(traj)
    else:
        scene = jsynthetic.default_test_scene()
    rendered = [scene.render_frame(T, intr) for T in traj]
    return (params, intr, np.stack([d for d, _ in rendered]),
            np.stack([c for _, c in rendered]))


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@CASES
def test_workload_is_bench_py(corner):
    argv = ["--device", "cpu", "--width", "160", "--height", "120", "--frames", "2",
            "--warmup", "1", "--fused", "on", "--raycast", "hier"] + (["--corner"] if corner
                                                                      else [])
    args = bench.parse_args(argv)
    params, intr, depths, colors = bench.workload(args)
    jparams, jintr, jdepths, jcolors = _bench_py_workload(args)
    assert _fields(params) == _fields(jparams)
    assert _fields(intr) == _fields(jintr)
    assert depths.device.type == "cpu" and colors.device.type == "cpu"
    assert depths.shape == (3, 120, 160) and colors.shape == (3, 120, 160, 3)
    assert depths.dtype == torch.float32 and colors.dtype == torch.uint8
    np.testing.assert_array_equal(depths.numpy(), jdepths)
    np.testing.assert_array_equal(colors.numpy(), jcolors)
    # the defaults are bench.py's
    d = bench.parse_args([])
    assert (d.dim, d.frames, d.warmup, d.width, d.height, d.levels, d.fused, d.integrate,
            d.raycast, d.icp, d.corner, d.device) == (512, 20, 2, 640, 480, 3, "auto", "auto",
                                                     "auto", "auto", False, "cuda")


@CASES
def test_main_prints_bench_py_line(corner, capsys):
    assert bench.main(TINY + (["--corner"] if corner else [])) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(row) == {"metric", "value", "unit", "vs_baseline"}
    assert row["metric"] == "ms_per_frame_160x120_128^3" + ("_corner" if corner else "")
    assert row["unit"] == "ms"
    assert math.isfinite(row["value"]) and row["value"] > 0
    assert row["vs_baseline"] == pytest.approx(18.0 / row["value"], abs=2e-3)
    assert "bench: device cpu" in err and "wall s of the timed runs" in err


def test_run_times_the_accuracy_run_step():
    args = bench.parse_args(TINY)
    params, intr, depths, colors = bench.workload(args)
    step = bench.make_step_fn(params, intr)
    poses, oks, inliers, seconds = bench.run(
        step, lambda: bench.init_state(params, intr, "cpu"), depths, colors)
    frames = list(zip(depths.numpy(), colors.numpy()))
    want, want_ok = accuracy_run.track(frames, params, intr, torch.device("cpu"))
    assert oks.all() and want_ok.all() and seconds > 0
    assert poses.dtype == np.float32 and poses.shape == (4, 4, 4)
    np.testing.assert_array_equal(poses, want)
    assert inliers[0] == 0 and (inliers[1:] > 0).all()


def test_tracking_failure_prints_trace_and_raises(monkeypatch, capsys):
    """A step that reports frame 2 lost: bench.py's trace, then its error."""

    def failing_step_fn(params, intr):
        def step(state, depth, color):
            k = int(state.frame_count)  # 1 on the first frame
            out = StepOutput(pose_matrix=torch.eye(4), tracking_ok=torch.tensor(k != 3),
                             icp_inliers=torch.tensor(100 * k, dtype=torch.int32))
            return state._replace(frame_count=state.frame_count + 1), out
        return step

    monkeypatch.setattr(bench, "make_step_fn", failing_step_fn)
    with pytest.raises(AssertionError, match="tracking failed during benchmark"):
        bench.main(TINY)
    out, err = capsys.readouterr()
    assert out == ""
    trace = [ln for ln in err.splitlines() if ln.startswith("frame ")]
    assert trace == ["frame   0  ok=True  inliers=100", "frame   1  ok=True  inliers=200",
                     "frame   2  ok=False  inliers=300", "frame   3  ok=True  inliers=400"]


@pytest.mark.parametrize("device", [None, "cuda"], ids=["default", "cuda"])
def test_cuda_device_raises_without_cuda(device, monkeypatch):
    """No fallback: without CUDA the card's device raises before a frame
    is rendered or a step runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_step(*a, **k):
        raise AssertionError("the step ran")

    monkeypatch.setattr(bench, "make_step_fn", no_step)
    monkeypatch.setattr(bench, "default_test_scene", no_step)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(argv + ([] if device is None else ["--device", device]))
