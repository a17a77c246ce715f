"""The port's spans (kinfu_tpu_torch/utils/profiling.py::span): free when
no profiler records, and when one does, each stage of a session frame as
one host range of the profiler, nested session -> step -> stage, on the
fused and the non-fused path, on a fixed and on a streaming grid (CPU,
128^3 / 160x120, two pyramid levels)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.pipeline.session import KinFuSession
from kinfu_tpu_torch.utils import profiling

torch.set_num_threads(2)

INTR = Intrinsics(160, 120, 140.0, 140.0, 79.5, 59.5)
CFG = dict(pyramid_height=2, icp_iters=(3, 4), volume_dims=(128, 128, 128), icp_mode="warped",
           raycast_face=(256, 104.0))
ROOT = "kinfu.session.pipeline"
SESSION = ("kinfu.session.upload", "kinfu.session.step", "kinfu.session.fetch")
#: the step's spans in the order a frame runs them
STEP = ("kinfu.step.frontend", "kinfu.step.icp", "kinfu.step.shift", "kinfu.step.integrate",
        "kinfu.step.raycast", "kinfu.step.reset")


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range built with no profiler recording")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.profiler_enabled()
    cm = profiling.span("kinfu.session.pipeline", frame=3)
    assert isinstance(cm, type(profiling._OFF)) and cm is profiling.span("kinfu.step.icp")
    with cm:
        pass


def test_profiler_flag_flips():
    assert not profiling.profiler_enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.profiler_enabled()
        assert isinstance(profiling.span("kinfu.step.icp"), profiling._RecordFunctionFast)
    assert not profiling.profiler_enabled()


def _spans(prof):
    """(name, start ns, end ns, args) of the trace's kinfu.* ranges."""
    return sorted(((e.name(), e.start_ns(), e.end_ns(), e.kwinputs())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("kinfu.")),
                  key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("streaming", [False, True], ids=["fixed", "streaming"])
@pytest.mark.parametrize("fused_mode", ["on", "off"])
def test_session_frame_spans(streaming, fused_mode):
    traj = make_orbit_trajectory(2, angle_step_deg=0.3)
    scene = default_test_scene()
    frames = [scene.render_frame(T, INTR) for T in traj]
    sess = KinFuSession(INTR, KinFuParams(**CFG, fused_mode=fused_mode), device="cpu",
                        streaming=streaming)
    d, c = frames[0]
    assert sess.pipeline(c, d)
    d, c = frames[1]
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        assert sess.pipeline(c, d)

    spans = _spans(prof)
    step = tuple(s for s in STEP if streaming or s != "kinfu.step.shift")
    names = [s[0] for s in spans]
    assert sorted(names) == sorted((ROOT,) + SESSION + step)
    by = {s[0]: s for s in spans}
    assert names[0] == ROOT and by[ROOT][3] == {"frame": 2}
    assert [n for n in names if n in SESSION] == list(SESSION)
    assert all(_inside(by[n], by[ROOT]) for n in SESSION)
    assert [n for n in names if n.startswith("kinfu.step.")] == list(step)
    assert all(_inside(by[n], by["kinfu.session.step"]) for n in step)
    assert all(by[a][2] <= by[b][1] for a, b in zip(step, step[1:]))
