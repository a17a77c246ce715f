"""The CUDA-graph path of the session's step (kinfu_tpu_torch/pipeline/
graphed.py) where it needs no card: which sessions capture their step,
the segments a fused and a streaming step are cut into at their spans,
the in-place step and reset that keep the state's addresses, the step's
volume updated in place, the streaming shift's too (CPU,
128^3 / 80x64, two pyramid levels), and the layout of libcuda's
struct that the check for copies from the host reads."""

import ctypes

import pytest
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.pipeline.graphed import (
    _Memcpy3D,
    graphed_ok,
    reset_state_,
    state_tensors,
    step_in_place,
)
from kinfu_tpu_torch.pipeline.kinfu import init_state, make_step_fn
from kinfu_tpu_torch.pipeline.session import KinFuSession
from kinfu_tpu_torch.pipeline.streaming import init_streaming_state, make_streaming_step_fn
from kinfu_tpu_torch.utils import profiling

torch.set_num_threads(2)

INTR = Intrinsics(80, 64, 70.0, 70.0, 39.5, 31.5)
PARAMS = KinFuParams(pyramid_height=2, icp_iters=(2, 2), volume_dims=(128, 128, 128),
                     icp_mode="warped", fused_mode="on", raycast_face=(128, 52.0))
#: the step's spans in the order a frame runs them (tests/test_torch_spans.py)
STEP = ("kinfu.step.frontend", "kinfu.step.icp", "kinfu.step.shift", "kinfu.step.integrate",
        "kinfu.step.raycast", "kinfu.step.reset")
FUSED_512 = KinFuParams()


@pytest.mark.parametrize("device, shape, params, relocalize, pose_graph, want", [
    ("cuda", (512, 512, 512), FUSED_512, False, False, True),
    ("cuda:1", (512, 512, 512), FUSED_512, False, False, True),
    ("cpu", (512, 512, 512), FUSED_512, False, False, False),
    ("cpu", (512, 512, 512), FUSED_512.replace(fused_mode="on"), False, False, False),
    ("cuda", (320, 320, 320), FUSED_512, False, False, False),
    ("cuda", (512, 512, 512), FUSED_512.replace(fused_mode="off"), False, False, False),
    ("cuda", (512, 512, 512), FUSED_512.replace(integrate_mode="gather"), False, False, False),
    ("cuda", (512, 512, 512), FUSED_512, True, False, False),
    ("cuda", (512, 512, 512), FUSED_512, False, True, False),
], ids=["cuda", "cuda1", "cpu", "cpu-fused-on", "320", "fused-off", "gather", "relocalize",
        "pose-graph"])
def test_capture_decision(device, shape, params, relocalize, pose_graph, want):
    assert graphed_ok(device, shape, params, relocalize, pose_graph) is want


def test_cpu_sessions_run_eagerly():
    for kw in ({}, {"streaming": True}, {"relocalize": True}, {"pose_graph": True}):
        sess = KinFuSession(INTR, PARAMS, device="cpu", **kw)
        assert not sess._graphed
        assert not hasattr(sess._step, "segments")


def test_cuts_outermost_spans_only():
    cuts = profiling.Cuts()
    with profiling.cut_at_spans(cuts):
        with profiling.span("a"):
            with profiling.span("inner"):
                pass
        with profiling.span("b", frame=2):
            pass
        with pytest.raises(RuntimeError):
            with profiling.cut_at_spans(profiling.Cuts()):
                pass
    assert cuts.names == ["a", "b"]
    assert profiling.span("a") is profiling._OFF


def _frames(n):
    scene = default_test_scene()
    return [tuple(torch.as_tensor(a) for a in scene.render_frame(T, INTR))
            for T in make_orbit_trajectory(n, angle_step_deg=0.3)]


def _setup(streaming):
    if streaming:
        return (init_streaming_state(PARAMS, INTR, device="cpu"),
                make_streaming_step_fn(PARAMS, INTR))
    return init_state(PARAMS, INTR, device="cpu"), make_step_fn(PARAMS, INTR)


def _volume(state):
    return state.kinfu.vol if hasattr(state, "origin_vox") else state.vol


@pytest.fixture(scope="module", params=[False, True], ids=["fixed", "streaming"])
def frames_in_place(request):
    """The bootstrap frame stepped in place with its spans recorded, and
    beside the plain step; then a blank depth frame stepped in place
    (tracking fails and the step resets the state on the device)."""
    streaming = request.param
    state, step = _setup(streaming)
    plain, _ = _setup(streaming)
    ptrs = [t.data_ptr() for t in state_tensors(state)]
    (d, c), = _frames(1)
    res = {"streaming": streaming, "state": state, "ptrs": ptrs, "same_state": []}
    with profiling.cut_at_spans(profiling.Cuts()) as cuts:
        state2, out = step_in_place(step, state, d, c)
    vol_before = [t.data_ptr() for t in _volume(plain)]
    plain, want = step(plain, d, c)
    res["vol_kept"] = [t.data_ptr() for t in _volume(plain)] == vol_before
    res["cuts"] = cuts.names
    res["outs"] = [(out, want)]
    res["same_state"].append(state2 is state)
    res["equal"] = [all(torch.equal(a, b) for a, b in zip(state_tensors(state),
                                                         state_tensors(plain)))]
    res["ptrs_after"] = [[t.data_ptr() for t in state_tensors(state)]]
    state2, out = step_in_place(step, state, torch.zeros_like(d), c)
    fresh, _ = _setup(streaming)
    res["outs"].append((out, None))
    res["same_state"].append(state2 is state)
    res["equal"].append(all(torch.equal(a, b) for a, b in zip(state_tensors(state),
                                                              state_tensors(fresh))))
    res["ptrs_after"].append([t.data_ptr() for t in state_tensors(state)])
    return res


def test_segment_order(frames_in_place):
    r = frames_in_place
    assert r["cuts"] == [s for s in STEP if r["streaming"] or s != "kinfu.step.shift"]


def test_step_returns_the_state_volume(frames_in_place):
    """The step, streaming or not, updates the volume it is given in place
    (the streaming shift too) and returns its tensors, so the graphed
    step's copy-back has no volume to copy."""
    assert frames_in_place["vol_kept"]


def test_in_place_step_and_reset_keep_addresses(frames_in_place):
    """The fixture's frames keep the state's tensors and give the plain
    step's state (the bootstrap) and a fresh state (the failed frame's
    reset); then `reset_state_` of a filled state gives a fresh state."""
    r = frames_in_place
    assert all(r["same_state"]) and all(p == r["ptrs"] for p in r["ptrs_after"])
    (out0, want0), (out1, _) = r["outs"]
    assert bool(out0.tracking_ok) and bool(want0.tracking_ok) and not bool(out1.tracking_ok)
    assert torch.equal(out0.pose_matrix, want0.pose_matrix)
    assert torch.equal(out1.pose_matrix, torch.eye(4))
    assert r["equal"] == [True, True]
    state = r["state"]
    state_tensors(state)[0].fill_(7)
    state_tensors(state)[3].fill_(2)
    state_tensors(state)[-1].fill_(3)
    reset_state_(state)
    fresh, _ = _setup(r["streaming"])
    assert [t.data_ptr() for t in state_tensors(state)] == r["ptrs"]
    assert all(torch.equal(a, b) for a, b in zip(state_tensors(state), state_tensors(fresh)))


def test_memcpy_node_params_layout():
    """`_Memcpy3D` has cuda.h's CUDA_MEMCPY3D layout (64-bit): the fields the
    host-copy check reads lie at cuda.h's offsets."""
    assert ctypes.sizeof(_Memcpy3D) == 200
    offsets = {"srcMemoryType": 32, "srcHost": 40, "srcDevice": 48, "dstMemoryType": 120,
               "dstDevice": 136, "WidthInBytes": 176, "Depth": 192}
    assert {k: getattr(_Memcpy3D, k).offset for k in offsets} == offsets
