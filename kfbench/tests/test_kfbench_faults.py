"""The check that decides `correct` sees a broken program: a whole run of
each cell (set-up, window, check) at 160x120 / 128^3 on the CPU, past the
harness's look for a card, once sound and once with each fault that a
cell can have planted in the session's step:
  - frozen: the step returns its state unchanged;
  - half: half of the frame (its lower rows) is left out;
  - altered: the pose is moved by 2 mm where the step produces it;
  - moved: the model maps are moved one voxel along the view where the
    step produces them (a systematic offset of the raycast).
One card holds the whole state, so no exchange between cards can be left
out. The control, the reference put in the program's place in bfloat16,
must fail the check too.

At this size the CPU runs the port's non-fused path; the limits are this
size's (SMALL_LIMITS, set above the sound readings of this path and below
the faults': pose gaps ~1e-4 mm, fusion ~1%, raycast 5-19% with the
"hier" march, whose refinement differs from the step march's, against
28-70% with the maps moved), not the cells'."""

import time

import pytest
import torch

from kfbench import harness

from .conftest import small_entry

torch.set_num_threads(2)

SMALL_LIMITS = {"pyramid_miss_pct": 1.0, "pose_gap_mm": 0.01, "fuse_miss_pct": 5.0,
                "map_miss_pct": 25.0}
CELLS = ("pcl512.orbit", "stream512.orbit", "stream512.corridor")


def _patch(fault: str):
    """A session factory whose step carries `fault`."""
    from kinfu_tpu_torch.geometry.se3 import Pose, pose_matrix
    from kinfu_tpu_torch.pipeline.state import StepOutput

    def factory(config, device):
        sess = harness.make_session(config, device)
        step = sess._step

        def kinfu(state):
            return state.kinfu if sess.streaming else state

        def put(state, ks):
            return state._replace(kinfu=ks) if sess.streaming else ks

        def broken(state, depth, color):
            if fault == "frozen":
                ks = kinfu(state)
                out = StepOutput(pose_matrix(ks.pose), torch.ones((), dtype=torch.bool),
                                 torch.zeros((), dtype=torch.int32))
                return state, out
            if fault == "half":
                depth = depth.clone()
                depth[depth.shape[0] // 2:] = 0
                return step(state, depth, color)
            state, out = step(state, depth, color)
            ks = kinfu(state)
            if fault == "moved":
                vox = config["params"]["volume_range"][2] / config["params"]["volume_dims"][2]
                dz = torch.tensor([0.0, 0.0, vox])
                vmaps = tuple(v + dz * (n != 0).any(-1, keepdim=True)
                              for v, n in zip(ks.model_vmaps, ks.model_nmaps))
                return put(state, ks._replace(model_vmaps=vmaps)), out
            pose = Pose(ks.pose.R, ks.pose.t + torch.tensor([0.002, 0.0, 0.0]))
            return put(state, ks._replace(pose=pose)), out._replace(pose_matrix=pose_matrix(pose))

        sess._step = broken
        return sess

    return factory


def _run(workload: str, fault=None, control=False):
    e = small_entry(workload)
    lim = dict(SMALL_LIMITS)
    if "origin_gap_vox" in e["limits"]:
        lim["origin_gap_vox"] = 0.0
    e["limits"] = lim
    factory = _patch(fault) if fault else harness.make_session
    return harness.run(e, 2**31 + 17, 0.5, False, torch.device("cpu"), time.perf_counter(),
                       session_factory=factory, check_span=3, max_warmup=120,
                       control_dt=torch.bfloat16 if control else None)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_control_is_not(workload):
    res = _run(workload, control=True)
    nums = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"], nums
    assert res["failed"] == 0
    assert not harness.compare.verdict(res["control"], res["checks"] and
                                       {k: v["limit"] for k, v in res["checks"].items()})
    # the lower precision fails by far, not by a hair
    assert res["control"]["pose_gap_mm"] > 10 * SMALL_LIMITS["pose_gap_mm"]
    assert res["control"]["fuse_miss_pct"] > 5 * SMALL_LIMITS["fuse_miss_pct"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault,number", [("frozen", "fuse_miss_pct"), ("half", "fuse_miss_pct"),
                                          ("altered", "pose_gap_mm"),
                                          ("moved", "map_miss_pct")])
def test_fault_is_not_correct(workload, fault, number):
    res = _run(workload, fault)
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]
