"""The sharded run (`kfbench/ranks.py`) on the CPU: two gloo ranks at
160x120 / 128^3 (`conftest.small_entry`), rank 0 in this process and rank
1 spawned, each run under a time limit; and the sharded check's parts
against the one-card judge on whole states.

At this size the CPU runs the sharded step's non-fused path (the gather
integrate, the march raycast over Z slabs); the limits are
test_kfbench_faults.py's SMALL_LIMITS."""

import multiprocessing
import threading
import time

import numpy as np
import pytest
import torch

from kfbench import gen, harness, work
from kfbench.reference import compare, shards
from kfbench.reference import kinfu as K

from .conftest import small_entry
from .test_kfbench_faults import SMALL_LIMITS

torch.set_num_threads(2)

WORLD = 2
#: seconds a whole sharded run may take here before the test fails
RUN_LIMIT_S = 240
SEED = 2**33 + 5


def sharded_entry(world: int = WORLD, **session) -> dict:
    e = small_entry("pcl512.orbit")
    e["config"]["session"] = {"streaming": False, "shards": world, "shard_dim": 0,
                              "backend": "gloo", **session}
    e["cell"] = dict(e["cell"], chips=world)
    e["limits"] = dict(SMALL_LIMITS)
    return e


def frozen_slab(params, intr, mesh):
    """The sharded step with rank 1's slab put back as it was before each
    frame after the bootstrap (its collectives all made)."""
    from kinfu_tpu_torch.parallel.sharded import make_sharded_step_fn

    step = make_sharded_step_fn(params, intr, mesh)
    calls = [0]

    def broken(state, depth, color):
        calls[0] += 1
        keep = [a.clone() for a in state.vol] if mesh.rank == 1 and calls[0] > 1 else None
        state, out = step(state, depth, color)
        for a, b in zip(state.vol, keep or ()):
            a.copy_(b)
        return state, out

    return broken


def crashed_rank(params, intr, mesh):
    """The sharded step, with rank 1 failing on its fourth frame."""
    from kinfu_tpu_torch.parallel.sharded import make_sharded_step_fn

    step = make_sharded_step_fn(params, intr, mesh)
    calls = [0]

    def broken(state, depth, color):
        calls[0] += 1
        if mesh.rank == 1 and calls[0] == 4:
            raise RuntimeError("a planted fault")
        return step(state, depth, color)

    return broken


def _bounded(fn):
    """fn() in a thread that has RUN_LIMIT_S to end; then no rank may be
    left."""
    out = {}

    def go():
        try:
            out["res"] = fn()
        except BaseException as exc:  # handed to the test below
            out["err"] = exc

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(RUN_LIMIT_S)
    assert not t.is_alive(), f"the sharded run did not end in {RUN_LIMIT_S} s"
    assert not multiprocessing.active_children(), "a rank was left running"
    return out


def _run(entry, **kw):
    from kfbench import ranks

    out = _bounded(lambda: ranks.run(entry, SEED, 0.5, False, "cpu", time.perf_counter(),
                                     check_span=3, **kw))
    if "err" in out:
        raise out["err"]
    return out["res"]


def test_sharded_run_is_correct_on_every_rank_and_control_is_not(monkeypatch, tmp_path):
    from kfbench import trace

    monkeypatch.setattr(harness, "TRACE_FRAMES", 3)  # the ranks take rank 0's count
    monkeypatch.setattr(trace, "TRACE_DIR", tmp_path)  # rank 0 writes the chrome trace
    t0 = time.perf_counter()
    e = sharded_entry()
    out = _bounded(lambda: harness.run(e, SEED, 0.5, True, torch.device("cpu"), t0,
                                       check_span=3, control_dt=torch.bfloat16))
    assert "err" not in out, out.get("err")
    res = out["res"]
    nums = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"], (nums, res["log"])
    assert not compare.verdict(res["control"], SMALL_LIMITS)
    # the lower precision fails by far, not by a hair
    assert res["control"]["pose_gap_mm"] > 10 * SMALL_LIMITS["pose_gap_mm"]
    assert res["control"]["fuse_miss_pct"] > 5 * SMALL_LIMITS["fuse_miss_pct"]
    assert res["failed"] == 0 and res["attempted"] >= 4
    assert res["device"]["count"] == WORLD
    assert len(res["device"]["busy_s_ranks"]) == WORLD
    line = next(x for x in res["log"] if "frames run" in x)
    assert "the same on every rank: True" in line, line
    assert all(0 <= nums[k] <= SMALL_LIMITS[k] for k in SMALL_LIMITS)
    assert "session.p50_ms" in res["metrics"]


def test_frozen_slab_is_not_correct():
    res = _run(sharded_entry(), step_factory=frozen_slab)
    assert not res["correct"]
    assert res["checks"]["fuse_miss_pct"]["value"] > SMALL_LIMITS["fuse_miss_pct"]


def test_failed_rank_ends_the_run():
    t0 = time.perf_counter()
    with pytest.raises((RuntimeError, SystemExit)):
        _run(sharded_entry(), step_factory=crashed_rank)
    assert time.perf_counter() - t0 < RUN_LIMIT_S


@pytest.mark.parametrize("session,why", [({"streaming": True}, "streaming"),
                                         ({"relocalize": True}, "relocalize"),
                                         ({"shards": 4}, "chips")])
def test_refused(session, why):
    with pytest.raises(SystemExit, match=why):
        harness.run(sharded_entry(**session), SEED, 0.5, False, torch.device("cpu"),
                    time.perf_counter())


# ---------------------------------------------------------------- the check's parts

def _states():
    """A whole state after frame 0 and one after frame 1 of the small
    orbit, fused by the reference; the second with some voxels altered so
    that some disagree with the reference's fusion."""
    e = small_entry("pcl512.orbit")
    st = compare.Setup(e["config"])
    traffic = gen.Traffic(e["mix"], SEED, st.cam, "cpu")
    X, Y, Z = st.grid.dims
    vol = (torch.zeros((Z, Y, X), dtype=torch.int16), torch.zeros((Z, Y, X), dtype=torch.int16),
           torch.zeros((Z, Y, X), dtype=torch.int32))
    vp = st.vol_pose(None, "cpu")
    f32 = torch.float32
    frames = []
    for k in (0, 1):
        c, d = traffic.frame(k)
        ds, _, _ = K.measurement(torch.as_tensor(d.astype(np.float32)), st.cam, st.cfg, f32)
        frames.append((c, d.astype(np.float32), ds))
    K.fuse(*vol, frames[0][2][0], torch.as_tensor(frames[0][0]), vp, st.cam, st.grid, f32)
    vm, nm = K.raycast(vol[0], vp.inverse(), st.cam, st.grid, f32)
    vms, nms = K.model_pyramid(vm, nm, st.cfg["pyramid_height"])
    before = {"vol": vol, "vmaps": vms, "nmaps": nms, "pose": torch.eye(4), "origin": None}
    pose = torch.as_tensor(traffic.gt_pose(1), dtype=f32)
    prog_vol = tuple(a.clone() for a in vol)
    K.fuse(*prog_vol, frames[1][2][0], torch.as_tensor(frames[1][0]),
           torch.linalg.inv(pose) @ vp, st.cam, st.grid, f32)
    flat = prog_vol[0].view(-1)
    hit = torch.nonzero(prog_vol[1].view(-1)).flatten()[::9]
    flat[hit] = flat[hit] // 2
    vm, nm = K.raycast(prog_vol[0], torch.linalg.inv(vp) @ pose, st.cam, st.grid, f32)
    vms, nms = K.model_pyramid(vm, nm, st.cfg["pyramid_height"])
    prog = {"vol": prog_vol, "vmaps": vms, "nmaps": nms, "pose": pose, "origin": None}
    return st, frames[1], before, prog


def _slab(vol, slab):
    sl = [slice(None)] * 3
    sl[slab[0]] = slice(slab[1], slab[2])
    return tuple(a[tuple(sl)].contiguous() for a in vol)


@pytest.mark.parametrize("world,dim", [(2, 0), (4, 1)])
def test_fuse_counts_over_slabs_equal_the_one_card_judge(world, dim, monkeypatch):
    monkeypatch.setattr(shards, "BLOCK_VOXELS", 128 * 128 * 5)  # several blocks a slab
    st, (c, d, ds), before, prog = _states()
    one = compare.judge_step(st, d, c, before, prog)["fuse_miss_pct"]
    vol2cam = torch.linalg.inv(prog["pose"].float()) @ st.vol_pose(None, "cpu")
    counts = []
    for r in range(world):
        slab = work.slab_of(st, r, world, dim)
        counts.append(shards.fuse_counts(
            st, slab, ds[0], c, shards.SlabCopy.of(_slab(before["vol"], slab), "cpu"),
            shards.SlabCopy.of(_slab(prog["vol"], slab), "cpu"), vol2cam, "cpu"))
    assert sum(x["bad"] for x in counts) > 0
    assert shards.miss_pct(counts) == one


def test_slab_copy_is_lossless(monkeypatch):
    monkeypatch.setattr(shards, "BLOCK_VOXELS", 128 * 128 * 3)
    st, _, _, prog = _states()
    slab = work.slab_of(st, 1, 2, 0)
    vol = _slab(prog["vol"], slab)
    copy = shards.SlabCopy.of(vol, "cpu")
    assert 0 < copy.arrays[0].numel() < vol[0].numel()
    whole = copy.region((0, 0, 0), vol[0].shape, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(whole, vol))
    assert shards.empty(st, slab).block(slice(3, 9), "cpu")[2].abs().sum() == 0


@pytest.mark.parametrize("world,dim", [(2, 0), (4, 1)])
def test_box_raycast_equals_the_whole_raycast(world, dim, monkeypatch):
    monkeypatch.setattr(shards, "BLOCK_VOXELS", 128 * 128 * 3)
    st, _, _, prog = _states()
    tsdf = prog["vol"][0]
    boxes = []
    for r in range(world):
        slab = work.slab_of(st, r, world, dim)
        boxes.append(shards.grid_box(shards.SlabCopy.of(_slab(prog["vol"], slab), "cpu"), slab))
    lo, hi = shards.union_box(st, boxes)
    assert 0 < np.prod([b - a for a, b in zip(lo, hi)]) < tsdf.numel()
    box = tsdf[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].clone()
    cam2vol = torch.linalg.inv(st.vol_pose(None, "cpu")) @ prog["pose"]
    whole = K.raycast(tsdf, cam2vol, st.cam, st.grid, torch.float32)
    part = shards.raycast_box(st, box, lo, cam2vol, torch.float32)
    assert (whole[1] != 0).any(-1).sum() > 1000
    for a, b in zip(whole, part):
        assert torch.equal(a, b)


def test_slab_work_sums_to_the_whole():
    st, (c, d, ds), _, prog = _states()
    cam2vol = torch.linalg.inv(st.vol_pose(None, "cpu")) @ prog["pose"]
    vol2cam = torch.linalg.inv(cam2vol)
    whole_rays = work.ray_voxels(ds[0], cam2vol, st)
    whole_fuse = K.fuse_counts(ds[0], vol2cam, st.cam, st.grid)
    for world, dim in ((2, 0), (4, 1)):
        rays, fuse = [], []
        for r in range(world):
            slab = work.slab_of(st, r, world, dim)
            rays.append(work.ray_voxels(ds[0], cam2vol, st, slab))
            lo = [0, 0, 0]
            lo[2 - dim] = slab[1]
            fuse.append(K.fuse_counts(ds[0], vol2cam, st.cam, st.grid, lo=lo,
                                      shape=shards.slab_shape(st, slab)))
        assert tuple(map(sum, zip(*rays))) == whole_rays
        assert tuple(map(sum, zip(*fuse))) == whole_fuse
        parts = [work.frame_work(st, d, prog["pose"].numpy(), None, (r, world, dim), "cpu")
                 for r in range(world)]
        assert sum(p["voxels_updated"] for p in parts) == whole_fuse[0]


def test_roofline_divides_the_same_ranks_work_and_busy_time():
    read = harness.read_metric
    one = {"trace": {"work": [{"least_s": 0.001}, {"least_s": 0.002}], "busy_s": 0.006}}
    assert read("kernels.roofline", one) == pytest.approx(50.0)
    ranks = dict(one, rank_traces=[{"work": [{"least_s": 0.003}], "busy_s": 0.004}])
    assert read("kernels.roofline", ranks) == pytest.approx(60.0)


@pytest.mark.parametrize("workload,modes", [
    ("pcl512.orbit", {}),
    ("stream512.orbit", {"streaming": True}),
    ("pcl512.orbit", {"relocalize": True}),
])
def test_session_modes_from_the_configuration(workload, modes):
    e = small_entry(workload)
    e["config"]["session"] = dict(e["config"]["session"], **modes)
    sess = harness.make_session(e["config"], "cpu")
    assert sess.streaming == bool(modes.get("streaming"))
    assert (sess.relocalizer is not None) == bool(modes.get("relocalize"))
    assert sess.pose_graph is False
