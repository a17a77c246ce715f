"""The port's non-fused step, relocalization and the loop-closing pose
graph against the JAX package: `kinfu_step` on its non-fused branch
(CPU "auto": the gather integrate and the "hier" raycast),
`relocalize_step`, the mapping modules (kinfu_tpu_torch/mapping/) and the
session's `relocalize` and `pose_graph` modes.

The JAX steps run in a child process without FMA contraction and with at
most SSE4.2 (tests/torch_jaxref.py: XLA's rsqrt is then 1 / sqrt, as the
port's gather integrate computes it), on the same frames. Tolerances:
  - one step from the same state (the port's step on each JAX state,
    against JAX's next state): tracking flags and frame counts equal;
    inlier counts within 0.1% (a pixel may cross an ICP gate); the pose
    within 1e-5; weights equal on all but 0.01% of the touched voxels; the
    TSDF differs on at most 3% of the touched voxels, by one int16 step on
    all but 0.01% of them.
    The bilateral filter's exp differs in the last bit between XLA and
    PyTorch (tests/test_torch_frontend.py), and the ICP's sums and the
    shading's normals round in another order, so one step's poses differ
    by up to ~3e-6 m. A depth moved by an ulp moves a fused value across
    an int16 step; a pose moved by 1e-6 m moves the sdf of every voxel by
    0.7 of a step (1/32767 of the 49 mm truncation) and can move a voxel's
    nearest pixel across a depth edge. Measured: at most 1.8% of the
    touched voxels differ, 4 weights;
  - the free-running orbit: poses within 1e-5 of JAX's over 5 frames
    (the volumes drift apart as those differences compound: 6.8% of the
    touched voxels and 12 weights differ at frame 4);
  - a failed frame: the bits of the state it was given (auto_reset=False,
    and `relocalize_step`), or a wiped one (auto_reset=True);
  - the CPU golden (tests/golden/poses_cpu_orbit12_128.txt): ATE < 1e-3 m,
    as tests/test_golden_trajectory.py holds the JAX package;
  - the mapping modules against the JAX package's, in this process: the
    same decisions, poses within 1e-5.
The session tests mirror tests/test_mapping.py's three (L185-340) with
their sizes and assertions, except the loop closure's: that test holds
the port's closure, rebuild included, from the JAX session's state at
the closure frame (the free-running loop is chaotic at 64^3).
"""

import copy

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu.mapping import keyframes as jkeyframes
from kinfu_tpu.mapping import loop_closure as jloop
from kinfu_tpu.mapping import pose_graph as jpg
from kinfu_tpu.mapping import relocalize as jreloc
from kinfu_tpu_torch.config import KinFuParams, tiny_params
from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu_torch.eval.ate import ate_rmse
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import pose_matrix, rodrigues
from kinfu_tpu_torch.io.poses import read_poses_reference_format
from kinfu_tpu_torch.mapping import keyframes, loop_closure, pose_graph, relocalize
from kinfu_tpu_torch.pipeline.kinfu import (
    init_state,
    kinfu_step,
    make_step_fn,
    relocalize_step,
)
from kinfu_tpu_torch.pipeline.session import KinFuSession
from kinfu_tpu_torch.pipeline.state import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
INTR = Intrinsics(*INTR_T)
#: tests/test_golden_trajectory.py's configuration, on its CPU default:
#: the non-fused step
CFG = dict(pyramid_height=2, icp_iters=(4, 5), volume_dims=(128, 128, 128),
           volume_range=(3.0, 3.0, 3.0))
PARAMS = KinFuParams(**CFG)
GOLDEN = "tests/golden/poses_cpu_orbit12_128.txt"
POSE_TOL = 1e-5
#: inlier counts, relative: the ICP's later iterations start from poses
#: that differ by ulps, so a pixel may cross a distance or angle gate
INLIER_TOL = 1e-3
N = 5


def _orbit(n, step_deg=0.3, intr=INTR):
    scene = default_test_scene()
    traj = make_orbit_trajectory(n, angle_step_deg=step_deg)
    gt = [np.linalg.inv(traj[0]) @ T for T in traj]
    return [scene.render_frame(T, intr) for T in traj], gt


def _failing(frames):
    """Frames 0 and 1, an all-zero depth frame, then frames 3 and 4."""
    d, c = frames[2]
    return [frames[0], frames[1], (np.zeros_like(d), c), frames[3], frames[4]]


def _track(frames, auto_reset=True, state=None):
    step = make_step_fn(PARAMS, INTR, auto_reset=auto_reset)
    state = state if state is not None else init_state(PARAMS, INTR, device="cpu")
    outs = []
    for d, c in frames:
        state, out = step(state, torch.as_tensor(d), torch.as_tensor(c))
        outs.append((state_to_numpy(state), out))
    return outs


def _assert_state_close(got, want, tag):
    np.testing.assert_array_equal(got["frame_count"], want["frame_count"], err_msg=tag)
    np.testing.assert_allclose(got["pose"], want["pose"], rtol=0, atol=POSE_TOL, err_msg=tag)
    touched = want["weight"] > 0
    wdiff = (got["weight"] != want["weight"]).sum()
    assert wdiff <= 1e-4 * touched.sum(), (tag, wdiff, touched.sum())
    gap = np.abs(got["tsdf"].astype(np.int32) - want["tsdf"])
    assert (gap > 0).sum() <= 0.03 * touched.sum(), (tag, (gap > 0).sum(), touched.sum())
    assert (gap > 1).sum() <= 1e-4 * touched.sum(), (tag, (gap > 1).sum(), touched.sum())


@pytest.fixture(scope="module")
def runs():
    """The JAX non-fused step over the orbit and the failing sequence, with
    and without auto_reset, in a child process; the port's free-running
    orbit while it works, then the port's step on each JAX state."""
    frames, gt = _orbit(N)
    fail = _failing(frames)
    job = torch_jaxref.start([
        ("kinfu_track", dict(params_kw=tuple(CFG.items()), intr=INTR_T,
                             sequences=[frames, fail])),
        ("kinfu_track", dict(params_kw=tuple(CFG.items()), intr=INTR_T, sequences=[fail],
                             auto_reset=False)),
    ], isa="SSE4_2")
    orbit = _track(frames)
    (jax_orbit, jax_fail), (jax_keep,) = job.result()
    forced = []
    for seq, ref, reset in ((frames, jax_orbit, True), (fail, jax_fail, True),
                            (fail, jax_keep, False)):
        steps = _track(seq[:1], auto_reset=reset)
        for k in range(1, len(seq)):
            steps += _track(seq[k:k + 1], auto_reset=reset,
                            state=state_from_numpy(ref[k - 1], device="cpu"))
        forced.append(steps)
    return frames, gt, orbit, forced, (jax_orbit, jax_fail, jax_keep)


def _assert_inliers_close(got: int, want: int, tag) -> None:
    assert abs(got - want) <= INLIER_TOL * max(want, 1), (tag, got, want)


def _assert_step_matches(steps, ref):
    for k, ((st, out), r) in enumerate(zip(steps, ref)):
        assert bool(out.tracking_ok) == r["tracking_ok"], k
        _assert_inliers_close(int(out.icp_inliers), r["icp_inliers"], k)
        np.testing.assert_allclose(out.pose_matrix.numpy(), r["pose_matrix"], rtol=0,
                                   atol=POSE_TOL, err_msg=f"frame {k}")
        _assert_state_close(st, r, f"frame {k}")
        for lv in range(PARAMS.pyramid_height):
            gv = (st["model_nmaps"][lv] != 0).any(-1)
            wv = (r["model_nmaps"][lv] != 0).any(-1)
            assert (gv != wv).mean() <= 1e-3, (k, lv)


def test_non_fused_step_matches_jax(runs):
    """The port's step on each JAX state gives JAX's next state; the
    free-running orbit tracks JAX's poses."""
    _, gt, orbit, (forced, _, _), (jax_orbit, _, _) = runs
    _assert_step_matches(forced, jax_orbit)
    assert all(r["tracking_ok"] for r in jax_orbit)
    for k, ((_, out), r) in enumerate(zip(orbit, jax_orbit)):
        assert bool(out.tracking_ok), k
        np.testing.assert_allclose(out.pose_matrix.numpy(), r["pose_matrix"], rtol=0,
                                   atol=POSE_TOL, err_msg=f"frame {k}")
    assert ate_rmse([o.pose_matrix.numpy() for _, o in orbit], gt) < 2e-3


def test_non_fused_failure_resets_or_keeps(runs):
    """The all-zero frame: with auto_reset the map and pose are wiped and
    the next frame bootstraps; with auto_reset=False the state keeps its
    bits (volume, pose, model maps, frame count) and the next frames track
    on; both as JAX does, step by step."""
    _, _, _, (_, fail, keep), (_, jax_fail, jax_keep) = runs
    for seq, ref in ((fail, jax_fail), (keep, jax_keep)):
        assert [r["tracking_ok"] for r in ref] == [True, True, False, True, True]
        _assert_step_matches(seq, ref)
    wiped = fail[2][0]
    assert not wiped["tsdf"].any() and not wiped["weight"].any()
    assert int(wiped["frame_count"]) == 1 and not wiped["model_vmaps"][0].any()
    np.testing.assert_array_equal(wiped["pose"], np.eye(4, dtype=np.float32))
    kept = keep[2][0]
    for key in ("tsdf", "weight", "color", "pose", "frame_count"):
        np.testing.assert_array_equal(kept[key], jax_keep[1][key], err_msg=key)
    for a, b in zip(kept["model_vmaps"] + kept["model_nmaps"],
                    jax_keep[1]["model_vmaps"] + jax_keep[1]["model_nmaps"]):
        np.testing.assert_array_equal(a, b)


def test_cpu_golden_trajectory():
    """tests/test_golden_trajectory.py on the port: the CPU default step
    ("auto": non-fused) reproduces the JAX package's recorded CPU golden."""
    frames, gt = _orbit(12)
    step = make_step_fn(PARAMS, INTR)
    st = init_state(PARAMS, INTR, device="cpu")
    est = []
    for d, c in frames:
        st, out = step(st, torch.as_tensor(d), torch.as_tensor(c))
        assert bool(out.tracking_ok)
        est.append(out.pose_matrix.numpy())
    golden = read_poses_reference_format(GOLDEN)
    assert len(golden) == len(est)
    ate_gold = ate_rmse(est, golden)
    assert ate_gold < 1e-3, f"drifted from golden: ATE {ate_gold:.5f} m"
    assert ate_rmse(est, gt) < 2e-3


def test_relocalize_step_matches_jax(runs):
    """`relocalize_step` on the state the port fused from frames 0-3,
    carried to JAX with its numpy fields: seeded 2 cm and 1 degree off
    frame 3's pose with frame 4's measurement it succeeds; with an all-zero
    frame it fails and leaves the state as it was, bit for bit."""
    frames, gt, _, (forced, _, _), _ = runs
    start = forced[3][0]
    R = rodrigues(torch.tensor([0.0, np.radians(1.0), 0.0]))
    seed = start["pose"].copy()
    seed[:3, :3] = R.numpy() @ seed[:3, :3]
    seed[:3, 3] += [0.02, 0.0, 0.0]
    d, c = frames[4]
    zero = np.zeros_like(d)
    job = torch_jaxref.start([
        ("relocalize_step", dict(state=start, depth=dd, color=c, seed_pose=seed,
                                 params_kw=tuple(CFG.items()), intr=INTR_T))
        for dd in (d, zero)], isa="SSE4_2")
    got = []
    for dd in (d, zero):
        st, out = relocalize_step(state_from_numpy(start, device="cpu"), torch.as_tensor(dd),
                                  torch.as_tensor(c), seed, PARAMS, INTR)
        got.append((state_to_numpy(st), out))
    ok_ref, fail_ref = job.result()

    (st, out), ref = got[0], ok_ref
    assert bool(out.tracking_ok) and ref["tracking_ok"]
    _assert_inliers_close(int(out.icp_inliers), ref["icp_inliers"], "success")
    np.testing.assert_allclose(out.pose_matrix.numpy(), ref["pose_matrix"], rtol=0,
                               atol=POSE_TOL)
    _assert_state_close(st, ref, "success")
    assert int(st["frame_count"]) == int(start["frame_count"]) + 1
    np.testing.assert_allclose(st["pose"][:3, 3], gt[4][:3, 3], rtol=0, atol=0.02)

    (st, out), ref = got[1], fail_ref
    assert not bool(out.tracking_ok) and not ref["tracking_ok"]
    for key in ("tsdf", "weight", "color", "pose", "frame_count"):
        np.testing.assert_array_equal(st[key], start[key], err_msg=key)
        np.testing.assert_array_equal(ref[key], start[key], err_msg=key)
    for a, b in zip(st["model_vmaps"] + st["model_nmaps"],
                    start["model_vmaps"] + start["model_nmaps"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out.pose_matrix.numpy(), start["pose"])


# ---- the mapping modules ------------------------------------------------------


def _pose(rvec, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = rodrigues(torch.tensor(np.asarray(rvec, np.float32))).numpy()
    T[:3, 3] = t
    return T


def _walk(n, rng, step_t=0.06, step_deg=4.0):
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        inc = _pose(rng.normal(0, np.radians(step_deg), 3), rng.normal(0, step_t, 3))
        poses.append((poses[-1] @ inc).astype(np.float32))
    return poses


def test_keyframes_and_relocalizer_match_jax():
    """KeyframeStore's selections and nearest keyframes, and the
    Relocalizer's state machine, decide as the JAX package's on a seeded
    random walk and a seeded run of tracking results."""
    rng = np.random.default_rng(3)
    poses = _walk(40, rng)
    mine, ref = keyframes.KeyframeStore(), jkeyframes.KeyframeStore()
    for i, T in enumerate(poses):
        assert mine.maybe_add(i, T) == ref.maybe_add(i, T), i
    assert len(mine) == len(ref) > 3
    for T in _walk(10, rng):
        assert mine.nearest(T).index == ref.nearest(T).index
    assert keyframes.KeyframeStore().nearest(np.eye(4)) is None

    r, jr = relocalize.Relocalizer(num_pixels=160 * 120), jreloc.Relocalizer(num_pixels=160 * 120)
    assert r.inlier_threshold == jr.inlier_threshold
    for ok, inl in zip(rng.random(60) < 0.4, rng.integers(0, 400, 60)):
        assert r.on_frame(bool(ok), int(inl)).value == jr.on_frame(bool(ok), int(inl)).value
        assert r.failed_attempts == jr.failed_attempts


def _graph(rng, n=8, noise=0.01):
    """tests/test_mapping.py's square loop of 8 poses with noisy odometry
    and an exact closure edge (weight 10)."""
    gt = [np.eye(4, dtype=np.float32)]
    steps = [_pose([0, 0.0, 0], [0.5, 0, 0]), _pose([0, np.pi / 4, 0], [0.5, 0, 0])] * 4
    for s in steps[: n - 1]:
        gt.append((gt[-1] @ s).astype(np.float32))
    est, edges = [gt[0]], []
    for k in range(len(gt) - 1):
        z = np.linalg.inv(gt[k].astype(np.float64)) @ gt[k + 1]
        z_noisy = (z @ _pose(rng.normal(0, noise, 3), rng.normal(0, noise, 3))).astype(np.float32)
        edges.append((k, k + 1, z_noisy, 1.0))
        est.append((est[-1] @ z_noisy).astype(np.float32))
    z_loop = (np.linalg.inv(gt[-1].astype(np.float64)) @ gt[0]).astype(np.float32)
    edges.append((len(gt) - 1, 0, z_loop, 10.0))
    return gt, est, edges


def test_pose_graph_matches_jax():
    """optimize_pose_graph on the noisy square loop against JAX's (poses
    within 1e-5, the RMS within 1e-6), and the JAX test's claims on the
    port: the closure pulls the endpoint back, exact odometry moves
    nothing."""
    gt, est, edges = _graph(np.random.default_rng(0))
    opt, rms = pose_graph.optimize_pose_graph(
        est, [pose_graph.PoseGraphEdge(*e) for e in edges], iterations=15, device="cpu")
    jopt, jrms = jpg.optimize_pose_graph(est, [jpg.PoseGraphEdge(*e) for e in edges],
                                         iterations=15)
    for a, b in zip(opt, jopt):
        np.testing.assert_allclose(a, b, rtol=0, atol=POSE_TOL)
    assert abs(rms - jrms) <= 1e-6
    drift_before = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    assert np.linalg.norm(opt[-1][:3, 3] - gt[-1][:3, 3]) < 0.3 * drift_before
    assert rms < 0.05

    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(4):
        poses.append((poses[-1] @ _pose([0, 0.1, 0], [0.2, 0, 0.05])).astype(np.float32))
    opt, rms = pose_graph.optimize_pose_graph(poses, pose_graph.odometry_edges(poses),
                                              iterations=5, device="cpu")
    assert rms < 1e-5
    for a, b in zip(poses, opt):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert pose_graph.optimize_pose_graph([], [], device="cpu") == ([], 0.0)


def test_loop_closure_matches_jax():
    """find_candidate, correct_trajectory and close_loop on a drifted
    out-and-back walk against the JAX package's: the same candidate, the
    corrected record and keyframe poses within 1e-5."""
    rng = np.random.default_rng(5)
    out = _walk(12, rng, step_t=0.04, step_deg=2.0)
    traj = out + out[-2::-1]
    record = [(T @ _pose(rng.normal(0, 0.002, 3), rng.normal(0, 0.004, 3))).astype(np.float32)
              for T in traj]
    cfg = loop_closure.LoopClosureConfig(max_translation=0.2, max_angle_deg=20.0,
                                         min_keyframe_gap=2, kf_min_translation=0.05,
                                         kf_min_rotation_deg=5.0)
    jcfg = jloop.LoopClosureConfig(**vars(cfg))
    stores = []
    for mod, c in ((keyframes, cfg), (jkeyframes, jcfg)):
        s = mod.KeyframeStore(min_translation=c.kf_min_translation,
                              min_rotation_deg=c.kf_min_rotation_deg)
        for i, T in enumerate(record[:-1]):
            s.maybe_add(i, T)
        stores.append(s)
    cur = record[-1]
    cand = loop_closure.find_candidate(stores[0], cur, cfg)
    assert cand is not None and cand == jloop.find_candidate(stores[1], cur, jcfg)
    z = (np.linalg.inv(traj[stores[0].keyframes[cand].index].astype(np.float64))
         @ traj[-1]).astype(np.float32)
    opt = [k.pose @ _pose([0, 0.01, 0], [0.01, 0, 0]) for k in stores[0].keyframes]
    np.testing.assert_allclose(
        np.stack(loop_closure.correct_trajectory(record, stores[0].keyframes, opt)),
        np.stack(jloop.correct_trajectory(record, stores[1].keyframes, opt)), rtol=0, atol=1e-6)
    got = loop_closure.close_loop(stores[0], record, cand, cur, z, cfg, device="cpu")
    want = jloop.close_loop(stores[1], record, cand, cur, z, jcfg)
    np.testing.assert_allclose(np.stack(got[0]), np.stack(want[0]), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=POSE_TOL)
    assert abs(got[2] - want[2]) <= 1e-6
    for a, b in zip(stores[0].keyframes, stores[1].keyframes):
        np.testing.assert_allclose(a.pose, b.pose, rtol=0, atol=POSE_TOL)


# ---- the sessions (tests/test_mapping.py L185-340) ------------------------------


def test_relocalization_recovers_without_map_wipe():
    """Track a few frames, feed garbage (tracking lost), then return to a
    previously seen view: the session re-acquires the old map from a
    keyframe seed instead of wiping it."""
    intr = Intrinsics(width=160, height=120, fx=140.0, fy=140.0, cx=79.5, cy=59.5)
    params = tiny_params(dim=128, levels=2).replace(
        icp_iters=(4, 8), volume_range=(2.0, 2.0, 2.0), volume_origin=(-1.0, -1.0, 0.5))
    scene = default_test_scene()
    traj = make_orbit_trajectory(5, angle_step_deg=0.4)
    frames = [scene.render_frame(T, intr) for T in traj]

    sess = KinFuSession(intr, params, device="cpu", relocalize=True)
    for depth, color in frames:
        assert sess.pipeline(color, depth)
    fused_before = int((sess.state.vol.weight > 0).sum())
    poses_before = len(sess.pose_record)
    assert len(sess.keyframes) >= 1

    zero_d = np.zeros_like(frames[0][0])
    zero_c = np.zeros_like(frames[0][1])
    assert not sess.pipeline(zero_c, zero_d)
    assert not sess.pipeline(zero_c, zero_d)
    assert int((sess.state.vol.weight > 0).sum()) == fused_before  # no wipe

    depth, color = frames[-1]
    assert sess.pipeline(color, depth)
    assert len(sess.pose_record) == poses_before + 1
    np.testing.assert_allclose(sess.pose_record[-1][:3, 3], traj[4][:3, 3], atol=0.02)


def _yaw_x(deg, x):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s, x], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float32)


def _out_and_back():
    """tests/test_mapping.py's drifting out-and-back loop: 96x72 frames,
    64^3, 24 poses out and 23 back."""
    intr = Intrinsics(width=96, height=72, fx=84.0, fy=84.0, cx=47.5, cy=35.5)
    params = tiny_params(dim=64, levels=2).replace(icp_iters=(3, 6), max_extracted_points=50_000)
    n_out = 24
    traj = [_yaw_x(0.25 * i, 0.005 * i) for i in range(n_out)]
    traj += [_yaw_x(0.25 * i, 0.005 * i) for i in range(n_out - 2, -1, -1)]
    scene = default_test_scene()
    frames = [scene.render_frame(T, intr) for T in traj]
    gt = [np.linalg.inv(traj[0]) @ T for T in traj]
    return intr, params, scene, frames, gt


def test_loop_closure_corrects_drift():
    """The out-and-back loop's closure, held from the JAX session's own
    state: the JAX KinFuSession(pose_graph=True) runs the loop until its
    closure fires (frame 32 against keyframe 13), and the port's
    `_pose_graph_update` is given the same state, pose record, keyframes
    and frame. It closes the same loop (same frame and keyframe, inliers
    within INLIER_TOL), gives JAX's corrected trajectory, keyframe poses
    and current pose within POSE_TOL, lowers the trajectory's ATE and the
    current pose's error, and its rebuilt map lies as close to the true
    scene as JAX's.

    Both sessions are not run free over the loop and compared: at 64^3 the
    scenario is chaotic. The port's step agrees with JAX's to 2e-7 from
    the same state (test_non_fused_step_matches_jax), yet the free-running
    trajectories part within a few frames, and the port's run turns on
    the last bit of the ICP's sums, whose order follows the CPU thread
    count (ROADMAP.md queue 3)."""
    from kinfu_tpu.config import tiny_params as jtiny
    from kinfu_tpu.geometry.intrinsics import Intrinsics as JIntr
    from kinfu_tpu.geometry.se3 import pose_matrix as jpose_matrix
    from kinfu_tpu.pipeline.session import KinFuSession as JSession

    intr, params, scene, frames, gt = _out_and_back()
    cfg_kw = dict(max_translation=0.04, max_angle_deg=10.0, min_keyframe_gap=3,
                  kf_min_translation=0.025, kf_min_rotation_deg=4.0, cooldown_frames=100,
                  min_inlier_frac=0.05)
    jsess = JSession(JIntr(96, 72, 84.0, 84.0, 47.5, 35.5),
                     jtiny(dim=64, levels=2).replace(icp_iters=(3, 6), max_extracted_points=50_000),
                     pose_graph=True, loop_config=jloop.LoopClosureConfig(**cfg_kw))

    def state_np(st):
        return dict(tsdf=np.asarray(st.vol.tsdf), weight=np.asarray(st.vol.weight),
                    color=np.asarray(st.vol.color), pose=np.asarray(jpose_matrix(st.pose)),
                    model_vmaps=[np.asarray(v) for v in st.model_vmaps],
                    model_nmaps=[np.asarray(n) for n in st.model_nmaps],
                    frame_count=np.asarray(st.frame_count))

    jax_update, seen = jsess._pose_graph_update, {}

    def capture(depth, color, pose_m):
        before = dict(state=state_np(jsess.state), record=[p.copy() for p in jsess.pose_record],
                      keyframes=copy.deepcopy(jsess.pg_keyframes.keyframes),
                      cooldown=jsess._pg_cooldown, depth=np.array(depth),
                      color=np.array(color), pose_m=np.array(pose_m))
        new_cur = jax_update(depth, color, pose_m)
        if jsess.loop_closures and not seen:
            cloud = np.asarray(jsess.extract_pointcloud())
            nmap = np.asarray(jsess.state.model_nmaps[0])
            seen.update(before=before, new_cur=np.array(new_cur),
                        record=[p.copy() for p in jsess.pose_record],
                        kf_poses=[k.pose.copy() for k in jsess.pg_keyframes.keyframes],
                        map_err=float(np.abs(scene.sdf(cloud)).mean()),
                        valid=float((np.abs(nmap).sum(-1) > 0).mean()))
        return new_cur

    jsess._pose_graph_update = capture
    for d, c in frames:
        assert jsess.pipeline(c, d)
        if seen:
            break
    assert seen, "the JAX session closed no loop"
    jlc = jsess.loop_closures[0]
    assert jlc["frame"] - jlc["keyframe"] > cfg_kw["min_keyframe_gap"]

    before = seen["before"]
    sess = KinFuSession(intr, params, device="cpu", pose_graph=True,
                        loop_config=loop_closure.LoopClosureConfig(**cfg_kw))
    sess.state = state_from_numpy(before["state"], device="cpu")
    sess.pose_record = list(before["record"])
    sess.pg_keyframes.keyframes = [keyframes.Keyframe(**vars(k)) for k in before["keyframes"]]
    sess._pg_cooldown = before["cooldown"]
    new_cur = sess._pose_graph_update(torch.as_tensor(before["depth"]),
                                      torch.as_tensor(before["color"]), before["pose_m"])

    assert len(sess.loop_closures) == 1
    lc = sess.loop_closures[0]
    assert (lc["frame"], lc["keyframe"]) == (jlc["frame"], jlc["keyframe"]), (lc, jlc)
    _assert_inliers_close(lc["inliers"], jlc["inliers"], "closure")
    np.testing.assert_allclose(new_cur, seen["new_cur"], rtol=0, atol=POSE_TOL)
    for got, want in zip(sess.pose_record, seen["record"], strict=True):
        np.testing.assert_allclose(got, want, rtol=0, atol=POSE_TOL)
    for kf, want in zip(sess.pg_keyframes.keyframes, seen["kf_poses"], strict=True):
        np.testing.assert_allclose(kf.pose, want, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(pose_matrix(sess.state.pose).numpy(), new_cur, rtol=0, atol=POSE_TOL)

    f = lc["frame"]
    drifted = ate_rmse(before["record"], gt[: f + 1])
    corrected = ate_rmse(sess.pose_record, gt[: f + 1])
    assert corrected < drifted, (corrected, drifted)
    err = lambda T: float(np.abs(T[:3, 3] - gt[f][:3, 3]).max())  # noqa: E731
    assert err(new_cur) < err(before["pose_m"]), (err(new_cur), err(before["pose_m"]))

    map_err = float(np.abs(scene.sdf(sess.extract_pointcloud())).mean())
    np.testing.assert_allclose(map_err, seen["map_err"], rtol=1e-3)
    valid = float((sess.state.model_nmaps[0].abs().sum(-1) > 0).float().mean())
    np.testing.assert_allclose(valid, seen["valid"], rtol=1e-3)


def test_closure_icp_matches_jax():
    """The session's closure ICP (the current maps pre-transformed by the
    drifted estimate z0, ICP against a keyframe's stored model maps) gives
    the JAX session's Z on the same inputs, within 1e-5: the model maps of
    the JAX session at the out-and-back loop's frame 14 as the keyframe's,
    frames 8-21 against them, seeded with the true relative pose. Held
    where the closure is well conditioned, JAX's Z within 15 mm of the
    truth (7 of the 14 frames). Elsewhere at 64^3 the closure lands 16-82
    mm off and either package's Z moves with the last bit of its inputs:
    the port fed JAX's own measurement maps there gives Zs up to 12 mm
    apart from its own."""
    import jax.numpy as jnp

    from kinfu_tpu.config import tiny_params as jtiny
    from kinfu_tpu.geometry.intrinsics import Intrinsics as JIntr
    from kinfu_tpu.pipeline.session import KinFuSession as JSession
    from kinfu_tpu_torch.pipeline.kinfu import _measurement

    intr, params, _, frames, gt = _out_and_back()
    jsess = JSession(JIntr(96, 72, 84.0, 84.0, 47.5, 35.5),
                     jtiny(dim=64, levels=2).replace(icp_iters=(3, 6)), pose_graph=True)
    for d, c in frames[:15]:
        assert jsess.pipeline(c, d)
    jkv, jkn = jsess.state.model_vmaps, jsess.state.model_nmaps
    kv = [torch.as_tensor(np.asarray(v)) for v in jkv]
    kn = [torch.as_tensor(np.asarray(n)) for n in jkn]
    sess = KinFuSession(intr, params, device="cpu", pose_graph=True)
    held = 0
    for cur in range(8, 22):
        d, _ = frames[cur]
        zt = np.linalg.inv(gt[14]) @ gt[cur]
        z0 = zt.astype(np.float32)
        jv, jn = jsess._measurement_pyr(jnp.asarray(d))
        zj, okj, nj = jsess._closure_icp(jv, jn, jkv, jkn, jnp.asarray(z0))
        if not bool(okj) or np.abs(np.asarray(zj) - zt).max() > 0.015:
            continue
        _, tv, tn = _measurement(torch.as_tensor(d), params, intr)
        z, ok, n = sess._closure_icp(tv, tn, kv, kn, z0)
        assert bool(ok), cur
        _assert_inliers_close(int(n), int(nj), cur)
        np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=0, atol=POSE_TOL)
        held += 1
    assert held >= 5, held


def test_closure_rebuild_realigns_map():
    """Translating every keyframe pose by 0.12 m in x and rebuilding moves
    the geometry: the fused sphere sits on the shifted sphere, and the
    rebuilt model maps keep tracking viable."""
    intr = Intrinsics(width=96, height=72, fx=84.0, fy=84.0, cx=47.5, cy=35.5)
    params = tiny_params(dim=64, levels=2).replace(icp_iters=(3, 6), max_extracted_points=50_000)
    cfg = loop_closure.LoopClosureConfig(kf_min_translation=0.002, kf_min_rotation_deg=0.5)
    scene = default_test_scene()
    traj = []
    for i in range(4):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.004 * i
        traj.append(T)
    frames = [scene.render_frame(T, intr) for T in traj]

    sess = KinFuSession(intr, params, device="cpu", pose_graph=True, loop_config=cfg)
    for d, c in frames:
        assert sess.pipeline(c, d)
    assert len(sess.pg_keyframes.keyframes) >= 2
    assert all(k.depth is not None for k in sess.pg_keyframes.keyframes)
    cloud0 = sess.extract_pointcloud().copy()

    dx = 0.12
    shift = np.eye(4, dtype=np.float64)
    shift[0, 3] = dx
    for kf in sess.pg_keyframes.keyframes:
        kf.pose = (shift @ kf.pose.astype(np.float64)).astype(np.float32)
    new_cur = (shift @ sess.pose_record[-1].astype(np.float64)).astype(np.float32)
    d, c = frames[-1]
    sess._rebuild_map(torch.as_tensor(d), torch.as_tensor(c), new_cur)
    cloud1 = sess.extract_pointcloud()

    sph_c = np.array([0.45, -0.25, 1.7])
    sph_r = 0.4

    def on_sphere(pts, centre, band=0.03):
        return int((np.abs(np.linalg.norm(pts - centre, axis=1) - sph_r) < band).sum())

    assert on_sphere(cloud0, sph_c) > 200
    n_shifted = on_sphere(cloud1, sph_c + [dx, 0, 0])
    n_orig = on_sphere(cloud1, sph_c)
    assert n_shifted > 200 and n_shifted > 2.5 * n_orig, (n_shifted, n_orig)
    assert (sess.state.model_nmaps[0].abs().sum(-1) > 0).float().mean() > 0.2
