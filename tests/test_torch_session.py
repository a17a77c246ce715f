"""The port's KinFuSession (kinfu_tpu_torch/pipeline/session.py) and the
modules it brings: render, extraction, PLY, poses, checkpoints.

The session runs on the CPU at 128^3 / 160x120, 2 pyramid levels, the fused
step with warped ICP (every kernel's plain version), over 4 frames of the
synthetic orbit. Its pose record must equal `kinfu_step` driven by hand.
On its final state, `render_phong` / `render_normals` and
`extract_points[_colored]` are held against the JAX package's functions,
jitted as the JAX session runs them, in a child process without FMA
contraction (tests/torch_jaxref.py): the uint8 images bit for bit, the
extraction's order, count and colours exactly and its points within
1e-6 m. Checkpoints cross between the packages with equal arrays."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu import config as jcfg
from kinfu_tpu.geometry.intrinsics import Intrinsics as JIntr
from kinfu_tpu.io import checkpoint as jckpt
from kinfu_tpu.io import ply as jply
from kinfu_tpu.io import poses as jposes
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu_torch.eval.ate import ate_rmse
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.io import checkpoint, ply, poses
from kinfu_tpu_torch.pipeline.kinfu import _volume_pose, init_state, make_step_fn
from kinfu_tpu_torch.pipeline.render import render_normals, render_phong
from kinfu_tpu_torch.pipeline.session import KinFuSession
from kinfu_tpu_torch.pipeline.state import KinFuState, state_from_numpy, state_to_numpy
from kinfu_tpu_torch.volume.extract import extract_points, extract_points_colored
from kinfu_tpu_torch.volume.tsdf import create_volume

torch.set_num_threads(2)

INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
INTR = Intrinsics(*INTR_T)
CFG = dict(
    pyramid_height=2,
    icp_iters=(3, 4),
    volume_dims=(128, 128, 128),
    icp_mode="warped",
    fused_mode="on",
    raycast_face=(256, 104.0),
)
PARAMS = KinFuParams(**CFG)
N = 4
#: a cap below the surface's crossing count, to hold the truncated order too
SMALL_CAP = 5000


def _frames(n=N + 1):
    scene = default_test_scene()
    traj = make_orbit_trajectory(n, angle_step_deg=0.3)
    gt = [np.linalg.inv(traj[0]) @ T for T in traj]
    return [scene.render_frame(T, INTR) for T in traj], gt


@pytest.fixture(scope="module")
def run():
    """The session over frames 0-3 and its final state as numpy arrays; the
    JAX render and extraction of that state start in a child process."""
    frames, gt = _frames()
    sess = KinFuSession(INTR, PARAMS, device="cpu")
    oks = [sess.pipeline(c, d) for d, c in frames[:N]]
    st = state_to_numpy(sess.state)
    job = torch_jaxref.start(
        [("render", dict(eye_t=st["pose"][:3, 3], vmap=st["model_vmaps"][0],
                         nmap=st["model_nmaps"][0]))]
        + [("extract", dict(tsdf=st["tsdf"], weight=st["weight"], color=st["color"],
                            params_kw=tuple(CFG.items()), max_points=m))
           for m in (None, SMALL_CAP)])
    return sess, oks, st, frames, gt, job


@pytest.fixture(scope="module")
def jax_out(run):
    return run[-1].result()


def test_session_tracks_like_the_step_by_hand(run):
    sess, oks, _, frames, gt, _ = run
    assert oks == [True] * N and sess.frame_count == N + 1
    assert len(sess.pose_record) == N and sess.last_icp_inliers > 1000
    step = make_step_fn(PARAMS, INTR)
    state = init_state(PARAMS, INTR, device="cpu")
    record = [np.eye(4, dtype=np.float32)]
    for k, (d, c) in enumerate(frames[:N]):
        state, out = step(state, torch.as_tensor(d), torch.as_tensor(c))
        if k:
            record.append(out.pose_matrix.numpy())
    assert len(sess.pose_record) == N
    for a, b in zip(sess.pose_record, record):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sess.get_cur_camera_pose(), record[-1])
    assert ate_rmse(sess.pose_record, gt[:N]) < 2e-3


def test_render_matches_jax(run, jax_out):
    sess, _, st, *_ = run
    phong, normals = jax_out[0]
    got = sess.get_render_map(KinFuSession.PHONG)
    assert got.dtype == np.uint8 and got.shape == (120, 160, 3)
    assert (got != 0).any(-1).mean() > 0.5
    np.testing.assert_array_equal(got, phong)
    np.testing.assert_array_equal(sess.get_render_map(KinFuSession.NORMAL), normals)
    # the module functions on the numpy state agree with the session's view
    t = {k: torch.as_tensor(st[k][0]) for k in ("model_vmaps", "model_nmaps")}
    np.testing.assert_array_equal(
        render_phong(torch.as_tensor(st["pose"][:3, 3]), t["model_vmaps"],
                     t["model_nmaps"]).numpy(), phong)
    np.testing.assert_array_equal(render_normals(t["model_nmaps"]).numpy(), normals)


@pytest.mark.parametrize("cap", [None, SMALL_CAP])
def test_extract_matches_jax(run, jax_out, cap):
    _, _, st, *_ = run
    (jpts, jn), (jcpts, jrgb, jcn) = jax_out[1 if cap is None else 2]
    vol = state_from_numpy(st, device="cpu").vol
    vpose = _volume_pose(PARAMS, "cpu")
    pts, n = extract_points(vol, vpose, PARAMS, cap)
    cpts, rgb, cn = extract_points_colored(vol, vpose, PARAMS, cap)
    assert int(n) == int(jn) == int(cn) == int(jcn)
    assert int(n) == SMALL_CAP if cap else int(n) > SMALL_CAP
    assert pts.shape == jpts.shape and rgb.shape == jrgb.shape
    np.testing.assert_allclose(pts.numpy(), jpts, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cpts.numpy(), jcpts, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(rgb.numpy(), jrgb)
    assert not pts[int(n):].any() and not rgb[int(n):].any()
    assert rgb[: int(n)].any()


def test_exports_round_trip(run, tmp_path):
    sess, *_ = run
    pts = sess.extract_pointcloud()
    assert pts.shape[0] > SMALL_CAP
    lo = np.asarray(PARAMS.volume_origin)
    assert ((pts >= lo) & (pts <= lo + np.asarray(PARAMS.volume_range))).all()
    sess.save_pointcloud(str(tmp_path / "cloud.ply"))
    back = ply.read_ply(str(tmp_path / "cloud.ply"))
    np.testing.assert_allclose(back, pts, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(jply.read_ply(str(tmp_path / "cloud.ply")), back)
    cpts, cols = sess.extract_pointcloud_colored()
    for binary in (False, True):
        for c in (cols, None):
            ply.write_ply(str(tmp_path / "c.ply"), cpts, c, binary=binary)
            jply.write_ply(str(tmp_path / "j.ply"), cpts, c, binary=binary)
            assert (tmp_path / "c.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
        # read_ply reads xyz: ASCII with or without colour, binary without
        np.testing.assert_allclose(ply.read_ply(str(tmp_path / "c.ply")), cpts,
                                   rtol=0 if binary else 1e-5, atol=0 if binary else 1e-6)
    sess.save_poses(str(tmp_path / "poses.txt"))
    got = poses.read_poses_reference_format(str(tmp_path / "poses.txt"))
    assert len(got) == len(sess.pose_record)
    for a, b in zip(got, sess.pose_record):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-8)
    jposes.write_poses_reference_format(str(tmp_path / "j.txt"), sess.pose_record)
    assert (tmp_path / "poses.txt").read_text() == (tmp_path / "j.txt").read_text()
    poses.write_poses_tum(str(tmp_path / "tum.txt"), sess.pose_record)
    ts, tum = poses.read_poses_tum(str(tmp_path / "tum.txt"))
    np.testing.assert_array_equal(ts, np.arange(len(sess.pose_record)))
    for a, b in zip(tum, sess.pose_record):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    img = sess.render_3d(width=96, height=72)
    assert img.shape == (72, 96, 3) and img.dtype == np.uint8


def _arrays(st):
    """A session state's arrays in the checkpoint's names."""
    d = state_to_numpy(st) if isinstance(st, KinFuState) else st
    out = {k: d[k] for k in ("tsdf", "weight", "color", "frame_count")}
    out["pose"] = d["pose"]
    for i, (v, n) in enumerate(zip(d["model_vmaps"], d["model_nmaps"])):
        out[f"v{i}"], out[f"n{i}"] = v, n
    return out


def _assert_same_session(a_arrays, a_record, a_count, b_arrays, b_record, b_count):
    assert a_arrays.keys() == b_arrays.keys()
    for k in a_arrays:
        np.testing.assert_array_equal(np.asarray(a_arrays[k]), np.asarray(b_arrays[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(np.stack(a_record), np.stack(b_record))
    assert a_count == b_count


def test_checkpoint_crosses_between_packages(run, tmp_path):
    sess, _, st, frames, *_ = run
    # the port's checkpoint loads in the JAX package
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(path, sess)
    js = jckpt.load_checkpoint(path)
    jst = js.state
    j_arrays = {"tsdf": jst.vol.tsdf, "weight": jst.vol.weight, "color": jst.vol.color,
                "frame_count": jst.frame_count}
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = np.asarray(jst.pose.R), np.asarray(jst.pose.t)
    j_arrays["pose"] = T
    for i, (v, n) in enumerate(zip(jst.model_vmaps, jst.model_nmaps)):
        j_arrays[f"v{i}"], j_arrays[f"n{i}"] = v, n
    _assert_same_session(_arrays(sess.state), sess.pose_record, sess.frame_count,
                         j_arrays, js.pose_record, js.frame_count)
    assert dataclasses.asdict(js.params) == {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in dataclasses.asdict(PARAMS).items()}

    # the JAX package's checkpoint of the same arrays loads in the port
    jpath = str(tmp_path / "jax.npz")
    np_state = state_from_numpy(st, device="cpu")
    duck = types.SimpleNamespace(
        state=types.SimpleNamespace(
            vol=types.SimpleNamespace(tsdf=st["tsdf"], weight=st["weight"], color=st["color"]),
            pose=types.SimpleNamespace(R=st["pose"][:3, :3], t=st["pose"][:3, 3]),
            model_vmaps=st["model_vmaps"], model_nmaps=st["model_nmaps"],
            frame_count=st["frame_count"]),
        pose_record=sess.pose_record, frame_count=sess.frame_count,
        params=jcfg.KinFuParams(**CFG), intr=JIntr(*INTR_T), streaming=False)
    jckpt.save_checkpoint(jpath, duck)
    ps = checkpoint.load_checkpoint(jpath, device="cpu")
    assert ps.params == PARAMS and ps.intr == INTR and ps.device.type == "cpu"
    _assert_same_session(_arrays(ps.state), ps.pose_record, ps.frame_count,
                         _arrays(np_state), sess.pose_record, sess.frame_count)
    # and the loaded session tracks the next frame
    d, c = frames[N]
    assert ps.pipeline(c, d) and ps.frame_count == N + 2
    assert len(ps.pose_record) == N + 1


def test_reset_bootstraps_again(run):
    frames = run[3]
    sess = KinFuSession(INTR, PARAMS, device="cpu")
    assert sess.pipeline(frames[0][1], frames[0][0]) and sess.frame_count == 2
    sess.reset()
    assert sess.frame_count == 1 and len(sess.pose_record) == 1
    assert not sess.state.vol.weight.any()
    # an all-zero depth frame after the bootstrap fails and resets
    assert sess.pipeline(frames[0][1], frames[0][0])
    assert not sess.pipeline(frames[1][1], np.zeros_like(frames[1][0]))
    assert sess.frame_count == 1 and len(sess.pose_record) == 1


@pytest.mark.parametrize("flag", ["relocalize", "streaming", "pose_graph"])
def test_unported_modes_raise(flag, tmp_path):
    """The session's modes run (each was ported after this test was
    written, which is its name): relocalize and pose_graph track two
    frames and fill their keyframe stores; streaming mirrors
    tests/test_session.py::test_streaming_session_tracks_and_checkpoints
    (streaming beside relocalization raises, as in JAX)."""
    if flag == "streaming":
        _streaming_session_tracks_and_checkpoints(tmp_path)
        return
    frames, _ = _frames(2)
    sess = KinFuSession(INTR, PARAMS, device="cpu", **{flag: True})
    assert all(sess.pipeline(c, d) for d, c in frames)
    assert len(sess.pose_record) == 2
    store = sess.keyframes if flag == "relocalize" else sess.pg_keyframes
    assert len(store) >= 1


def _streaming_session_tracks_and_checkpoints(tmp_path):
    """A streaming session tracks 3 frames, renders and extracts; its
    checkpoint loads in the JAX package with `origin_vox` equal, and the JAX
    package's checkpoint of a streaming state loads in the port and tracks
    the next frame, keeping its `origin_vox`. The state crossing is the
    session's own, its grid moved by (0, 0, 2) voxels with the content
    shifted to match, so the world's geometry stays where it was."""
    from kinfu_tpu_torch.pipeline.streaming import StreamingState, _vol_pose_dyn
    from kinfu_tpu_torch.volume.stream import shift_volume

    with pytest.raises(ValueError, match="streaming \\+ relocalize"):
        KinFuSession(INTR, PARAMS, device="cpu", streaming=True, relocalize=True)
    frames, _ = _frames(4)
    sess = KinFuSession(INTR, PARAMS, device="cpu", streaming=True)
    assert not sess.pose_graph
    for d, c in frames[:3]:
        assert sess.pipeline(c, d)
    assert sess.frame_count == 4
    assert sess.get_render_map(sess.PHONG).shape == (INTR.height, INTR.width, 3)
    assert len(sess.extract_pointcloud()) > 100

    origin = torch.tensor([0, 0, 2], dtype=torch.int32)
    ks = sess.state.kinfu
    sess.state = StreamingState(ks._replace(vol=shift_volume(ks.vol, origin)),
                                sess.state.origin_vox + origin)
    # the points are where they were: the extraction follows the grid
    pts = sess.extract_pointcloud()
    t = _vol_pose_dyn(PARAMS, sess.state.origin_vox).t.numpy()
    assert len(pts) > 100 and (pts >= t - 1e-6).all()
    assert (pts <= t + np.asarray(PARAMS.volume_range) + 1e-6).all()

    path = str(tmp_path / "stream.npz")
    checkpoint.save_checkpoint(path, sess)
    js = jckpt.load_checkpoint(path)
    assert js.streaming
    np.testing.assert_array_equal(np.asarray(js.state.origin_vox), [0, 0, 2])
    np.testing.assert_array_equal(np.asarray(js.state.kinfu.vol.tsdf),
                                  sess.state.kinfu.vol.tsdf.numpy())

    st = state_to_numpy(sess.state.kinfu)
    duck = types.SimpleNamespace(
        state=types.SimpleNamespace(
            origin_vox=np.asarray([0, 0, 2], np.int32),
            kinfu=types.SimpleNamespace(
                vol=types.SimpleNamespace(tsdf=st["tsdf"], weight=st["weight"],
                                          color=st["color"]),
                pose=types.SimpleNamespace(R=st["pose"][:3, :3], t=st["pose"][:3, 3]),
                model_vmaps=st["model_vmaps"], model_nmaps=st["model_nmaps"],
                frame_count=st["frame_count"])),
        pose_record=sess.pose_record, frame_count=sess.frame_count,
        params=jcfg.KinFuParams(**CFG), intr=JIntr(*INTR_T), streaming=True)
    jpath = str(tmp_path / "jax_stream.npz")
    jckpt.save_checkpoint(jpath, duck)
    ps = checkpoint.load_checkpoint(jpath, device="cpu")
    assert ps.streaming and ps.params == PARAMS
    for a, b in zip(ps.state.kinfu.vol, sess.state.kinfu.vol):
        assert torch.equal(a, b)
    d, c = frames[3]
    assert ps.pipeline(c, d) and ps.frame_count == 5
    assert ps.state.origin_vox.tolist() == [0, 0, 2]
    ps.reset()
    assert ps.state.origin_vox.tolist() == [0, 0, 0] and ps.frame_count == 1


def test_save_3d_raises(tmp_path):
    """save_3d writes the 3D view through the port's PNG writer (it raised
    before the writer existed); a path it cannot write raises as open()
    does, and a good one reads back as render_3d()'s array."""
    from kinfu_tpu_torch.io.images import read_color_png

    sess = KinFuSession(Intrinsics(16, 12, 10.0, 10.0, 7.5, 5.5),
                        KinFuParams(volume_dims=(16, 16, 16), fused_mode="on"), device="cpu")
    with pytest.raises(FileNotFoundError):
        sess.save_3d(str(tmp_path / "missing" / "view.png"), width=64, height=48)
    sess.save_3d(str(tmp_path / "view.png"), width=64, height=48)
    np.testing.assert_array_equal(read_color_png(str(tmp_path / "view.png")),
                                  sess.render_3d(width=64, height=48))


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without CUDA, every entry point that allocates state raises unless
    the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    intr, params = Intrinsics(16, 12, 10.0, 10.0, 7.5, 5.5), KinFuParams(volume_dims=(8, 8, 8))
    d = state_to_numpy(init_state(params, intr, device="cpu"))
    sess = KinFuSession(intr, params, device="cpu")
    checkpoint.save_checkpoint(str(tmp_path / "c.npz"), sess)
    calls = [lambda: init_state(params, intr), lambda: create_volume((8, 8, 8)),
             lambda: state_from_numpy(d), lambda: KinFuSession(intr, params),
             lambda: checkpoint.load_checkpoint(str(tmp_path / "c.npz"))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_streaming_checkpoint_raises(tmp_path):
    """A checkpoint that says it is a streaming session's loads as one with
    its grid offset, `origin_vox`; without that array it raises, as the
    JAX package's `load_checkpoint` does."""
    import json

    sess = KinFuSession(Intrinsics(16, 12, 10.0, 10.0, 7.5, 5.5),
                        KinFuParams(volume_dims=(16, 16, 16)), device="cpu")
    path = tmp_path / "s.npz"
    checkpoint.save_checkpoint(str(path), sess)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("meta")))
    meta["streaming"] = True
    np.savez(path, meta=json.dumps(meta), **arrays)
    with pytest.raises(KeyError, match="origin_vox"):
        checkpoint.load_checkpoint(str(path), device="cpu")
    np.savez(path, meta=json.dumps(meta), origin_vox=np.asarray([1, -2, 3], np.int32),
             **arrays)
    loaded = checkpoint.load_checkpoint(str(path), device="cpu")
    assert loaded.streaming and loaded.state.origin_vox.tolist() == [1, -2, 3]
    assert loaded.state.origin_vox.dtype == torch.int32
    assert torch.equal(loaded.state.kinfu.vol.tsdf, sess.state.vol.tsdf)
