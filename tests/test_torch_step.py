"""The slice as a whole: the port's `kinfu_step` against the JAX package's,
both on the fused step (fused_mode="on", warped integrate and raycast,
icp_mode="gather"), at 128^3, 160x120 and a 256 px raycast face, over the
synthetic orbit. The JAX step runs interpret-mode Pallas without FMA
contraction (tests/torch_jaxref.py); the port runs the kernels' plain
versions.

Tolerances: poses 1e-4. The bootstrap frame fuses at the identity and
gives the same volume bit for bit. After it, the two packages'
transcendental functions and reduction orders differ in the last bits, so
the tracked poses differ by ~1e-7 (3e-7 after four frames), and a voxel's
fused value can land on the other side of an int16 step: weights are
equal, the TSDF differs by at most 1e-3 (33 steps of 1/32767) and by at
most 1e-5 in the mean over the touched voxels. Tracking flags, inlier
counts and frame counts are equal."""

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu_torch.eval.ate import ate_rmse
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.pipeline.kinfu import init_state, kinfu_step, make_step_fn
from kinfu_tpu_torch.pipeline.state import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
INTR = Intrinsics(*INTR_T)
CFG = dict(
    pyramid_height=2,
    icp_iters=(3, 4),
    volume_dims=(128, 128, 128),
    integrate_mode="warped",
    raycast_mode="warped",
    icp_mode="gather",
    fused_mode="on",
    raycast_face=(256, 104.0),
)
PARAMS = KinFuParams(**CFG)
N = 4
POSE_TOL = 1e-4


def _frames():
    scene = default_test_scene()
    traj = make_orbit_trajectory(N, angle_step_deg=0.3)
    gt = [np.linalg.inv(traj[0]) @ T for T in traj]
    return [scene.render_frame(T, INTR) for T in traj], gt


def _failing(frames):
    """Frames 0 and 1, an all-zero depth frame, then frame 3."""
    d, c = frames[2]
    return [frames[0], frames[1], (np.zeros_like(d), c), frames[3]]


@pytest.fixture(scope="module")
def runs():
    """The JAX step in a child process; the port's runs of the same two
    sequences while it compiles."""
    frames, gt = _frames()
    job = torch_jaxref.start([("kinfu_track", dict(
        params_kw=tuple(CFG.items()), intr=INTR_T,
        sequences=[frames, _failing(frames)]))])
    port_orbit, port_fail = _track(frames), _track(_failing(frames))
    jax_orbit, jax_fail = job.result()[0]
    return frames, gt, jax_orbit, jax_fail, port_orbit, port_fail


def _track(frames, state=None, params=PARAMS, **kw):
    step = make_step_fn(params, INTR, **kw)
    state = state if state is not None else init_state(params, INTR, device="cpu")
    outs = []
    for d, c in frames:
        state, out = step(state, torch.as_tensor(d), torch.as_tensor(c))
        outs.append((state_to_numpy(state), out))
    return outs


def _assert_volume_close(got, want, tag):
    np.testing.assert_array_equal(got["weight"], want["weight"], err_msg=tag)
    touched = want["weight"] > 0
    assert touched.sum() > 10_000, tag
    gap = np.abs(got["tsdf"].astype(np.float32) - want["tsdf"]) / 32767.0
    assert gap.max() <= 1e-3, (tag, gap.max())
    assert gap[touched].mean() <= 1e-5, (tag, gap[touched].mean())


def test_step_matches_jax_over_orbit(runs):
    _, gt, jax_orbit, _, outs, _ = runs
    for k, ((st, out), ref) in enumerate(zip(outs, jax_orbit)):
        assert bool(out.tracking_ok) == ref["tracking_ok"] is True, k
        assert int(st["frame_count"]) == int(ref["frame_count"]) == k + 2
        np.testing.assert_allclose(out.pose_matrix.numpy(), ref["pose_matrix"], rtol=0,
                                   atol=POSE_TOL, err_msg=f"frame {k}")
        assert int(out.icp_inliers) == ref["icp_inliers"], k
        _assert_volume_close(st, ref, f"frame {k}")
    for key in ("tsdf", "weight", "color"):
        np.testing.assert_array_equal(outs[0][0][key], jax_orbit[0][key], err_msg=key)
    ate = ate_rmse([o.pose_matrix.numpy() for _, o in outs], gt)
    assert ate < 2e-3, f"ATE {ate * 1e3:.3f} mm"


def test_warped_icp_step_matches_gather_step(runs):
    """The port's step with warped ICP (K1's plain version) tracks the orbit
    as the gather step does: the two differ only in how the distance and
    angle gates are compared (squares against norms)."""
    frames, _, _, _, gather_orbit, _ = runs
    warped_orbit = _track(frames, params=PARAMS.replace(icp_mode="warped"))
    for k, ((st, out), (gst, gout)) in enumerate(zip(warped_orbit, gather_orbit)):
        assert bool(out.tracking_ok) and bool(gout.tracking_ok), k
        np.testing.assert_allclose(out.pose_matrix.numpy(), gout.pose_matrix.numpy(), rtol=0,
                                   atol=POSE_TOL, err_msg=f"frame {k}")
        assert int(out.icp_inliers) == int(gout.icp_inliers), k
        assert int(st["frame_count"]) == int(gst["frame_count"])
        _assert_volume_close(st, gst, f"frame {k}")


def test_state_carries_across_from_jax(runs):
    """The JAX state after two frames, carried over as numpy arrays, gives
    the JAX package's third step."""
    frames, _, jax_orbit, *_ = runs
    state = state_from_numpy(jax_orbit[1], device="cpu")
    for key in ("tsdf", "weight", "color", "pose", "frame_count"):
        np.testing.assert_array_equal(state_to_numpy(state)[key], jax_orbit[1][key])
    (st, out), = _track(frames[2:3], state=state)
    ref = jax_orbit[2]
    assert bool(out.tracking_ok) and ref["tracking_ok"]
    np.testing.assert_allclose(out.pose_matrix.numpy(), ref["pose_matrix"], rtol=0,
                               atol=POSE_TOL)
    _assert_volume_close(st, ref, "carried")


def test_failed_frame_resets_like_jax(runs):
    _, _, _, jax_fail, _, outs = runs
    assert [bool(o.tracking_ok) for _, o in outs] == [r["tracking_ok"] for r in jax_fail]
    assert [bool(o.tracking_ok) for _, o in outs] == [True, True, False, True]
    st, out = outs[2]
    assert not st["tsdf"].any() and not st["weight"].any() and not st["color"].any()
    assert int(st["frame_count"]) == 1
    np.testing.assert_array_equal(out.pose_matrix.numpy(), np.eye(4, dtype=np.float32))
    assert not any(m.any() for m in st["model_vmaps"] + st["model_nmaps"])
    # the next frame bootstraps again
    assert int(outs[3][0]["frame_count"]) == 2
    for (s, o), ref in zip(outs, jax_fail):
        np.testing.assert_allclose(o.pose_matrix.numpy(), ref["pose_matrix"], rtol=0,
                                   atol=POSE_TOL)
        assert int(s["frame_count"]) == int(ref["frame_count"])


def test_failed_frame_kept_without_auto_reset(runs):
    """auto_reset=False keeps volume, pose, model maps and frame count for a
    relocalizer."""
    frames = runs[0]
    outs = _track(_failing(frames)[:3], auto_reset=False)
    before, (after, out) = outs[1][0], outs[2]
    assert not bool(out.tracking_ok)
    for key in ("tsdf", "weight", "color", "pose", "frame_count"):
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)
    for a, b in zip(after["model_vmaps"] + after["model_nmaps"],
                    before["model_vmaps"] + before["model_nmaps"]):
        np.testing.assert_array_equal(a, b)


def test_kinfu_step_is_the_bound_step():
    """make_step_fn binds the configuration; the step updates the state's
    volume in place."""
    frames, _ = _frames()
    st0 = init_state(PARAMS, INTR, device="cpu")
    tsdf = st0.vol.tsdf
    st1, out = kinfu_step(st0, torch.as_tensor(frames[0][0]), torch.as_tensor(frames[0][1]),
                          PARAMS, INTR)
    assert st1.vol.tsdf is tsdf and bool(tsdf.any())
    assert bool(out.tracking_ok) and int(out.icp_inliers) == 0
