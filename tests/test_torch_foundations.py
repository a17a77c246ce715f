"""Port foundations against the JAX package: KinFuParams, Intrinsics
levels, se3 and the TSDF fixed point (tolerance 1e-6), plus the port's
fail-loud checks and its independence from jax.

Inputs are made with numpy from a seed and handed to both packages."""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinfu_tpu import config as jcfg
from kinfu_tpu.geometry import se3 as jse3
from kinfu_tpu.geometry.intrinsics import Intrinsics as JIntr
from kinfu_tpu.volume import tsdf as jtsdf
from kinfu_tpu_torch import config as tcfg
from kinfu_tpu_torch import numerics
from kinfu_tpu_torch.geometry import se3 as tse3
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics as TIntr
from kinfu_tpu_torch.ops import kernels
from kinfu_tpu_torch.volume import tsdf as ttsdf

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def test_params_defaults_match_jax():
    jp, tp = jcfg.KinFuParams(), tcfg.KinFuParams()
    for field in jcfg.KinFuParams.__dataclass_fields__:
        assert getattr(tp, field) == getattr(jp, field), field
    assert tp.voxel_size == jp.voxel_size
    np.testing.assert_array_equal(tp.volume_pose, jp.volume_pose)
    assert tp.level_iters_coarse_to_fine() == jp.level_iters_coarse_to_fine()
    assert tcfg.KinFuParams._MODE_CHOICES == jcfg.KinFuParams._MODE_CHOICES
    for dim, levels in ((64, 1), (128, 2)):
        assert tcfg.tiny_params(dim, levels) == tcfg.KinFuParams(
            **{f: getattr(jcfg.tiny_params(dim, levels), f)
               for f in jcfg.KinFuParams.__dataclass_fields__})


@pytest.mark.parametrize("field,value", [
    ("icp_mode", "fast"), ("integrate_mode", "hier"), ("raycast_mode", "gather"),
    ("fused_mode", "yes"),
])
def test_params_reject_unknown_modes(field, value):
    with pytest.raises(ValueError, match=field):
        tcfg.KinFuParams(**{field: value})


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_intrinsics_level_matches_jax(level):
    args = dict(width=640, height=480, fx=525.0, fy=523.0, cx=319.5, cy=239.5)
    jl, tl = JIntr(**args).level(level), TIntr(**args).level(level)
    for f in ("width", "height", "fx", "fy", "cx", "cy"):
        assert getattr(tl, f) == getattr(jl, f)
    np.testing.assert_allclose(tl.pixel_rays().numpy(), np.asarray(jl.pixel_rays()),
                               rtol=0, atol=TOL)


def _random_poses(rng, n):
    rv = rng.normal(size=(n, 3)).astype(np.float32) * 0.7
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return rv, t


def test_se3_ops_match_jax():
    rng = np.random.default_rng(7)
    rv, t = _random_poses(rng, 8)
    rv[0] = 0.0  # the series branch of rodrigues
    rv[1] = 1e-7
    jR = np.asarray(jse3.rodrigues(jnp.asarray(rv)))
    tR = tse3.rodrigues(_t(rv)).numpy()
    np.testing.assert_allclose(tR, jR, rtol=0, atol=TOL)

    ja, jb = jse3.Pose(jnp.asarray(jR[:4]), jnp.asarray(t[:4])), jse3.Pose(
        jnp.asarray(jR[4:]), jnp.asarray(t[4:]))
    ta, tb = tse3.Pose(_t(jR[:4]), _t(t[:4])), tse3.Pose(_t(jR[4:]), _t(t[4:]))
    for jout, tout in (
        (jse3.compose(ja, jb), tse3.compose(ta, tb)),
        (jse3.inverse(ja), tse3.inverse(ta)),
    ):
        np.testing.assert_allclose(tout.R.numpy(), np.asarray(jout.R), atol=TOL)
        np.testing.assert_allclose(tout.t.numpy(), np.asarray(jout.t), atol=TOL)
    np.testing.assert_allclose(tse3.pose_matrix(ta).numpy(),
                               np.asarray(jse3.pose_matrix(ja)), atol=0)
    T = np.asarray(jse3.pose_matrix(ja))
    tp = tse3.pose_from_matrix(_t(T))
    np.testing.assert_array_equal(tp.R.numpy(), T[..., :3, :3])
    np.testing.assert_array_equal(tp.t.numpy(), T[..., :3, 3])

    x = rng.normal(size=(6,)).astype(np.float32) * 0.05
    ji, ti = jse3.se3_increment(jnp.asarray(x)), tse3.se3_increment(_t(x))
    np.testing.assert_allclose(ti.R.numpy(), np.asarray(ji.R), atol=TOL)
    np.testing.assert_array_equal(ti.t.numpy(), np.asarray(ji.t))
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.transform_points(tse3.Pose(_t(jR[0]), _t(t[0])), _t(pts)).numpy(),
        np.asarray(jse3.transform_points(jse3.Pose(jnp.asarray(jR[0]), jnp.asarray(t[0])),
                                         jnp.asarray(pts))),
        atol=TOL)


def test_tsdf_fixed_point_and_packing_match_jax():
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.uniform(-1.2, 1.2, 1000), [-1.0, 1.0, 0.0, -1e-5, 1e-5]])
    vals = vals.astype(np.float32)
    fx_j = np.asarray(jtsdf.tsdf_to_fixed(jnp.asarray(vals)))
    fx_t = ttsdf.tsdf_to_fixed(_t(vals)).numpy()
    np.testing.assert_array_equal(fx_t, fx_j)
    assert fx_t.dtype == np.int16
    np.testing.assert_allclose(ttsdf.tsdf_to_float(_t(fx_j)).numpy(),
                               np.asarray(jtsdf.tsdf_to_float(jnp.asarray(fx_j))), atol=TOL)
    rgb = rng.integers(0, 256, (17, 3)).astype(np.uint8)
    np.testing.assert_array_equal(ttsdf.pack_rgb(_t(rgb)).numpy(),
                                  np.asarray(jtsdf.pack_rgb(jnp.asarray(rgb))))

    jv = jtsdf.create_volume((8, 16, 24))
    tv = ttsdf.create_volume((8, 16, 24), device="cpu")
    for ja, ta in zip(jv, tv):
        assert tuple(ta.shape) == ja.shape
        assert str(ta.dtype).removeprefix("torch.") == str(ja.dtype)
    tv.tsdf.fill_(5)
    ttsdf.reset_volume(tv)
    assert not any(bool(a.any()) for a in tv)


@pytest.mark.parametrize("c", [140.0, 525.0, 104.0, 261.0, 6.0, 49.21875])
def test_recip_is_xla_division_by_a_constant(c):
    """XLA divides by a static value as a multiply by its float32
    reciprocal; numerics.recip reproduces that rounding."""
    x = np.random.default_rng(1).uniform(-1e3, 1e3, 20_000).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a / c)(jnp.asarray(x)))
    np.testing.assert_array_equal((_t(x) * numerics.recip(c)).numpy(), want)


def test_sqrt32_is_correctly_rounded():
    x = np.random.default_rng(2).uniform(0.0, 1e4, 200_000).astype(np.float32)
    np.testing.assert_array_equal(numerics.sqrt32(_t(x)).numpy(), np.sqrt(x))


def test_numpy_copies_match_jax():
    """data/synthetic, eval/ate and the io/poses reader are numpy copies:
    same frames, same metrics, same parsed golden poses."""
    from kinfu_tpu.data import synthetic as jsyn
    from kinfu_tpu.eval import ate as jate
    from kinfu_tpu.io import poses as jposes
    from kinfu_tpu_torch.data import synthetic as tsyn
    from kinfu_tpu_torch.eval import ate as tate
    from kinfu_tpu_torch.io import poses as tposes

    args = dict(width=80, height=64, fx=70.0, fy=72.0, cx=39.2, cy=31.7)
    traj = tsyn.make_orbit_trajectory(3, angle_step_deg=2.0)
    for jT, tT in zip(jsyn.make_orbit_trajectory(3, angle_step_deg=2.0), traj):
        np.testing.assert_array_equal(tT, jT)
    for scene in ("default_test_scene", "corner_test_scene"):
        jd, jc = getattr(jsyn, scene)().render_frame(traj[1], JIntr(**args))
        td, tc = getattr(tsyn, scene)().render_frame(traj[1], TIntr(**args))
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tc, jc)
    golden = REPO / "doc" / "golden_poses_r05_synthetic_640x480_512.txt"
    est = tposes.read_poses_reference_format(str(golden))
    assert len(est) == 50
    for a, b in zip(est, jposes.read_poses_reference_format(str(golden))):
        np.testing.assert_array_equal(a, b)
    orbit = tsyn.make_orbit_trajectory(50, angle_step_deg=0.3)
    gt = [np.linalg.inv(orbit[0]) @ T for T in orbit]
    for align in (True, False):
        assert tate.ate_rmse(est, gt, align=align) == jate.ate_rmse(est, gt, align=align)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else t.dtype)


def test_step_constants_keep_their_bits():
    """The step builds its constant blocks once per device and configuration
    (no host copy, so no host sync, in the step); each block has the bits
    the step built from Python values on every call before."""
    from kinfu_tpu_torch.ops import face_integrate as fi
    from kinfu_tpu_torch.ops import face_raycast as fr
    from kinfu_tpu_torch.ops import facewarp as fw
    from kinfu_tpu_torch.pipeline.kinfu import _volume_pose

    f32 = torch.float32
    rng = np.random.default_rng(5)
    params = tcfg.tiny_params(128)
    intr = TIntr(160, 120, 140.0, 140.0, 79.5, 59.5)
    fspec, rspec = fw.default_face_spec(), fr.RaySpec(256, 104.0)
    A = torch.as_tensor(rng.standard_normal((3, 3)).astype(np.float32))
    gate = torch.tensor(True)
    old = torch.cat([A.reshape(-1), torch.tensor([intr.fx, intr.fy, intr.cx, intr.cy], dtype=f32),
                     gate.reshape(1).float(), torch.tensor([fspec.focal, fspec.centre], dtype=f32)])
    assert torch.equal(_bits(fw.face_params(A, intr, gate, fspec)), _bits(old))

    cam = tse3.Pose(tse3.rodrigues(torch.tensor([0.3, -0.2, 0.1])), torch.tensor([1.1, 1.4, 0.3]))
    blk = fr.composite_params(cam, params)
    for f, frame in enumerate(fw.face_frames()):
        D, off, vs_p = fr.prime_geometry(frame, params, "cpu")
        old_off = torch.as_tensor(fw.primed_offset(frame, params.volume_dims, params.voxel_size))
        assert torch.equal(_bits(D), _bits(torch.as_tensor(frame.D, dtype=f32)))
        assert torch.equal(_bits(off), _bits(old_off))
        assert torch.equal(_bits(blk[f, :9]), _bits((D @ cam.R).reshape(9)))
        org_p = D @ cam.t + off
        assert torch.allclose(blk[f, 9:12], org_p, rtol=0, atol=0)
        vs = torch.tensor(vs_p, dtype=f32)
        fo = torch.tensor(rspec.focal, dtype=f32)
        t_cover = torch.tensor(23.0 / 7.0, dtype=f32) * fo * vs[1] * 0.99
        tail = torch.tensor([rspec.centre, 1.0 + 2.0 / rspec.focal], dtype=f32)
        old = torch.cat([org_p, vs, fo.reshape(1), tail[:1], t_cover.reshape(1), tail[1:],
                         gate.reshape(1).float(), torch.zeros(5)])
        assert torch.equal(_bits(fr.ray_params(org_p, vs_p, rspec, gate)), _bits(old))
        face_prm = fw.face_params(A, intr, gate, fspec)
        r_max = torch.tensor(2345.0)
        old = torch.cat([org_p, torch.tensor([*vs_p, fspec.focal, fspec.centre,
                                              params.trunc_dist * 1000.0,
                                              float(params.tsdf_max_weight)], dtype=f32),
                         r_max.reshape(1), gate.reshape(1).float(),
                         torch.tensor([160.0, 120.0, 0.0, 0.0]), face_prm])
        new = fi.sweep_params(org_p, vs_p, fspec, params, r_max, gate, face_prm, intr)
        assert torch.equal(_bits(new), _bits(old))

    slope = torch.as_tensor(rng.uniform(0.1, 200.0, 64).astype(np.float32))
    inv_scale, row_off, width, cover_ok = fi._mip_scalars(fspec, slope)
    lvl = sum((slope > 2.0 * (1 << (l - 1))).long() for l in range(1, fspec.levels))
    assert torch.equal(_bits(inv_scale), _bits(torch.tensor(
        [1.0 / (1 << l) for l in range(fspec.levels)], dtype=f32)[lvl]))
    assert torch.equal(row_off, torch.tensor(fspec.row_offsets)[lvl])
    assert torch.equal(width, torch.tensor([fspec.size >> l for l in range(fspec.levels)])[lvl])
    vol_pose = _volume_pose(params, torch.device("cpu"))
    assert torch.equal(_bits(tse3.pose_matrix(vol_pose)), _bits(torch.as_tensor(params.volume_pose)))
    assert _volume_pose(params, torch.device("cpu")) is vol_pose


# ---- fail-loud checks ----------------------------------------------------


def test_icp_mode_warped_raises(monkeypatch, tmp_path):
    """Warped ICP is ported: the mode no longer raises by itself. On a
    tensor that is not on the CPU it launches K1 or raises: with no kernel
    library (no nvcc to build it), it raises."""
    from kinfu_tpu_torch.tracking.icp import resolve_icp_mode, rigid_icp

    assert resolve_icp_mode(tcfg.KinFuParams(icp_mode="warped"), "cpu") == "warped"
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    m = [torch.empty((12, 16, 3), device="meta")]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rigid_icp(m, m, m, m, TIntr(16, 12, 10.0, 10.0, 7.5, 5.5),
                  tcfg.KinFuParams(pyramid_height=1, icp_iters=(1,), icp_mode="warped"))


def test_cuda_device_without_cuda_raises(monkeypatch):
    from kinfu_tpu_torch.pipeline.kinfu import init_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(tcfg.tiny_params(16), TIntr(16, 12, 10.0, 10.0, 7.5, 5.5), device="cuda")


def test_non_fused_step_raises():
    """The non-fused step runs where it raised before the slice that ported
    it: fused_mode="off", "auto" off CUDA and a "hier" raycast each
    bootstrap; so does the fused step with warped ICP (K1's plain version
    on the CPU; 128^3 is the least cube `warp_dims_ok` admits, a 128 px
    raycast face the least face)."""
    from kinfu_tpu_torch.pipeline.kinfu import init_state, kinfu_step

    intr = TIntr(16, 12, 10.0, 10.0, 7.5, 5.5)
    depth = torch.zeros((12, 16))
    color = torch.zeros((12, 16, 3), dtype=torch.uint8)
    for params in (tcfg.tiny_params(16).replace(fused_mode="off"),
                   tcfg.tiny_params(16),  # "auto" off CUDA
                   tcfg.tiny_params(128).replace(fused_mode="on", raycast_mode="hier"),
                   tcfg.tiny_params(128).replace(fused_mode="on", icp_mode="warped",
                                                 raycast_face=(128, 52.2))):
        state, out = kinfu_step(init_state(params, intr, device="cpu"), depth, color,
                                params, intr)
        assert bool(out.tracking_ok) and int(out.icp_inliers) == 0
        assert int(state.frame_count) == 2


def test_non_cpu_tensor_without_kernel_library_raises(monkeypatch, tmp_path):
    """A tensor that is not on the CPU never takes the plain version: with
    no kernel library (no nvcc to build it), the wrapper raises."""
    from kinfu_tpu_torch.ops import face_raycast, facewarp

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.library()
    meta = dict(device="meta")
    spec = facewarp.FaceSpec(128, 52.0, 2)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        facewarp.build_faces(torch.empty((12, 16), **meta),
                             torch.empty((12, 16), dtype=torch.int32, **meta),
                             torch.empty((6, 16), **meta), spec)
    rspec = face_raycast.RaySpec(128, 52.0)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        face_raycast.resample_composite([torch.empty((128, 128), **meta)] * 6,
                                        [torch.empty((128, 128, 3), **meta)] * 6,
                                        torch.empty((6, face_raycast.COMPOSITE_COLS), **meta),
                                        torch.empty(6, dtype=torch.bool, **meta),
                                        TIntr(16, 12, 10.0, 10.0, 7.5, 5.5), rspec)


def test_port_imports_no_jax():
    code = textwrap.dedent(
        """
        import sys
        import kinfu_tpu_torch
        import kinfu_tpu_torch.pipeline.kinfu, kinfu_tpu_torch.ops.kernels
        import kinfu_tpu_torch.data.synthetic, kinfu_tpu_torch.eval.ate
        import kinfu_tpu_torch.io.poses, kinfu_tpu_torch.io.ply, kinfu_tpu_torch.io.checkpoint
        import kinfu_tpu_torch.pipeline.session, kinfu_tpu_torch.pipeline.viz3d
        import kinfu_tpu_torch.ops.icp_warped, kinfu_tpu_torch.volume.extract
        import kinfu_tpu_torch.cli, kinfu_tpu_torch.io.images, kinfu_tpu_torch.data
        import kinfu_tpu_torch.data.icl_nuim, kinfu_tpu_torch.data.sensor
        import kinfu_tpu_torch.utils.metrics, kinfu_tpu_torch.utils.profiling
        import kinfu_tpu_torch.pipeline.streaming, kinfu_tpu_torch.volume.stream
        import kinfu_tpu_torch.tools.sanitize, kinfu_tpu_torch.tools.trace_step
        import kinfu_tpu_torch.tools.accuracy_run, kinfu_tpu_torch.tools.raycast_parity_probe
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "kinfu_tpu" or m.startswith("kinfu_tpu."))
        assert not bad, bad
        import torch
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        """
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line off the GPU."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={"CUDA_VISIBLE_DEVICES": "",
                                                      "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
