"""The port's non-fused volume path against the JAX package: the gather
integrate and its dispatcher (kinfu_tpu_torch/volume/integrate.py), the
raycast family and its dispatcher (volume/raycast.py), and the warped
raycast entry with its cam2vol face flags (ops/face_raycast.py::
raycast_warped, faces_needed_cam2vol).

The JAX references run in a child process without FMA contraction
(tests/torch_jaxref.py), on the same numpy inputs made from a seed or the
synthetic scene; the gather integrate's with at most SSE4.2, where XLA's
rsqrt is 1 / sqrt as the port computes it. Tolerances:
  - the gather integrate, the occupancy grid, the rays, the AABB and the
    three marches' events: bit for bit;
  - shade and trilinear: 1e-6 (normals) and 1e-7 m (vertices);
  - the raycast dispatcher in "hier" and "step" mode: the valid masks
    equal, vertices within 1e-6 m and normals within 1e-5;
  - the cam2vol face flags: equal on every pose;
  - `raycast_warped` against JAX's, a 256 px face grid, kernels' plain
    versions against interpret-mode Pallas: the valid masks equal on all
    but 0.1% of pixels, maps within 1e-4 where both are valid (the fused
    step's tolerance, tests/test_torch_step.py).
"""

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu_torch.config import KinFuParams, tiny_params
from kinfu_tpu_torch.data.synthetic import (
    corner_test_scene,
    default_test_scene,
    make_orbit_trajectory,
    yaw_trajectory,
)
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import (
    Pose,
    compose,
    identity_pose,
    inverse,
    pose_from_matrix,
)
from kinfu_tpu_torch.ops.face_integrate import faces_needed, integrate_warped
from kinfu_tpu_torch.ops.face_raycast import faces_needed_cam2vol, raycast_warped
from kinfu_tpu_torch.ops.facewarp import face_frames
from kinfu_tpu_torch.pipeline.kinfu import fused_supported, update_volume
from kinfu_tpu_torch.volume import raycast as rc
from kinfu_tpu_torch.volume.integrate import (
    integrate,
    resolve_integrate_mode,
)
from kinfu_tpu_torch.volume.tsdf import (
    TSDFVolume,
    create_volume,
    pack_rgb,
    tsdf_to_float,
    unpack_rgb,
)

torch.set_num_threads(2)

INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
INTR = Intrinsics(*INTR_T)
#: tests/test_volume.py's configuration: 64^3 over 2 m
CFG = dict(pyramid_height=1, icp_iters=(4,), volume_dims=(64, 64, 64),
           volume_range=(2.0, 2.0, 2.0), volume_origin=(-1.0, -1.0, 0.5),
           max_extracted_points=200_000)
PARAMS = KinFuParams(**CFG)
#: the warped raycast at the least cube `warp_dims_ok` admits, a 256 px face
WCFG = dict(pyramid_height=1, icp_iters=(3,), volume_dims=(128, 128, 128),
            volume_range=(3.0, 3.0, 3.0), raycast_face=(256, 104.0))
WPARAMS = KinFuParams(**WCFG)
CPU = torch.device("cpu")


def _pose(T) -> Pose:
    return pose_from_matrix(torch.as_tensor(np.asarray(T, np.float32)))


def _vol_pose(params) -> Pose:
    return _pose(params.volume_pose)


def _vol2cam(T, params) -> Pose:
    return compose(inverse(_pose(T)), _vol_pose(params))


def _cam2vol(T, params) -> Pose:
    return compose(inverse(_vol_pose(params)), _pose(T))


def _np_pose(p: Pose):
    return p.R.numpy(), p.t.numpy()


def _fuse_port(vol, frames, params, intr=INTR):
    """Fuse (pose, depth mm, colour) frames with the port's dispatcher."""
    for T, d, c in frames:
        integrate(vol, torch.as_tensor(d * np.float32(params.depth_scale)),
                  torch.as_tensor(c), _vol2cam(T, params), intr, params)
    return vol


def _scene_frames(poses, intr=INTR):
    scene = default_test_scene()
    return [(T, *scene.render_frame(T, intr)) for T in poses]


# ---- the gather integrate ----------------------------------------------------


def test_unpack_rgb_inverts_pack_rgb():
    rgb = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8))
    np.testing.assert_array_equal(unpack_rgb(pack_rgb(rgb)).numpy(), rgb.numpy())


def test_gather_integrate_matches_jax_bit_for_bit():
    """Three orbit frames into a fresh 64^3 volume, then a seeded random
    volume (random TSDF, weights up to the cap and colours) fused once:
    every voxel of the three arrays equal after each call; the dispatcher
    picks the gather path on the CPU and on an untileable volume."""
    rng = np.random.default_rng(7)
    poses = make_orbit_trajectory(3, angle_step_deg=4.0)
    frames = _scene_frames(poses)
    scale = np.float32(PARAMS.depth_scale)
    shape = (64, 64, 64)
    rand = dict(tsdf=rng.integers(-32767, 32768, shape).astype(np.int16),
                weight=rng.integers(0, PARAMS.tsdf_max_weight + 1, shape).astype(np.int16),
                color=rng.integers(0, 1 << 24, shape).astype(np.int32))
    calls = [(k > 0, d * scale, c, *_np_pose(_vol2cam(T, PARAMS)))
             for k, (T, d, c) in enumerate(frames)]
    calls.append(("rand", frames[1][1] * scale, frames[1][2],
                  *_np_pose(_vol2cam(poses[1], PARAMS))))
    # the port runs the chain first; JAX gets each call's starting volume
    vol = create_volume((64, 64, 64), device="cpu")
    got, starts = [], []
    for src, d, c, R, t in calls:
        if src == "rand":
            for a, key in zip(vol, ("tsdf", "weight", "color")):
                a.copy_(torch.as_tensor(rand[key]))
        starts.append(tuple(a.numpy().copy() for a in vol))
        integrate(vol, torch.as_tensor(d), torch.as_tensor(c),
                  Pose(torch.as_tensor(R), torch.as_tensor(t)), INTR, PARAMS)
        got.append(tuple(a.numpy().copy() for a in vol))
    want = torch_jaxref.run([
        ("integrate", dict(tsdf=s[0], weight=s[1], color=s[2], depth_m=d, color_rgb=c, R=R, t=t,
                           intr=INTR_T, params_kw=tuple(CFG.items())))
        for s, (_, d, c, R, t) in zip(starts, calls)], isa="SSE4_2")
    for k, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("tsdf", "weight", "color"), g, w):
            np.testing.assert_array_equal(a, b, err_msg=f"call {k}: {name}")
    assert (got[-1][1] > 0).sum() > 10_000 and (got[0][2] != 0).any()
    assert resolve_integrate_mode(PARAMS, shape, CPU) == "gather"
    assert resolve_integrate_mode(PARAMS, shape, torch.device("cuda")) == "gather"
    assert resolve_integrate_mode(WPARAMS, (128,) * 3, torch.device("cuda")) == "warped"
    assert resolve_integrate_mode(WPARAMS, (128,) * 3, CPU) == "gather"


def test_gather_integrate_gate_leaves_the_volume():
    """gate=False changes no voxel; gate=True is the ungated call. A Z slab
    integrated with its global `z_offset` is that slab of the whole
    volume, bit for bit (the gather path folds the offset into its chunk
    positions, as the whole volume's chunks compute them)."""
    T, d, c = _scene_frames([np.eye(4, dtype=np.float32)])[0]
    depth = torch.as_tensor(d * np.float32(PARAMS.depth_scale))
    a = create_volume(PARAMS.volume_dims, device="cpu")
    b = create_volume(PARAMS.volume_dims, device="cpu")
    integrate(a, depth, torch.as_tensor(c), _vol2cam(T, PARAMS), INTR, PARAMS,
              gate=torch.tensor(False))
    assert not any(bool(x.any()) for x in a)
    integrate(a, depth, torch.as_tensor(c), _vol2cam(T, PARAMS), INTR, PARAMS,
              gate=torch.tensor(True))
    integrate(b, depth, torch.as_tensor(c), _vol2cam(T, PARAMS), INTR, PARAMS)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    slab = create_volume((64, 64, 48), device="cpu")
    integrate(slab, depth, torch.as_tensor(c), _vol2cam(T, PARAMS), INTR, PARAMS, z_offset=16)
    for x, y in zip(slab, b):
        assert torch.equal(x, y[16:])
    assert int((slab.weight > 0).sum()) > 1000


def _plane(z, value=0):
    depth = torch.full((INTR.height, INTR.width), float(z))
    color = torch.full((INTR.height, INTR.width, 3), value, dtype=torch.uint8)
    return depth, color


def test_integrate_plane_tsdf_values():
    """tests/test_volume.py's fronto-parallel plane at 1.5 m: positive in
    front, negative behind, untouched far behind, saturated well in front."""
    vol = create_volume(PARAMS.volume_dims, device="cpu")
    depth, color = _plane(1.5)
    integrate(vol, depth, color, _vol2cam(np.eye(4), PARAMS), INTR, PARAMS)
    F = tsdf_to_float(vol.tsdf).numpy()
    W = vol.weight.numpy()
    k = int((1.5 - 0.5) / PARAMS.voxel_size[2])
    col, w = F[:, 32, 32], W[:, 32, 32]
    assert w[k - 1] > 0 and w[k + 1] > 0
    assert col[k - 1] > 0 and col[k + 1] < 0
    assert w[k + 6] == 0
    np.testing.assert_allclose(col[5:20], 1.0, atol=2e-4)


def test_integrate_weight_accumulates_and_clamps():
    params = PARAMS.replace(tsdf_max_weight=3)
    vol = create_volume(params.volume_dims, device="cpu")
    depth, color = _plane(1.5)
    for _ in range(5):
        integrate(vol, depth, color, _vol2cam(np.eye(4), params), INTR, params)
    assert int(vol.weight.max()) == 3


def test_integrate_color_written_near_surface():
    vol = create_volume(PARAMS.volume_dims, device="cpu")
    depth, color = _plane(1.5, 200)
    integrate(vol, depth, color, _vol2cam(np.eye(4), PARAMS), INTR, PARAMS)
    rgb = unpack_rgb(vol.color).numpy()
    assert rgb[32, 32, 32].max() > 50
    assert rgb[5, 32, 32].max() == 0


# ---- the raycast family --------------------------------------------------------


@pytest.fixture(scope="module")
def fused64():
    """A 64^3 volume fused from two poses (free space, the surface band and
    unobserved regions: all three occupancy classes)."""
    poses = [np.eye(4, dtype=np.float32), np.asarray(make_orbit_trajectory(8)[1])]
    vol = _fuse_port(create_volume(PARAMS.volume_dims, device="cpu"), _scene_frames(poses),
                     PARAMS)
    return vol, poses


def _cam_rays(T):
    return rc.camera_rays(_cam2vol(T, PARAMS), INTR)


def test_raycast_parts_match_jax(fused64):
    """camera_rays, ray_aabb, build_occupancy, the three marches (events
    bit for bit), shade and trilinear on the same volume and pose."""
    vol, poses = fused64
    T = poses[1]
    R, t = _np_pose(_cam2vol(T, PARAMS))
    vs = PARAMS.voxel_size
    step = PARAMS.raycast_step_voxels * vs[0]
    max_steps = rc.march_steps_bound(vol.tsdf.shape, vs, step)
    job = torch_jaxref.start([("raycast_parts", dict(
        tsdf=vol.tsdf.numpy(), R=R, t=t, intr=INTR_T, params_kw=tuple(CFG.items()),
        max_steps=max_steps, chunk=7))])

    inv_vs = torch.tensor(np.array([1.0 / v for v in vs], np.float32))
    org, dirs = _cam_rays(T)
    box_max = torch.tensor(np.asarray(PARAMS.volume_range, np.float32))
    tnear, tfar = rc.ray_aabb(org, dirs, box_max)
    t_start = torch.clamp(tnear, min=0.0) + step
    occ = rc.build_occupancy(vol.tsdf)
    dims = tuple(vol.tsdf.shape)
    m = rc.march(vol.tsdf, dims, 0, org, dirs, t_start, tfar, step, inv_vs)
    h = rc.march_hier(vol.tsdf, occ, org, dirs, t_start, tfar, step, inv_vs)
    c = rc.march_chunked(vol.tsdf, dims, 0, org, dirs, t_start, tfar, step, inv_vs,
                         max_steps, chunk=7)
    hit = (m.hit_t < m.back_t) & (m.hit_t < rc._INF)
    vertex, n, valid = rc.shade(vol.tsdf, dims, 0, org, dirs, m.hit_t, hit, vs)
    tri, tri_ok = rc.trilinear(vol.tsdf.reshape(-1), dims, 0, dims[0], vertex * inv_vs)
    ref = job.result()[0]

    for name, a in (("org", org), ("dirs", dirs), ("tnear", tnear), ("tfar", tfar),
                    ("t_start", t_start), ("occ", occ)):
        np.testing.assert_array_equal(a.numpy(), ref[name], err_msg=name)
    for name, res in (("march", m), ("hier", h), ("chunked", c)):
        for k, a in enumerate(res):
            np.testing.assert_array_equal(a.numpy(), ref[name][k], err_msg=f"{name}[{k}]")
    assert int(hit.sum()) > 5000
    np.testing.assert_array_equal(valid.numpy(), ref["valid"])
    np.testing.assert_allclose(vertex.numpy(), ref["vertex"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(n.numpy(), ref["normal"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tri_ok.numpy(), ref["tri"][1])
    np.testing.assert_allclose(tri.numpy(), ref["tri"][0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["hier", "step"])
def test_raycast_dispatcher_matches_jax(fused64, mode):
    vol, poses = fused64
    params_kw = tuple({**CFG, "raycast_mode": mode}.items())
    params = KinFuParams(**dict(params_kw))
    assert rc.resolve_raycast_mode(params, vol.tsdf.shape, CPU) == mode
    R, t = _np_pose(_cam2vol(poses[1], params))
    job = torch_jaxref.start([("raycast", dict(tsdf=vol.tsdf.numpy(), R=R, t=t, intr=INTR_T,
                                               params_kw=params_kw))])
    vm, nm = rc.raycast(vol, _cam2vol(poses[1], params), INTR, params)
    off_vm, off_nm = rc.raycast(vol, _cam2vol(poses[1], params), INTR, params,
                                gate=torch.tensor(False))
    want_vm, want_nm = job.result()[0]
    got_valid = (nm != 0).any(-1).numpy()
    np.testing.assert_array_equal(got_valid, (want_nm != 0).any(-1))
    assert got_valid.mean() > 0.5
    np.testing.assert_allclose(vm.numpy(), want_vm, rtol=0, atol=1e-6)
    np.testing.assert_allclose(nm.numpy(), want_nm, rtol=0, atol=1e-5)
    assert not off_vm.any() and not off_nm.any()


def test_raycast_modes_resolve_as_jax():
    cuda = torch.device("cuda")
    assert rc.resolve_raycast_mode(WPARAMS, (128,) * 3, cuda) == "warped"
    assert rc.resolve_raycast_mode(WPARAMS, (128,) * 3, CPU) == "hier"
    assert rc.resolve_raycast_mode(WPARAMS, (12, 128, 128), cuda) == "step"
    assert rc.resolve_raycast_mode(WPARAMS.replace(raycast_mode="warped"), (16, 128, 192),
                                   cuda) == "hier"
    assert rc.resolve_raycast_mode(WPARAMS.replace(raycast_mode="warped"), (128,) * 3,
                                   CPU) == "warped"


@pytest.mark.parametrize("dims_zyx", [(16, 128, 192), (12, 128, 128)])
def test_untileable_volume_falls_back_and_runs(dims_zyx):
    """tests/test_dispatch.py on the port: integrate and raycast with mode
    "warped" on an untileable volume take the gather and hier/step paths."""
    Z, Y, X = dims_zyx
    params = KinFuParams(volume_dims=(X, Y, Z), volume_range=(1.5, 1.5, 1.5),
                         integrate_mode="warped", raycast_mode="warped", pyramid_height=1,
                         icp_iters=(2,))
    intr = Intrinsics(width=32, height=24, fx=28.0, fy=28.0, cx=15.5, cy=11.5)
    vol = create_volume(params.volume_dims, device="cpu")
    depth = torch.full((24, 32), 1.0)
    color = torch.zeros((24, 32, 3), dtype=torch.uint8)
    pose = identity_pose()
    integrate(vol, depth, color, pose, intr, params)
    assert vol.tsdf.shape == (Z, Y, X) and int(vol.weight.sum()) > 0
    vmap, nmap = rc.raycast(vol, pose, intr, params)
    assert vmap.shape == (24, 32, 3)


# ---- the warped raycast entry and its face flags --------------------------------


def _flag_poses():
    """cam2vol rotations of the orbit, the corner orbit and the six centre
    views of the 128^3 volume (chip_smoke.py's `inside_view`)."""
    orbit = make_orbit_trajectory(50, angle_step_deg=0.3)
    corner = yaw_trajectory(make_orbit_trajectory(50, angle_step_deg=0.3))
    rots = []
    for traj in (orbit, corner):
        rel = [np.linalg.inv(traj[0]) @ T for T in traj]
        rots += [_cam2vol(T, WPARAMS).R.numpy() for T in rel]
    for fr in face_frames():
        # look along the face's sweep axis: camera z = the axis row of D
        z = np.asarray(fr.D[2], np.float32)
        x = np.asarray(fr.D[0], np.float32)
        rots.append(np.stack([x, np.cross(z, x), z], axis=1).astype(np.float32))
    return rots


def test_faces_needed_cam2vol_matches_jax():
    """The cam2vol flags bit for bit against JAX's `_faces_needed` over the
    orbit's, the corner orbit's and the six centre views' poses; beside
    them, the poses where the fusion's vol2cam flags differ (expected
    none: the two agree in exact arithmetic)."""
    rots = _flag_poses()
    want = torch_jaxref.run([("faces_needed_cam2vol", dict(rotations=rots, intr=INTR_T))])[0]
    got = np.stack([faces_needed_cam2vol(Pose(torch.as_tensor(R), torch.zeros(3)), INTR).numpy()
                    for R in rots])
    np.testing.assert_array_equal(got, want)
    vol2cam = np.stack([faces_needed(Pose(torch.as_tensor(R).T.contiguous(), torch.zeros(3)),
                                     INTR).numpy() for R in rots])
    differ = np.nonzero((vol2cam != got).any(axis=1))[0].tolist()
    assert differ == [], f"cam2vol and vol2cam face sets differ on poses {differ}"
    assert got.any(axis=0).all()  # every face is live on some pose


@pytest.fixture(scope="module")
def fused128():
    """The 128^3 volume of the warped tests: two orbit frames fused by the
    gather path, and the view of the second."""
    poses = make_orbit_trajectory(2, angle_step_deg=3.0)
    vol = _fuse_port(create_volume(WPARAMS.volume_dims, device="cpu"), _scene_frames(poses),
                     WPARAMS)
    return vol, poses


def test_raycast_warped_matches_jax(fused128):
    """`raycast_warped` (plain versions) against JAX's (interpret-mode
    Pallas) with the sweep set pinned to +z and +x, where the cam2vol
    flags gate +z alone: no pixel is owned by +x there, so the port's
    pinned call and its call with the flags must both give JAX's maps.
    gate=False gives zero maps."""
    vol, poses = fused128
    c2v = _cam2vol(poses[1], WPARAMS)
    R, t = _np_pose(c2v)
    job = torch_jaxref.start([("raycast_warped", dict(
        tsdf=vol.tsdf.numpy(), R=R, t=t, intr=INTR_T, params_kw=tuple(WCFG.items()),
        faces=("+z", "+x")))])
    assert faces_needed_cam2vol(c2v, INTR).tolist() == [n == "+z" for n in
                                                         (f.name for f in face_frames())]
    pinned = raycast_warped(vol, c2v, INTR, WPARAMS, faces=("+z", "+x"))
    flagged = raycast_warped(vol, c2v, INTR, WPARAMS)
    off = raycast_warped(vol, c2v, INTR, WPARAMS, gate=torch.tensor(False))
    wvm, wnm = job.result()[0]
    vm, nm = pinned
    gv, wv = (nm != 0).any(-1).numpy(), (wnm != 0).any(-1)
    assert (gv != wv).mean() <= 1e-3 and gv.mean() > 0.5
    both = gv & wv
    np.testing.assert_allclose(vm.numpy()[both], wvm[both], rtol=0, atol=1e-4)
    np.testing.assert_allclose(nm.numpy()[both], wnm[both], rtol=0, atol=1e-4)
    for a, b in zip(pinned, flagged):
        assert torch.equal(a, b)
    assert not off[0].any() and not off[1].any()


def test_fused_update_matches_separate_kernels(fused128):
    """tests/test_dispatch.py::test_fused_update_matches_separate_kernels on
    the port: `update_volume` under the fused rule equals `integrate_warped`
    followed by `raycast_warped`, its failure branch resets the volume, and
    with reset_on_fail=False keeps it."""
    _, poses = fused128
    T, d, c = _scene_frames([np.eye(4, dtype=np.float32)])[0]
    depth = torch.as_tensor(d * np.float32(WPARAMS.depth_scale))
    color = torch.as_tensor(c)
    v2c, c2v = _vol2cam(T, WPARAMS), _cam2vol(T, WPARAMS)
    fused = WPARAMS.replace(fused_mode="on")
    assert fused_supported(WPARAMS.volume_dims, fused, CPU)

    def update(vol, good, **kw):
        return update_volume(vol, depth, v2c, c2v, torch.tensor(good), color_rgb=color,
                             intr=INTR, params=fused, **kw)

    ref = create_volume(WPARAMS.volume_dims, device="cpu")
    integrate_warped(ref, depth, color, v2c, INTR, WPARAMS)
    ref_vm, ref_nm = raycast_warped(ref, c2v, INTR, WPARAMS)

    f_vol, f_vm, f_nm = update(create_volume(WPARAMS.volume_dims, device="cpu"), True)
    for a, b in zip(f_vol, ref):
        assert torch.equal(a, b)
    np.testing.assert_allclose(f_vm.numpy(), ref_vm.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(f_nm.numpy(), ref_nm.numpy(), rtol=0, atol=1e-5)
    assert (f_nm != 0).any(-1).float().mean() > 0.5

    kept = [a.clone() for a in ref]
    k_vol, k_vm, _ = update(ref, False, reset_on_fail=False)
    assert all(torch.equal(a, b) for a, b in zip(k_vol, kept)) and not k_vm.any()
    r_vol, r_vm, r_nm = update(ref, False)
    assert not any(bool(a.any()) for a in r_vol) and not r_vm.any() and not r_nm.any()


def test_non_fused_update_raycasts_from_the_repaired_pose(fused128):
    """Off the fused rule, `update_volume` repairs a non-finite cam2vol
    before its raycast, as the JAX step does: the maps are the raycast's
    from the identity, which here sees part of the surface, where a
    raycast from the pose as given sees none. (Under the fused rule the sweeps take the
    pose as given and only the camera-frame maps take the repair.)"""
    vol, poses = fused128
    vol = TSDFVolume(*(a.clone() for a in vol))
    params = WPARAMS.replace(fused_mode="off", raycast_mode="warped")
    T = poses[1]
    bad = _cam2vol(T, WPARAMS)
    bad = Pose(bad.R, bad.t * torch.tensor([float("nan"), 1.0, 1.0]))
    good = torch.tensor(True)
    want = rc.raycast(vol, identity_pose(), INTR, params, gate=good)
    as_given = rc.raycast(vol, bad, INTR, params, gate=good)
    assert (want[1] != 0).any()
    assert not as_given[0].any() and not as_given[1].any()
    depth = torch.zeros((INTR.height, INTR.width))
    color = torch.zeros((INTR.height, INTR.width, 3), dtype=torch.uint8)
    _, vm, nm = update_volume(vol, depth, _vol2cam(T, WPARAMS), bad, good, color_rgb=color,
                              intr=INTR, params=params)
    assert torch.equal(vm, want[0]) and torch.equal(nm, want[1])
