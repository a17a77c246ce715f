#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kinfu_tpu_torch) on one NVIDIA GPU.

Phases; any failure exits non-zero before the result line:
  1. report the card (torch and nvidia-smi);
  2. build the CUDA kernels of kinfu_tpu_torch/csrc from this checkout;
  3. hold every kernel on the step's path against its plain PyTorch version
     at the main path's shapes, and time both with CUDA events: K1
     icp_normal_eqs on frame 3's measurement pyramid against the model maps
     of the state fused from frames 0-2 (all three levels, the identity
     increment and a small one; count exact, A and b within 1e-4 of their
     largest entry, the same bits on a second launch); K2 build_face, K3
     face_integrate, K4 sweep_rays and K5 resample_face on that 512^3 volume
     and frame 3 (all six cube faces seen from the orbit pose, and each face
     seen from the volume's centre looking along it); K3's and K4's time
     for a gated-off call, K3's footprint voxels beside the voxels of its
     admitted planes, and K4's count of rays whose hit or back bits differ
     from the plain version's (no profiler before phase 4: once started in
     a process it slows every later launch);
  4. run the 50-frame orbit of bench.py (640x480, fx=fy=525, 512^3 over 3 m,
     3-level pyramid, ICP (4,5,10), icp_mode="auto", which is the warped ICP
     kernel K1 on the card) through init_state + kinfu_step with the launch
     counts set to 0 just before; every frame after the first must track,
     the aligned ATE against exact ground truth must be <= 1 mm, K1 must
     launch 19 times a frame and every other kernel at least once; then 10
     frames with icp_mode="gather", which must track without launching K1;
  5. the same 50 frames through KinFuSession with its default device, numpy
     frames in, the counts set to 0 just before: every frame tracks, the
     aligned ATE is <= 1 mm, the pose record agrees with phase 4's; the
     Phong render, the point cloud, the PLY and pose files, and a
     checkpoint that is loaded and tracks one more frame;
  6. profile 8 steps of a fresh run: kernel time per frame, each port
     kernel's device time per frame and a launch (per frame, its longest
     launch, the active face on the orbit, and the others, gated off), and
     the device's idle share (the full table goes to --profile-table);
  7. print one JSON line describing the kernels, then the card, then the
     result line.

Usage: python3 chip_smoke.py [--profile-table PATH]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "doc" / "golden_poses_r05_synthetic_640x480_512.txt"
PROFILE_TABLE = REPO / "build" / "profile_table.txt"
#: where the session phase writes its PLY, poses and checkpoint files
SESSION_OUT = REPO / "build" / "chip_smoke_session"
#: bench.py's orbit length
ORBIT_FRAMES = 50

KERNELS = (
    # (launch-count key, name, source, TPU kernel it replaces)
    ("icp_normal_eqs", "K1 icp_normal_eqs", "kinfu_tpu_torch/csrc/icp_normal_eqs.cu",
     "kinfu_tpu/ops/pallas_icp.py:48"),
    ("build_face", "K2 build_face", "kinfu_tpu_torch/csrc/build_face.cu",
     "kinfu_tpu/ops/facewarp.py:285"),
    ("face_integrate", "K3 face_integrate", "kinfu_tpu_torch/csrc/face_integrate.cu",
     "kinfu_tpu/ops/pallas_integrate.py:204"),
    ("sweep_rays", "K4 sweep_rays", "kinfu_tpu_torch/csrc/sweep_rays.cu",
     "kinfu_tpu/ops/pallas_raycast.py:114"),
    ("resample_face", "K5 resample_face", "kinfu_tpu_torch/csrc/resample_face.cu",
     "kinfu_tpu/ops/pallas_raycast.py:579"),
)

#: K1 tolerance on A and b, relative to their largest |entry| (the sums run
#: in another order), and the inliers a level must have to test something
K1_TOL = 1e-4
K1_MIN_INLIERS = 1000
#: K4 tolerances: hit-mask agreement and |t| gap where both hit (metres)
K4_MASK_AGREE = 0.999
K4_T_TOL = 1e-4
#: orbit acceptance: aligned ATE against exact ground truth (metres)
ATE_MAX = 1.0e-3
#: K1 launches per ICP iteration (one kernel; its last block finishes)
K1_PER_ITER = 1
#: frames of the gather-ICP leg
GATHER_FRAMES = 10
#: the session's pose record against the step's poses
SESSION_POSE_TOL = 1e-4
#: the fewest points the session's cloud of the 512^3 orbit may have
SESSION_MIN_POINTS = 100_000

#: NVIDIA H100 SXM peaks (data sheet): HBM bytes/s and float32 FLOP/s
#: outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
#: float32 operations per work item, counted from each kernel's source and
#: rounded up: K1 per current pixel; K2 per face-stack pixel; K3 per voxel of
#: a plane's footprint (projection and ownership), per voxel it updates and
#: per voxel whose colour it mixes; K4 per ray-plane step; K5 per camera
#: pixel
OPS = {"icp_normal_eqs": 150, "build_face": 40, "face_integrate_gate": 24,
       "face_integrate_update": 24, "face_integrate_colour": 20, "sweep_rays": 15,
       "resample_face": 40}


def bound(nbytes: int, ops: int):
    """(bound_ms, bound_by): the least time the card could take to move
    `nbytes` once and to do `ops` float32 operations."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def configure():
    """bench.py's workload on the port: (params, intr)."""
    from kinfu_tpu_torch.config import KinFuParams
    from kinfu_tpu_torch.geometry.intrinsics import Intrinsics

    params = KinFuParams(
        pyramid_height=3,
        icp_iters=(4, 5, 10),
        volume_dims=(512, 512, 512),
        fused_mode="auto",
        integrate_mode="auto",
        raycast_mode="auto",
        icp_mode="auto",
    )
    intr = Intrinsics(width=640, height=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5)
    return params, intr


def orbit_frames(n: int, intr):
    from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory

    scene = default_test_scene()
    traj = make_orbit_trajectory(n, angle_step_deg=0.3)
    gt = [np.linalg.inv(traj[0]) @ T for T in traj]
    return [scene.render_frame(T, intr) for T in traj], gt


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of `fn` over `reps` runs after `warmup` runs,
    each bracketed by CUDA events on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def inside_view(frame_, params):
    """World-from-camera pose at the volume's centre, looking along the
    sweep direction of `frame_` (its primed +z), so that the face owns the
    whole view."""
    R = np.asarray(frame_.D, np.float64).T.copy()  # columns: primed axes
    if np.linalg.det(R) < 0:
        R[:, 0] = -R[:, 0]
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(params.volume_origin) + np.asarray(params.volume_range) / 2
    return T


def check_kernels(state, frame, pose, params, intr, device):
    """Phase 3: each kernel against its plain version on the same inputs:
    all six faces seen from the orbit pose `pose` (the main path's view;
    timed on its +z face), then each face seen from the volume's centre
    looking along it, so that every face gets real work: in each of those
    views and in the timed one, K2's image must be non-empty, K3 must update
    voxels, K4 must hit the surface and K5 must resample a hit. Returns
    {key: [max_abs_err, ms, plain_ms, bound_ms, bound_by]}, the times and
    bounds of the timed view. Prints, for the timed view, K3's and K4's
    times for a gated-off call (CUDA events: mostly the wrapper's host time;
    phase 6 gives the device's) and K3's footprint voxels beside the voxels
    of its admitted planes; for every view, K4's count of rays whose hit or
    back bits differ from the plain version's."""
    import torch

    from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
    from kinfu_tpu_torch.ops import face_integrate as fi
    from kinfu_tpu_torch.ops import face_raycast as fr
    from kinfu_tpu_torch.ops import facewarp as fw
    from kinfu_tpu_torch.volume.tsdf import TSDFVolume, pack_rgb

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ms = cuda_ms if device.type == "cuda" else (lambda fn, **k: float("nan"))
    depth, color = frame
    depth_m = torch.as_tensor(depth * np.float32(params.depth_scale), device=device)
    col_packed = pack_rgb(torch.as_tensor(color, device=device))
    volp = pose_from_matrix(torch.as_tensor(params.volume_pose, device=device))
    fspec = fw.default_face_spec()
    size, focal = params.raycast_face
    rspec = fr.RaySpec(int(size), float(focal))
    on = torch.ones((), dtype=torch.bool, device=device)
    dims_xyz = params.volume_dims
    vs = params.voxel_size
    vol = state.vol
    res = {k: [0.0, float("nan"), float("nan"), float("nan"), ""]
           for k, *_ in KERNELS if k != "icp_normal_eqs"}
    k4_agree, k4_differ = [], 0

    views = [("orbit", pose, f) for f in fw.face_frames()]
    views += [("inside", inside_view(f, params), f) for f in fw.face_frames()]
    for view, T, frame_ in views:
        timed_here = view == "orbit" and frame_.name == "+z"
        must_work = timed_here or view == "inside"
        tag = f"{view} {frame_.name}"
        cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32, device=device))
        vol2cam = compose(inverse(cam), volp)
        cam2vol = compose(inverse(volp), cam)

        # K2
        A, c_p = fw.face_geometry(vol2cam, frame_, dims_xyz, vs)
        prm2 = fw.face_params(A, intr, on, fspec)
        rk, ck = fw.build_face(depth_m, col_packed, prm2, fspec)
        rp, cp = fw.build_face_plain(depth_m, col_packed, prm2, fspec)
        sync()
        err2 = max(int((rk.int() - rp.int()).abs().max()), int((ck - cp).abs().max()))
        res["build_face"][0] = max(res["build_face"][0], float(err2))
        if err2:
            _fail(f"K2 {tag}: the stack differs from the plain version by up to {err2}")
        if must_work and not bool(rk.any()):
            _fail(f"K2 {tag}: the face image is empty, so the comparison tested nothing")
        if timed_here:
            res["build_face"][1] = ms(lambda: fw.build_face(depth_m, col_packed, prm2, fspec))
            res["build_face"][2] = ms(lambda: fw.build_face_plain(depth_m, col_packed, prm2, fspec))
            res["build_face"][3:] = bound(nbytes(depth_m, col_packed, prm2, rk, ck),
                                          OPS["build_face"] * rk.numel())

        # K3 on copies of the fused volume
        prm3 = fi.sweep_params(c_p, fw.primed_voxel_size(frame_, vs), fspec, params,
                               rk.max().float(), on, prm2, intr)
        dims_p = tuple(vol.tsdf.shape[a] for a in frame_.axes)
        table = fi.plane_table(fspec, prm3, dims_p)
        vk = TSDFVolume(*(a.clone() for a in vol))
        vp = TSDFVolume(*(a.clone() for a in vol))
        fi.sweep_face(vk, frame_, rk, ck, prm3, table)
        # the voxels updated and colour-mixed depend on the face stack and the
        # geometry only, so they hold for the timed sweeps below too
        n_upd, n_col = (int(c) for c in fi.sweep_face_plain(vp, frame_, rk, ck, prm3, table))
        sync()
        err3 = max(int((a.int() - b.int()).abs().max()) for a, b in zip(vk, vp))
        changed = int((vk.weight != vol.weight).sum())
        print(f"  K3 {tag}: {changed} voxels updated ({n_upd} by the plain version, {n_col} "
              f"colour-mixed), max |kernel - plain| {err3}", flush=True)
        res["face_integrate"][0] = max(res["face_integrate"][0], float(err3))
        if err3:
            _fail(f"K3 {tag}: kernel and plain version differ")
        if must_work and not changed:
            _fail(f"K3 {tag}: no voxel updated, so the comparison tested nothing")
        if timed_here:
            res["face_integrate"][1] = ms(lambda: fi.sweep_face(vk, frame_, rk, ck, prm3, table))
            res["face_integrate"][2] = ms(
                lambda: fi.sweep_face_plain(vp, frame_, rk, ck, prm3, table), reps=10, warmup=1)
            off3 = prm3.clone()
            off3[11] = 0.0
            k3_off = ms(lambda: fi.sweep_face(vk, frame_, rk, ck, off3, table))
            # tsdf + weight (4 bytes) read and written where it updates, colour
            # (4 bytes) read and written where it mixes; the face stack, the
            # table and the parameters read once. Every voxel of a plane's
            # footprint is projected and tested for ownership (the bound by
            # every voxel of the admitted planes is printed beside it).
            admitted = int((table[:, -1] != 0).sum()) * dims_p[1] * dims_p[2]
            in_fp = int(fi.footprint_voxels(fi.plane_footprint(table, prm3, dims_p)))
            old_ops = bound(8 * n_upd + 8 * n_col + nbytes(rk, ck, prm3, table),
                            OPS["face_integrate_gate"] * admitted
                            + OPS["face_integrate_update"] * n_upd
                            + OPS["face_integrate_colour"] * n_col)
            res["face_integrate"][3:] = bound(
                8 * n_upd + 8 * n_col + nbytes(rk, ck, prm3, table),
                OPS["face_integrate_gate"] * in_fp + OPS["face_integrate_update"] * n_upd
                + OPS["face_integrate_colour"] * n_col)
            print(f"  K3 {tag}: {in_fp} footprint voxels, {admitted} voxels of the admitted "
                  f"planes; bound {res['face_integrate'][3]:.4f} ms "
                  f"({res['face_integrate'][4]}) by the footprint, {old_ops[0]:.4f} ms "
                  f"({old_ops[1]}) by the admitted planes; a gated-off call {k3_off:.4f} ms",
                  flush=True)
        del vk, vp

        # K4 on the fused volume
        D, off, vs_p = fr.prime_geometry(frame_, params, device)
        org_p = D @ cam2vol.t + off
        prm4 = fr.ray_params(org_p, vs_p, rspec, on)
        hk, bk = fr.sweep_rays(vol.tsdf, frame_, prm4, rspec)
        hp, bp = fr.sweep_rays_plain(vol.tsdf, frame_, prm4, rspec)
        sync()
        okk = (hk < bk) & (hk < 1e30)
        okp = (hp < bp) & (hp < 1e30)
        agree = float((okk == okp).float().mean())
        both = okk & okp
        dt4 = float((hk - hp).abs()[both].max()) if bool(both.any()) else 0.0
        differ = int(((hk.view(torch.int32) != hp.view(torch.int32))
                      | (bk.view(torch.int32) != bp.view(torch.int32))).sum())
        k4_agree.append(agree)
        k4_differ += differ
        print(f"  K4 {tag}: {int(okk.sum())} hits, mask agreement {agree:.6f}, "
              f"max |dt| {dt4:.3g} m, {differ} rays with other hit or back bits", flush=True)
        if agree < K4_MASK_AGREE or dt4 > K4_T_TOL:
            _fail(f"K4 {tag}: agreement {agree} < {K4_MASK_AGREE} or |dt| {dt4} > {K4_T_TOL}")
        if must_work and not bool(okk.any()):
            _fail(f"K4 {tag}: no ray hit the surface, so the comparison tested nothing")
        res["sweep_rays"][0] = max(res["sweep_rays"][0], dt4)
        if timed_here:
            res["sweep_rays"][1] = ms(lambda: fr.sweep_rays(vol.tsdf, frame_, prm4, rspec))
            res["sweep_rays"][2] = ms(lambda: fr.sweep_rays_plain(vol.tsdf, frame_, prm4, rspec),
                                      reps=10, warmup=1)
            # each int16 voxel that a ray samples before it resolves, once; a
            # step for each plane that a live ray marches
            n_vox, n_steps = (int(c) for c in fr.sweep_rays_work(vol.tsdf, frame_, prm4, rspec))
            print(f"  K4 {tag}: the rays sample {n_vox} distinct voxels in {n_steps} "
                  f"ray-plane steps", flush=True)
            res["sweep_rays"][3:] = bound(2 * n_vox + nbytes(prm4, hk, bk),
                                          OPS["sweep_rays"] * n_steps)
            off4 = prm4.clone()
            off4[10] = 0.0
            print(f"  K4 {tag}: a gated-off call "
                  f"{ms(lambda: fr.sweep_rays(vol.tsdf, frame_, off4, rspec)):.4f} ms", flush=True)

        # K5 on the shaded face fields
        t_f, n_f, _ = fr.face_fields(hp, bp, org_p, rspec)
        n_f = n_f.contiguous()
        prm5 = fw.face_params(D @ cam2vol.R, intr, on, rspec)
        tk, nk = fr.resample_face(t_f, n_f, prm5, intr)
        tp, np_ = fr.resample_face_plain(t_f, n_f, prm5, intr)
        sync()
        err5 = max(float((tk - tp).abs().max()), float((nk - np_).abs().max()))
        res["resample_face"][0] = max(res["resample_face"][0], err5)
        if err5:
            _fail(f"K5 {tag}: values differ from the plain version by up to {err5}")
        if must_work and not bool(torch.isfinite(tk).any()):
            _fail(f"K5 {tag}: no camera pixel took a face sample, so the comparison "
                  "tested nothing")
        if timed_here:
            res["resample_face"][1] = ms(lambda: fr.resample_face(t_f, n_f, prm5, intr))
            res["resample_face"][2] = ms(lambda: fr.resample_face_plain(t_f, n_f, prm5, intr))
            res["resample_face"][3:] = bound(nbytes(t_f, n_f, prm5, tk, nk),
                                             OPS["resample_face"] * tk.numel())
    print(f"  K2 and K5 bit-exact, K3 int16/int32 equal on {len(views)} views; "
          f"K4 min mask agreement {min(k4_agree):.6f}, {k4_differ} rays with other hit or "
          f"back bits in all", flush=True)
    return res


def check_icp(state, frame, params, intr, device):
    """Phase 3, K1: frame 3's measurement pyramid against the model maps of
    `state` at every level, with the identity increment and a small one.
    The kernel's inlier count must equal the plain version's, A and b must
    agree within K1_TOL of their largest |entry|, a second launch must give
    the same bits, and every level must have more than K1_MIN_INLIERS
    inliers. Times level 0 with the small increment. Returns
    [max_abs_err, ms, plain_ms, bound_ms, bound_by]."""
    import torch

    from kinfu_tpu_torch.frontend.maps import build_measurement_pyramid
    from kinfu_tpu_torch.geometry.se3 import Pose, rodrigues
    from kinfu_tpu_torch.ops import icp_warped as iw

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ms = cuda_ms if device.type == "cuda" else (lambda fn, **k: float("nan"))
    p = params
    _, cvs, cns = build_measurement_pyramid(
        torch.as_tensor(frame[0], device=device), intr, pyramid_height=p.pyramid_height,
        bfilter_kernel_size=p.bfilter_kernel_size, bfilter_color_sigma=p.bfilter_color_sigma,
        bfilter_spatial_sigma=p.bfilter_spatial_sigma, depth_scale=p.depth_scale,
        max_dist=p.dfilter_dist, normal_disc_threshold=p.normal_disc_threshold)
    sin_t = math.sin(math.radians(p.icp_angle_threshold))
    increments = {"identity": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
                  "small": ((0.002, -0.004, 0.001), (0.004, -0.002, 0.003))}
    res = [0.0, float("nan"), float("nan"), float("nan"), ""]
    for level in range(p.pyramid_height):
        maps = (cvs[level], cns[level], state.model_vmaps[level], state.model_nmaps[level])
        for name, (rvec, t) in increments.items():
            inc = Pose(rodrigues(torch.tensor(rvec, dtype=torch.float32, device=device)),
                       torch.tensor(t, dtype=torch.float32, device=device))
            args = (inc, *maps, intr.level(level), p.icp_dist_threshold, sin_t)
            A, b, n = iw.icp_normal_eqs_warped(*args)
            A2, b2, n2 = iw.icp_normal_eqs_warped(*args)
            pA, pb, pn = iw.icp_normal_eqs_warped_plain(*args)
            sync()
            tag = f"K1 level {level}, {name} increment"
            if not (torch.equal(A, A2) and torch.equal(b, b2) and torch.equal(n, n2)):
                _fail(f"{tag}: a second launch on the same inputs gave other bits")
            if int(n) != int(pn):
                _fail(f"{tag}: {int(n)} inliers, the plain version {int(pn)}")
            if int(n) <= K1_MIN_INLIERS:
                _fail(f"{tag}: only {int(n)} inliers, so the comparison tested little")
            err_a, scale_a = float((A - pA).abs().max()), float(pA.abs().max())
            err_b, scale_b = float((b - pb).abs().max()), float(pb.abs().max())
            print(f"  {tag}: {int(n)} inliers (plain {int(pn)}); max |A - plain| {err_a:.3g} "
                  f"of {scale_a:.3g}, max |b - plain| {err_b:.3g} of {scale_b:.3g}", flush=True)
            if err_a > K1_TOL * scale_a or err_b > K1_TOL * scale_b:
                _fail(f"{tag}: A or b differs from the plain version by more than "
                      f"{K1_TOL} of its largest entry")
            res[0] = max(res[0], err_a, err_b)
            if level == 0 and name == "small":
                res[1] = ms(lambda: iw.icp_normal_eqs_warped(*args))
                res[2] = ms(lambda: iw.icp_normal_eqs_warped_plain(*args))
                # the current maps once, the model pixels gathered once
                gathered = int(iw.icp_normal_eqs_warped_work(inc, maps[0], maps[1], maps[2],
                                                             intr.level(level)))
                print(f"  {tag}: gathers {gathered} distinct model pixels", flush=True)
                res[3:] = bound(nbytes(maps[0], maps[1], A, b, n) + 24 * gathered,
                                OPS["icp_normal_eqs"] * maps[0].shape[0] * maps[0].shape[1])
    return res


def run_orbit(frames, params, intr, device):
    """Phase 4: the tracked orbit through init_state + kinfu_step. Returns
    (poses [N,4,4], oks [N], inliers [N], per-frame ms [N], final state)."""
    import torch

    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.pipeline.kinfu import init_state, make_step_fn

    dev_frames = [(torch.as_tensor(d, device=device), torch.as_tensor(c, device=device))
                  for d, c in frames]
    step = make_step_fn(params, intr)
    state = init_state(params, intr, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs, events = [], []
    for d, c in dev_frames:
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state, out = step(state, d, c)
            b.record()
            events.append((a, b))
        else:
            state, out = step(state, d, c)
        outs.append(out)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    poses = np.stack([o.pose_matrix.cpu().numpy() for o in outs])
    oks = np.array([bool(o.tracking_ok) for o in outs])
    inliers = np.array([int(o.icp_inliers) for o in outs])
    frame_ms = np.array([a.elapsed_time(b) for a, b in events]) if events else None
    return poses, oks, inliers, frame_ms, state, launches


def run_session(frames, gt, ref_poses, params, intr, out_dir: Path, **session_kw):
    """Phase 5: the frames of phase 4 through KinFuSession (numpy frames in),
    with the launch counts set to 0 just before; then render, export and a
    checkpoint round trip. Returns (launches, host ms per frame)."""
    import torch

    from kinfu_tpu_torch.eval.ate import ate_rmse
    from kinfu_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from kinfu_tpu_torch.io.ply import read_ply
    from kinfu_tpu_torch.io.poses import read_poses_reference_format
    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.pipeline.session import KinFuSession

    n = len(ref_poses)
    sess = KinFuSession(intr, params, **session_kw)
    sync = torch.cuda.synchronize if sess.device.type == "cuda" else (lambda: None)
    sync()
    kernels.reset_launch_counts()
    oks = [sess.pipeline(c, d) for d, c in frames[:n]]
    sync()
    launches = dict(kernels.LAUNCHES)
    if not all(oks):
        _fail(f"session: tracking failed at frames {[k for k, ok in enumerate(oks) if not ok]}")
    record = np.stack(sess.pose_record)
    gap = float(np.abs(record - ref_poses).max()) if record.shape == ref_poses.shape else np.inf
    ate = ate_rmse(list(record), gt[:n])
    host_ms = float(np.median(sess.frame_times_ms[2:]))
    print(f"    {n}/{n} frames tracked on {sess.device}; aligned ATE {ate * 1e3:.4f} mm; "
          f"max |pose record - phase 4 poses| {gap:.3g}; {host_ms:.3f} ms/frame host clock "
          f"(median of frames 2-{n - 1}); launches {launches}", flush=True)
    if gap > SESSION_POSE_TOL:
        _fail(f"session: the pose record differs from phase 4's poses by {gap}")
    if ate > ATE_MAX:
        _fail(f"session: aligned ATE {ate * 1e3:.4f} mm > {ATE_MAX * 1e3} mm")
    for key, name, *_ in KERNELS:
        if launches.get(key, 0) <= 0:
            _fail(f"session: {name} was not launched")

    img = sess.get_render_map(KinFuSession.PHONG)
    vm, nm = sess.state.model_vmaps[0], sess.state.model_nmaps[0]
    valid = ((nm != 0).any(-1) & (vm != 0).any(-1)).cpu().numpy()
    frac = float((img != 0).any(-1)[valid].mean()) if valid.any() else 0.0
    normals = sess.get_render_map(KinFuSession.NORMAL)
    print(f"    Phong render nonzero on {frac:.4%} of the {int(valid.sum())} pixels with "
          f"valid model maps", flush=True)
    if img.shape != (intr.height, intr.width, 3) or normals.shape != img.shape or frac < 0.99:
        _fail(f"session: render {img.shape}, nonzero on {frac:.4%} of the valid pixels")

    pts = sess.extract_pointcloud()
    lo = np.asarray(params.volume_origin, np.float32)
    inside = bool(((pts >= lo) & (pts <= lo + np.asarray(params.volume_range))).all())
    print(f"    extracted {len(pts)} points, all inside the volume: {inside}", flush=True)
    if len(pts) <= SESSION_MIN_POINTS or not inside:
        _fail(f"session: {len(pts)} points extracted, all inside the volume: {inside}")
    out_dir.mkdir(parents=True, exist_ok=True)
    sess.save_pointcloud(str(out_dir / "cloud.ply"))
    back = read_ply(str(out_dir / "cloud.ply"))
    if back.shape != pts.shape or not np.allclose(back, pts, rtol=1e-5, atol=1e-6):
        _fail("session: the PLY file does not read back as the extracted points")
    sess.save_poses(str(out_dir / "poses.txt"))
    back = read_poses_reference_format(str(out_dir / "poses.txt"))
    if len(back) != n or not np.allclose(np.stack(back), record, rtol=0, atol=1e-6):
        _fail("session: the poses file does not read back as the pose record")

    ckpt = out_dir / "session.npz"
    save_checkpoint(str(ckpt), sess)
    resumed = load_checkpoint(str(ckpt), device=sess.device)
    ckpt.unlink()
    same = (resumed.frame_count == sess.frame_count
            and np.array_equal(np.stack(resumed.pose_record), record)
            and all(torch.equal(a, b) for a, b in zip(resumed.state.vol, sess.state.vol)))
    del sess
    ok = resumed.pipeline(frames[n][1], frames[n][0])
    print(f"    checkpoint: state and record equal after loading: {same}; frame {n} "
          f"tracked after resuming: {ok} ({resumed.last_icp_inliers} inliers)", flush=True)
    if not (same and ok):
        _fail("session: the checkpoint did not load as saved, or the next frame lost tracking")
    return launches, host_ms


def profile_steps(frames, params, intr, device, out_path: str, ms_frame: float,
                  n: int = 10) -> None:
    """Phase 6: torch.profiler over frames 2..n-1 of a fresh run. Prints the
    kernels by device time, their sum per frame and its share of `ms_frame`
    (the step's time without the profiler), each port kernel's device time
    per frame and a launch (per frame, its longest launch and the median of
    the others: on the orbit, the active face and the gated-off ones), and
    writes the full table to `out_path`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kinfu_tpu_torch.pipeline.kinfu import init_state, make_step_fn

    step = make_step_fn(params, intr)
    state = init_state(params, intr, device=device)
    dev = [(torch.as_tensor(d, device=device), torch.as_tensor(c, device=device))
           for d, c in frames[:n]]
    for d, c in dev[:2]:
        state, _ = step(state, d, c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for d, c in dev[2:]:
            state, _ = step(state, d, c)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / (n - 2)
    # kernel events only: an operator's self device time repeats its kernels'
    ev = sorted((e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / (n - 2)
    launches = sum(e.count for e in ev) / (n - 2)
    print(f"[6] profile, frames 2-{n - 1} of a fresh run: kernels busy {busy:.3f} ms/frame in "
          f"{launches:.0f} launches/frame; {busy / ms_frame:.1%} of the "
          f"{ms_frame:.3f} ms/frame step (device idle {1 - busy / ms_frame:.1%}); "
          f"{wall:.1f} ms/frame wall under the profiler", flush=True)
    for e in ev[:12]:
        print(f"      {e.self_device_time_total / 1e3 / (n - 2):9.3f} ms/frame "
              f"{e.count // (n - 2):5d}x  {e.key[:90]}", flush=True)
    launches_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for key, name, *_ in KERNELS:
        mine = sorted((e for e in launches_ev if f"{key}_kernel" in e.name),
                      key=lambda e: e.time_range.start)
        each = [e.time_range.elapsed_us() / 1e3 for e in mine]
        per = len(each) // (n - 2)
        line = (f"    {name}: device {sum(each) / (n - 2):.3f} ms/frame in "
                f"{len(each) / (n - 2):.0f} launches/frame")
        if per > 1 and per * (n - 2) == len(each):
            frames_ = [sorted(each[i * per:(i + 1) * per]) for i in range(n - 2)]
            line += (f"; a launch: {float(np.median([f[-1] for f in frames_])):.4f} ms the "
                     f"longest of a frame, {float(np.median([t for f in frames_ for t in f[:-1]])):.4f}"
                     f" ms the others (medians)")
        print(line, flush=True)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=80, max_name_column_width=90))


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-table", metavar="PATH", default=str(PROFILE_TABLE),
                    help="where to write the full profiler table (default: %(default)s)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script measures the GPU and "
              "never falls back to the CPU")
    if not (REPO / "kinfu_tpu_torch" / "csrc").is_dir():
        _fail(f"kinfu_tpu_torch/csrc not found beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import kinfu_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
    from kinfu_tpu_torch.eval.ate import ate_rmse
    from kinfu_tpu_torch.io.poses import read_poses_reference_format
    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.pipeline.kinfu import init_state, kinfu_step
    from kinfu_tpu_torch.tracking.icp import resolve_icp_mode

    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"[1] card: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{count} visible); nvidia-smi: {smi}", flush=True)

    t_build = kernels.timed_build()
    print(f"[2] built and loaded kernels from {kernels.CSRC.relative_to(REPO)} "
          f"in {t_build:.1f} s", flush=True)

    params, intr = configure()
    n = ORBIT_FRAMES
    t0 = time.perf_counter()
    # one frame more than the orbit: the session resumes from its checkpoint on it
    frames, gt = orbit_frames(n + 1, intr)
    print(f"    rendered {n + 1} frames {intr.width}x{intr.height} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if resolve_icp_mode(params, device) != "warped":
        _fail(f"icp_mode={params.icp_mode!r} does not resolve to the warped kernel on {device}")

    # a 512^3 volume fused from 3 frames, then frame 3 as the kernels' input
    state = init_state(params, intr, device=device)
    for d, c in frames[:3]:
        state, _ = kinfu_step(state, torch.as_tensor(d, device=device),
                              torch.as_tensor(c, device=device), params, intr)
    torch.cuda.synchronize()
    print("[3] kernels against their plain versions (frame 3, volume fused from "
          "frames 0-2):", flush=True)
    res = {"icp_normal_eqs": check_icp(state, frames[3], params, intr, device)}
    res.update(check_kernels(state, frames[3], gt[3], params, intr, device))
    for key, name, *_ in KERNELS:
        err, ms, plain_ms, bound_ms, bound_by = res[key]
        print(f"    {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), max abs err {err:.3g}  [{smi}]", flush=True)
    del state
    torch.cuda.empty_cache()

    print(f"[4] orbit: {n} frames through init_state + kinfu_step, icp_mode="
          f"{params.icp_mode!r}", flush=True)
    poses, oks, inliers, frame_ms, state, launches = run_orbit(frames[:n], params, intr, device)
    for i in range(0, n, 10):
        print(f"    frame {i:2d}: ok={bool(oks[i])} inliers={int(inliers[i])} "
              f"{frame_ms[i]:.2f} ms", flush=True)
    if not oks[1:].all():
        _fail(f"tracking failed at frames {np.nonzero(~oks[1:])[0] + 1}")
    if not np.isfinite(poses).all():
        _fail("non-finite pose")
    for lv, (vm, nm) in enumerate(zip(state.model_vmaps, state.model_nmaps)):
        li = intr.level(lv)
        if tuple(vm.shape) != (li.height, li.width, 3) or not bool(torch.isfinite(vm).all()) \
                or not bool(torch.isfinite(nm).all()):
            _fail(f"model map level {lv}: bad shape {tuple(vm.shape)} or non-finite values")
    hit_frac = float((state.model_nmaps[0] != 0).any(-1).float().mean())
    del state
    torch.cuda.empty_cache()
    ate = ate_rmse(list(poses), gt[:n])
    ate_raw = ate_rmse(list(poses), gt[:n], align=False)
    golden = read_poses_reference_format(str(GOLDEN))[:n]
    gap = max(float(np.linalg.norm(p[:3, 3] - g[:3, 3])) for p, g in zip(poses, golden))
    ms_frame = float(np.median(frame_ms[2:]))
    k1_want = sum(params.icp_iters) * n * K1_PER_ITER
    print(f"    tracked {int(oks[1:].sum())}/{n - 1} frames after bootstrap; model hit "
          f"fraction {hit_frac:.3f}", flush=True)
    print(f"    ATE vs exact ground truth: aligned {ate * 1e3:.4f} mm, raw "
          f"{ate_raw * 1e3:.4f} mm; max translation gap to {GOLDEN.name} "
          f"{gap * 1e3:.4f} mm (printed, not gated)", flush=True)
    print(f"    {ms_frame:.3f} ms/frame (median of frames 2-{n - 1}, CUDA events) "
          f"on {smi}", flush=True)
    print(f"    launches in the orbit: {launches}", flush=True)
    if ate > ATE_MAX:
        _fail(f"aligned ATE {ate * 1e3:.4f} mm > {ATE_MAX * 1e3} mm")
    for key, name, *_ in KERNELS:
        if launches.get(key, 0) <= 0:
            _fail(f"{name} was not launched on the main path")
    if launches["icp_normal_eqs"] != k1_want:
        _fail(f"K1 launched {launches['icp_normal_eqs']} times in the orbit, not "
              f"{sum(params.icp_iters)} iterations x {n} frames x {K1_PER_ITER} = {k1_want}")

    gather = params.replace(icp_mode="gather")
    g_poses, g_oks, _, g_ms, g_state, g_launches = run_orbit(frames[:GATHER_FRAMES], gather,
                                                             intr, device)
    del g_state
    g_gap = float(np.abs(g_poses - poses[:GATHER_FRAMES]).max())
    print(f"    gather leg: {GATHER_FRAMES} frames with icp_mode='gather', tracked "
          f"{int(g_oks[1:].sum())}/{GATHER_FRAMES - 1}; max |pose - warped pose| {g_gap:.3g}; "
          f"launches {g_launches}", flush=True)
    print(f"    frames 2-{GATHER_FRAMES - 1}, median ms/frame (CUDA events): gather "
          f"{float(np.median(g_ms[2:])):.3f}, warped {float(np.median(frame_ms[2:GATHER_FRAMES])):.3f} "
          f"(warped ran first)", flush=True)
    if not g_oks[1:].all() or g_launches.get("icp_normal_eqs", 0) != 0:
        _fail("the gather leg lost tracking or launched K1")
    torch.cuda.empty_cache()

    print(f"[5] session: {n} frames through KinFuSession (default device)", flush=True)
    s_launches, s_host_ms = run_session(frames, gt, poses, params, intr, SESSION_OUT)
    if s_launches["icp_normal_eqs"] != k1_want:
        _fail(f"K1 launched {s_launches['icp_normal_eqs']} times in the session, not {k1_want}")
    torch.cuda.empty_cache()

    profile_steps(frames[:n], params, intr, device, args.profile_table, ms_frame)

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": int(launches[key]), "max_abs_err": float(res[key][0]),
         "ms": res[key][1], "plain_ms": res[key][2], "bound_ms": res[key][3],
         "bound_by": res[key][4], "library_ms": None}
        for key, name, src, rep in KERNELS
    ]}
    print(json.dumps(summary))
    print(f"{smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
