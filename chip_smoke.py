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
     largest entry, the same bits on a second launch); K1's finishing form
     (one launch against finish_iteration on its own system, the whole ICP
     of one host call against rigid_icp_plain, a singular system), timed
     beside the same ICP as one-iteration launches with the eager finish;
     K2 build_face (the six faces' stacks in one launch, every face gated
     on and then with the step's gates: the active stacks and r_max bit for
     bit, and K3 leaving the volume unchanged on a gated-off face whose
     unwritten stack holds a sentinel), K3 face_integrate and K4 sweep_rays
     on that 512^3 volume and frame 3 (all six cube faces seen from the
     orbit pose, and each face seen from the volume's centre looking along
     it); K5 resample_face, the resample and composite of all six faces in
     one launch, on the orbit's view and the six centre views; K3's and
     K4's time for a gated-off call, K3's footprint voxels beside the voxels
     of its admitted planes, and K4's count of rays whose hit or back bits
     differ from the plain version's (no profiler before phase 6: once
     started in a process it slows every later launch);
  4. count the host syncs of a step (sync-debug mode "warn"), then run the
     50-frame orbit of bench.py (640x480, fx=fy=525, 512^3 over 3 m,
     3-level pyramid, ICP (4,5,10), icp_mode="auto", which is the warped ICP
     kernel K1 on the card) through init_state + kinfu_step with the launch
     counts set to 0 just before, each step under sync-debug mode "error"
     (a host sync in the step fails the run); every frame after the first
     must track, the aligned ATE against exact ground truth must be <= 1 mm,
     K1 must launch 19 times a frame, K2 and K5 once, every other kernel at
     least once; then 10 frames with icp_mode="gather", also under
     sync-debug mode "error", which must track without launching K1;
  4b. the corner orbit of bench.py --corner (the orbit yawed 50 degrees
     through the corner-facing scene), 50 frames under sync-debug mode
     "error", with the orbit's checks, the gap to the JAX package's golden
     poses and the faces gated on at each frame (a +-x face must be live on
     some frames); then K2-K5 against their plain versions at its last
     frame, where the +z and +x faces are live;
  5. the same 50 frames through KinFuSession with its default device, numpy
     frames in, the counts set to 0 just before: every frame tracks, the
     aligned ATE is <= 1 mm, the pose record agrees with phase 4's; the
     Phong render, the point cloud, the PLY and pose files, and a
     checkpoint that is loaded and tracks one more frame;
  5b. the first 20 orbit frames written as a bundled dataset (PNGs and
     intr.txt) through the port's writers, then `python -m kinfu_tpu_torch
     run` and `eval` on it as subprocesses on the card: every frame tracks,
     the aligned ATE is <= 1 mm, the PLY has enough points, and a session
     in this process over the same PNGs gives the CLI's poses, launching K2
     and K5 once a frame;
  6. profile 8 steps of a fresh run of the orbit: kernel time per frame,
     each port kernel's device time per frame and a launch (per frame, its
     longest launch, the active face, and the others, gated off), and the
     device's idle share (the full table goes to --profile-table); then the
     device time and launches of the ICP of a frame alone, one host call
     against one-iteration launches with the eager finish; then 8 steps of
     the corner orbit where two faces are live (frames 20-27);
  7. print one JSON line describing the kernels, then the card, then the
     result line.

Usage: python3 chip_smoke.py [--profile-table PATH] [--count-syncs]
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "doc" / "golden_poses_r05_synthetic_640x480_512.txt"
#: the JAX package's hardware poses of the corner orbit (bench.py --corner)
GOLDEN_CORNER = REPO / "doc" / "golden_poses_r05_corner_640x480_512.txt"
PROFILE_TABLE = REPO / "build" / "profile_table.txt"
#: where the session phase writes its PLY, poses and checkpoint files
SESSION_OUT = REPO / "build" / "chip_smoke_session"
#: where the CLI phase writes its dataset and the CLI's outputs
CLI_OUT = REPO / "build" / "chip_smoke_cli"
#: bench.py's orbit length
ORBIT_FRAMES = 50
#: frames of the orbit the CLI phase writes to disk and runs
CLI_FRAMES = 20

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
#: K1's finishing form: one launch against finish_iteration on its own
#: system (the LU and the transcendentals round otherwise), and the whole
#: ICP against rigid_icp_plain (later iterations start from poses that
#: differ by ulps, so a rint tie may flip an inlier)
K1_FINISH_TOL = 1e-6
K1_ICP_TOL = 1e-5
K1_ICP_INLIERS = 1e-3
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
#: rounded up: K1 per current pixel; K2 per level-0 pixel of a live face; K3 per voxel of
#: a plane's footprint (projection and ownership), per voxel it updates and
#: per voxel whose colour it mixes; K4 per ray-plane step; K5 per camera
#: pixel and gated face (the primed ray and the ownership test) and per
#: camera pixel (its owner's resample and unprime)
OPS = {"icp_normal_eqs": 150, "build_face": 40, "face_integrate_gate": 24,
       "face_integrate_update": 24, "face_integrate_colour": 20, "sweep_rays": 15,
       "resample_face_own": 20, "resample_face": 40}


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


def corner_frames(n: int, intr):
    """bench.py --corner's frames: the orbit yawed 50 degrees about the
    camera's y axis through the corner-facing scene, and the ground truth
    relative to the first camera."""
    from kinfu_tpu_torch.data.synthetic import (
        corner_test_scene,
        make_orbit_trajectory,
        yaw_trajectory,
    )

    scene = corner_test_scene()
    traj = yaw_trajectory(make_orbit_trajectory(n, angle_step_deg=0.3))
    gt = [np.linalg.inv(traj[0]) @ T for T in traj]
    return [scene.render_frame(T, intr) for T in traj], gt


def face_gates(poses, oks, params, intr, device) -> np.ndarray:
    """bool [N, 6]: the faces the step gated on at each frame, recomputed
    from its tracked poses as the fused update computes them
    (`faces_needed` of the frame's volume-to-camera pose, and tracking ok)."""
    import torch

    from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
    from kinfu_tpu_torch.ops.face_integrate import faces_needed

    volp = pose_from_matrix(torch.as_tensor(params.volume_pose, device=device))
    out = []
    for T, ok in zip(poses, oks):
        cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32, device=device))
        out.append(faces_needed(compose(inverse(cam), volp), intr).cpu().numpy() & bool(ok))
    return np.stack(out)


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


def check_faces(depth_m, col_packed, vol, vol2cam, params, intr, device, tag, timed: bool):
    """Phase 3, K2: the six faces' stacks of one view in one launch, twice.
    (a) Every face gated on: each stack and each r_max must equal the plain
    version's; these stacks feed the K3 and K4 checks. (b) The path's gates
    (`faces_needed`, as the step gates the faces): the active faces' stacks
    and every r_max must equal the plain version's; then each gated-off
    face's stack, which K2 leaves unwritten, is filled with a sentinel
    (0x7FFF, -1) and K3 runs on it with its gate off, which must leave the
    volume bit-unchanged. With `timed`, times (b) and returns its [ms,
    plain_ms, bound_ms, bound_by]. Returns (stacks of (a), the path's gates,
    the largest |kernel - plain|, the timing or None)."""
    import torch

    from kinfu_tpu_torch.ops import face_integrate as fi
    from kinfu_tpu_torch.ops import facewarp as fw
    from kinfu_tpu_torch.volume.tsdf import TSDFVolume

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ms = cuda_ms if device.type == "cuda" else (lambda fn, **k: float("nan"))
    fspec = fw.default_face_spec()
    frames = fw.face_frames()
    vs = params.voxel_size
    geo = [fw.face_geometry(vol2cam, f, params.volume_dims, vs) for f in frames]
    on = torch.ones(fw.FACES, dtype=torch.bool, device=device)
    gates = fi.faces_needed(vol2cam, intr)

    def blocks(g):
        return torch.stack([fw.face_params(A, intr, g[f], fspec) for f, (A, _) in enumerate(geo)])

    err = 0
    out = {}
    for name, g in (("all gated on", on), ("the path's gates", gates)):
        prm6 = blocks(g)
        rk, ck, mk = fw.build_faces(depth_m, col_packed, prm6, fspec)
        rp, cp, mp = fw.build_faces_plain(depth_m, col_packed, prm6, fspec)
        sync()
        live = [f for f in range(fw.FACES) if bool(g[f])]
        e = max([int((rk[f].int() - rp[f].int()).abs().max()) for f in live]
                + [int((ck[f] - cp[f]).abs().max()) for f in live]
                + [int((mk - mp).abs().max())])
        err = max(err, e)
        print(f"  K2 {tag}, {name} {[frames[f].name for f in live]}: max |kernel - plain| {e} "
              f"on the active faces' stacks, r_max {mk.tolist()} (plain {mp.tolist()})",
              flush=True)
        if e:
            _fail(f"K2 {tag}, {name}: the stacks or r_max differ from the plain version")
        out[name] = (prm6, rk, ck, mk)

    prm6, rg, cg, mg = out["the path's gates"]
    off = [f for f in range(fw.FACES) if not bool(gates[f])]
    vz = TSDFVolume(*(a.clone() for a in vol))
    for f in off:
        rg[f].fill_(0x7FFF)
        cg[f].fill_(-1)
        prm3 = fi.sweep_params(geo[f][1], fw.primed_voxel_size(frames[f], vs), fspec, params,
                               mg[f].float(), gates[f], prm6[f], intr)
        dims_p = tuple(vol.tsdf.shape[a] for a in frames[f].axes)
        fi.sweep_face(vz, frames[f], rg[f], cg[f], prm3, fi.plane_table(fspec, prm3, dims_p))
    sync()
    same = all(torch.equal(a, b) for a, b in zip(vz, vol))
    print(f"  K3 {tag}: gated off on {[frames[f].name for f in off]}, whose stacks hold a "
          f"sentinel: the volume is bit-unchanged: {same}", flush=True)
    if not same:
        _fail(f"K3 {tag}: a gated-off sweep changed the volume (it read a gated-off stack)")
    del vz

    timing = None
    if timed:
        k_ms = ms(lambda: fw.build_faces(depth_m, col_packed, prm6, fspec))
        p_ms = ms(lambda: fw.build_faces_plain(depth_m, col_packed, prm6, fspec), reps=5)
        # per active face: its stack written once (range and colour, 6 bytes
        # a stack pixel) and each camera pixel it loads read once (depth and
        # colour, 8 bytes); 40 operations a level-0 pixel
        n_live = int(gates.sum())
        h, w = depth_m.shape
        read = int(fw.build_faces_work(prm6, fspec, h, w))
        b_ms, b_by = bound(n_live * 6 * fspec.stack_rows * fspec.size + 8 * read + nbytes(prm6),
                           OPS["build_face"] * n_live * fspec.size * fspec.size)
        print(f"  K2 {tag}: {n_live} active face(s) read {read} camera pixels; one launch "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        timing = [k_ms, p_ms, b_ms, b_by]
    rk, ck, mk = out["all gated on"][1:]
    return (rk, ck, mk), gates, err, timing


def check_kernels(state, frame, views, params, intr, device, timed=None):
    """Phase 3: K2, K3 and K4 against their plain versions on the same
    inputs. `views` is [(tag, world-from-camera pose, faces to check)];
    K2 builds each view's six stacks (`check_faces`), and K3 and K4 run on
    the listed faces, each gated on. Every face of a view other than the
    timed one must do real work (K2's image non-empty, K3 voxels updated,
    K4 hits), as must the timed face. `timed` = (tag, face name) of the view
    and face to time, else None. Returns {key: [max_abs_err, ms, plain_ms,
    bound_ms, bound_by]}. Prints, for the timed face, K3's and K4's times
    for a gated-off call (CUDA events: mostly the wrapper's host time;
    phase 6 gives the device's) and K3's footprint voxels beside the voxels
    of its admitted planes; for every face, K4's count of rays whose hit or
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
    vs = params.voxel_size
    vol = state.vol
    res = {k: [0.0, float("nan"), float("nan"), float("nan"), ""]
           for k, *_ in KERNELS if k not in ("icp_normal_eqs", "resample_face")}
    k4_agree, k4_differ, n_checked = [], 0, 0

    for view, T, names in views:
        cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32, device=device))
        vol2cam = compose(inverse(cam), volp)
        cam2vol = compose(inverse(volp), cam)
        (rk6, ck6, mk6), _, err2, timing = check_faces(
            depth_m, col_packed, vol, vol2cam, params, intr, device, view,
            timed is not None and timed[0] == view)
        res["build_face"][0] = max(res["build_face"][0], float(err2))
        if timing is not None:
            res["build_face"][1:] = timing
        for f, frame_ in enumerate(fw.face_frames()):
            if frame_.name not in names:
                continue
            n_checked += 1
            timed_here = timed == (view, frame_.name)
            must_work = timed_here or timed is None or view != timed[0]
            tag = f"{view} {frame_.name}"
            rk, ck = rk6[f], ck6[f]
            if must_work and not bool(rk.any()):
                _fail(f"K2 {tag}: the face image is empty, so the comparison tested nothing")
            A, c_p = fw.face_geometry(vol2cam, frame_, params.volume_dims, vs)
            prm2 = fw.face_params(A, intr, on, fspec)

            # K3 on copies of the fused volume
            prm3 = fi.sweep_params(c_p, fw.primed_voxel_size(frame_, vs), fspec, params,
                                   mk6[f].float(), on, prm2, intr)
            dims_p = tuple(vol.tsdf.shape[a] for a in frame_.axes)
            table = fi.plane_table(fspec, prm3, dims_p)
            vk = TSDFVolume(*(a.clone() for a in vol))
            vp = TSDFVolume(*(a.clone() for a in vol))
            fi.sweep_face(vk, frame_, rk, ck, prm3, table)
            # the voxels updated and colour-mixed depend on the face stack and
            # the geometry only, so they hold for the timed sweeps below too
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
                res["face_integrate"][1] = ms(lambda: fi.sweep_face(vk, frame_, rk, ck, prm3,
                                                                    table))
                res["face_integrate"][2] = ms(
                    lambda: fi.sweep_face_plain(vp, frame_, rk, ck, prm3, table), reps=10,
                    warmup=1)
                off3 = prm3.clone()
                off3[11] = 0.0
                k3_off = ms(lambda: fi.sweep_face(vk, frame_, rk, ck, off3, table))
                # tsdf + weight (4 bytes) read and written where it updates,
                # colour (4 bytes) read and written where it mixes; the face
                # stack, the table and the parameters read once. Every voxel of
                # a plane's footprint is projected and tested for ownership
                # (the bound by every voxel of the admitted planes is printed
                # beside it).
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
                res["sweep_rays"][2] = ms(
                    lambda: fr.sweep_rays_plain(vol.tsdf, frame_, prm4, rspec), reps=10,
                    warmup=1)
                # each int16 voxel that a ray samples before it resolves, once;
                # a step for each plane that a live ray marches
                n_vox, n_steps = (int(c) for c in fr.sweep_rays_work(vol.tsdf, frame_, prm4,
                                                                     rspec))
                print(f"  K4 {tag}: the rays sample {n_vox} distinct voxels in {n_steps} "
                      f"ray-plane steps", flush=True)
                res["sweep_rays"][3:] = bound(2 * n_vox + nbytes(prm4, hk, bk),
                                              OPS["sweep_rays"] * n_steps)
                off4 = prm4.clone()
                off4[10] = 0.0
                print(f"  K4 {tag}: a gated-off call "
                      f"{ms(lambda: fr.sweep_rays(vol.tsdf, frame_, off4, rspec)):.4f} ms",
                      flush=True)

    print(f"  K2 bit-exact on {len(views)} views' six-face launches, K3 int16/int32 equal on "
          f"{n_checked} faces; K4 min mask agreement {min(k4_agree):.6f}, {k4_differ} rays with "
          f"other hit or back bits in all", flush=True)
    return res


def check_composite(state, views, params, intr, device, timed=None):
    """Phase 3, K5: the one-launch resample and composite of all six faces
    against its plain version, on each view of `views` [(tag, world-from-
    camera pose)]. The faces' fields come from K4 and face_fields, gated by
    faces_needed as the step gates them. The valid mask, the vertices and
    the normals must be equal (the count of values whose bits differ, a
    signed zero, is printed), and each view must have valid pixels. Times
    the view tagged `timed`. Returns [max_abs_err, ms, plain_ms, bound_ms,
    bound_by]."""
    import torch

    from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
    from kinfu_tpu_torch.ops import face_integrate as fi
    from kinfu_tpu_torch.ops import face_raycast as fr
    from kinfu_tpu_torch.ops import facewarp as fw

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ms = cuda_ms if device.type == "cuda" else (lambda fn, **k: float("nan"))
    volp = pose_from_matrix(torch.as_tensor(params.volume_pose, device=device))
    size, focal = params.raycast_face
    rspec = fr.RaySpec(int(size), float(focal))
    res = [0.0, float("nan"), float("nan"), float("nan"), ""]
    for tag, T in views:
        cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32, device=device))
        cam2vol = compose(inverse(volp), cam)
        gates = fi.faces_needed(compose(inverse(cam), volp), intr)
        prm = fr.composite_params(cam2vol, params)
        fields = [fr.sweep_and_shade(state.vol.tsdf, f, prm[k, 9:12], params, rspec, gates[k])
                  for k, f in enumerate(fw.face_frames())]
        args = ([t for t, _ in fields], [n for _, n in fields], prm, gates, intr, rspec)
        vk, nk, okk = fr.resample_composite(*args)
        vp, np_, okp = fr.resample_composite_plain(*args)
        sync()
        err = max(float((vk - vp).abs().max()), float((nk - np_).abs().max()))
        bits = int((vk.view(torch.int32) != vp.view(torch.int32)).sum()
                   + (nk.view(torch.int32) != np_.view(torch.int32)).sum())
        print(f"  K5 {tag}: faces gated on {gates.int().tolist()}, {int(okk.sum())} valid pixels "
              f"(plain {int(okp.sum())}); max |kernel - plain| {err:.3g}, {bits} values with "
              f"other bits", flush=True)
        res[0] = max(res[0], err)
        if not torch.equal(okk, okp) or err:
            _fail(f"K5 {tag}: the composite differs from the plain version")
        if not bool(okk.any()):
            _fail(f"K5 {tag}: no valid pixel, so the comparison tested nothing")
        if tag == timed:
            res[1] = ms(lambda: fr.resample_composite(*args))
            res[2] = ms(lambda: fr.resample_composite_plain(*args))
            # each face pixel an owned camera pixel samples, read once (t and
            # normal'); vertex, normal and valid written once a camera pixel;
            # per camera pixel the ownership test of every gated face and the
            # resample of its owner
            read = int(fr.resample_composite_work(prm, gates, intr, rspec.size, rspec))
            n_on = int(gates.sum())
            res[3:] = bound(16 * read + nbytes(prm, gates, vk, nk, okk),
                            okk.numel() * (OPS["resample_face_own"] * n_on
                                           + OPS["resample_face"]))
            print(f"  K5 {tag}: reads {read} face pixels; bound {res[3]:.4f} ms ({res[4]})",
                  flush=True)
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
                # the one-iteration form; check_icp_finish times the
                # finishing form, which the main path runs
                res[1] = ms(lambda: iw.icp_normal_eqs_warped(*args))
                res[2] = ms(lambda: iw.icp_normal_eqs_warped_plain(*args))
                print(f"  {tag}: one-iteration form {res[1]:.4f} ms, plain {res[2]:.4f} ms",
                      flush=True)
                # the current maps once, the model pixels gathered once
                gathered = int(iw.icp_normal_eqs_warped_work(inc, maps[0], maps[1], maps[2],
                                                             intr.level(level)))
                print(f"  {tag}: gathers {gathered} distinct model pixels", flush=True)
                res[3:] = bound(nbytes(maps[0], maps[1], A, b, n) + 24 * gathered,
                                OPS["icp_normal_eqs"] * maps[0].shape[0] * maps[0].shape[1])
    timed = check_icp_finish(cvs, cns, state, params, intr, device)
    if timed is not None:
        res[1:3] = timed
    return res


def check_icp_finish(cvs, cns, state, params, intr, device):
    """Phase 3, K1's finishing form: (a) one finishing launch at level 0
    against `finish_iteration` on the launch's own A and b, from a start
    pose that is not the identity and from the identity (pose within
    K1_FINISH_TOL, ok and count equal; the system bit-equal to the
    one-iteration form's); (b) the whole coarse-to-fine ICP, one host call,
    against `rigid_icp_plain` on the same maps (K1_ICP_TOL, ok equal,
    inliers within K1_ICP_INLIERS), 19 launches from one call; (c) a
    singular system (all-zero current normals): not ok, the identity.
    Times the whole ICP of a frame beside 19 one-iteration launches with the
    eager finish (the path before the finishing form) and the plain
    version, and prints the frame's bound: the sum of each launch's.
    Returns, on the card, (ms, plain ms) of one finishing launch at level 0
    from the small increment, the form of K1 the main path launches."""
    import torch

    from kinfu_tpu_torch.geometry.se3 import Pose, rodrigues
    from kinfu_tpu_torch.ops import icp_warped as iw
    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.tracking import icp as ticp

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ms = cuda_ms if device.type == "cuda" else (lambda fn, **k: float("nan"))
    sin_t = math.sin(math.radians(params.icp_angle_threshold))
    mv, mn = state.model_vmaps, state.model_nmaps
    lintr = intr.level(0)
    # the finishing form runs only on the card (its plain version is
    # finish_iteration after the plain normal equations)
    starts = {} if device.type != "cuda" else {"a start off the identity": Pose(
                  rodrigues(torch.tensor([0.002, -0.004, 0.001], device=device)),
                  torch.tensor([0.004, -0.002, 0.003], device=device)),
              "the identity": Pose(torch.eye(3, device=device), torch.zeros(3, device=device))}
    on = torch.ones((), dtype=torch.bool, device=device)
    for name, start in starts.items():
        system = (torch.empty((6, 6), device=device), torch.empty(6, device=device),
                  torch.empty((), dtype=torch.int32, device=device))
        st = iw.icp_solve_warped([(cvs[0], cns[0], mv[0], mn[0], lintr, 1)],
                                 params.icp_dist_threshold, sin_t,
                                 start=iw.state_block(start, on), system=system)
        pose_k, ok_k, n_k = iw.unpack_state(st)
        pose_p, ok_p, n_p = ticp.finish_iteration(*system, start, on)
        A1, b1, n1 = iw.icp_normal_eqs_warped(start, cvs[0], cns[0], mv[0], mn[0], lintr,
                                              params.icp_dist_threshold, sin_t)
        sync()
        dR = float((pose_k.R - pose_p.R).abs().max())
        dt = float((pose_k.t - pose_p.t).abs().max())
        same_sys = (torch.equal(system[0], A1) and torch.equal(system[1], b1)
                    and torch.equal(system[2], n1))
        print(f"  K1 finishing launch, level 0, {name}: |dR| {dR:.3g}, |dt| {dt:.3g} m against "
              f"finish_iteration; ok {bool(ok_k)} (plain {bool(ok_p)}); {int(n_k)} inliers "
              f"(plain {int(n_p)}); its system equals the one-iteration form's: {same_sys}",
              flush=True)
        if max(dR, dt) > K1_FINISH_TOL or bool(ok_k) != bool(ok_p) or int(n_k) != int(n_p) \
                or not same_sys or not bool(ok_k):
            _fail(f"K1 finishing launch from {name} differs from finish_iteration")
    timed = None
    if starts:
        start = starts["a start off the identity"]
        block = iw.state_block(start, on)
        one = [(cvs[0], cns[0], mv[0], mn[0], lintr, 1)]
        timed = (ms(lambda: iw.icp_solve_warped(one, params.icp_dist_threshold, sin_t,
                                                start=block)),
                 ms(lambda: ticp.finish_iteration(*iw.icp_normal_eqs_warped_plain(
                     start, cvs[0], cns[0], mv[0], mn[0], lintr, params.icp_dist_threshold,
                     sin_t), start, on)))
        print(f"  K1 finishing launch, level 0: {timed[0]:.4f} ms, plain (normal equations and "
              f"finish_iteration) {timed[1]:.4f} ms", flush=True)

    args = (cvs, cns, mv, mn, intr, params)
    kernels.reset_launch_counts()
    res = ticp.rigid_icp(*args)
    sync()
    launches = kernels.LAUNCHES["icp_normal_eqs"]
    plain = ticp.rigid_icp_plain(*args)
    sync()
    dR = float((res.pose.R - plain.pose.R).abs().max())
    dt = float((res.pose.t - plain.pose.t).abs().max())
    n_k, n_p = int(res.num_inliers), int(plain.num_inliers)
    iters = sum(params.icp_iters)
    print(f"  K1 whole ICP (one host call, {launches} launches): |dR| {dR:.3g}, |dt| {dt:.3g} m "
          f"against rigid_icp_plain; ok {bool(res.ok)} (plain {bool(plain.ok)}); {n_k} inliers "
          f"(plain {n_p}); |t| of the increment {float(plain.pose.t.norm()):.4g} m", flush=True)
    if max(dR, dt) > K1_ICP_TOL or bool(res.ok) != bool(plain.ok) or not bool(res.ok) \
            or abs(n_k - n_p) > K1_ICP_INLIERS * n_p \
            or launches != (iters * K1_PER_ITER if device.type == "cuda" else 0):
        _fail("K1's whole ICP differs from rigid_icp_plain, or did not launch once an iteration")

    zero = [torch.zeros_like(c) for c in cns]
    sing = ticp.rigid_icp(cvs, zero, mv, mn, intr, params)
    sync()
    ident = torch.equal(sing.pose.R, torch.eye(3, device=device)) and not bool(sing.pose.t.any())
    print(f"  K1 singular system (all-zero current normals): ok {bool(sing.ok)}, identity pose "
          f"{ident}, {int(sing.num_inliers)} inliers", flush=True)
    if bool(sing.ok) or not ident or int(sing.num_inliers) != 0:
        _fail("K1 on a singular system: tracking did not fail, or the pose moved")

    ms_k = ms(lambda: ticp.rigid_icp(*args))
    ms_eager = ms(lambda: ticp.icp_loop(*args, iw.icp_normal_eqs_warped))
    ms_plain = ms(lambda: ticp.rigid_icp_plain(*args), reps=5, warmup=1)
    # each launch: its current maps once, the model pixels it gathers once,
    # its system written; counted at the running pose of every iteration
    work = {"bytes": 0, "ops": 0}

    def counted(inc, cv, cn, pv, pn, li, dist, sin):
        out = iw.icp_normal_eqs_warped_plain(inc, cv, cn, pv, pn, li, dist, sin)
        work["bytes"] += (nbytes(cv, cn, *out) + iw.STATE_SIZE * 4
                          + 24 * int(iw.icp_normal_eqs_warped_work(inc, cv, cn, pv, li)))
        work["ops"] += OPS["icp_normal_eqs"] * cv.shape[0] * cv.shape[1]
        return out

    ticp.icp_loop(*args, counted)
    b_ms, b_by = bound(work["bytes"], work["ops"])
    print(f"  K1 whole ICP of a frame: {ms_k:.4f} ms in one call, {ms_eager:.4f} ms as {iters} "
          f"one-iteration launches with the eager finish, plain {ms_plain:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_by}, {work['bytes']} bytes over {iters} launches)", flush=True)
    return timed


def count_syncs(frames, params, intr, device) -> float:
    """Host synchronisations a step makes, per frame: kinfu_step over
    `frames` from a fresh state under torch.cuda's sync-debug mode "warn",
    counting its warnings (after two frames that build the step's constant
    caches). The mode sees the synchronising CUDA calls PyTorch makes
    (copies between host and device, reads of a device value); PyTorch
    calls it a prototype that may miss some."""
    import warnings

    import torch

    from kinfu_tpu_torch.pipeline.kinfu import init_state, kinfu_step

    dev = [(torch.as_tensor(d, device=device), torch.as_tensor(c, device=device))
           for d, c in frames]
    state = init_state(params, intr, device=device)
    for d, c in dev[:2]:
        state, _ = kinfu_step(state, d, c, params, intr)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for d, c in dev[2:]:
                state, _ = kinfu_step(state, d, c, params, intr)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                                if "called a synchronizing CUDA operation" in str(w.message))
    if where:
        print(f"    host syncs in {len(dev) - 2} steps, by the line that made them: "
              f"{dict(where)}", flush=True)
    return sum(where.values()) / (len(dev) - 2)


def run_orbit(frames, params, intr, device, no_sync: bool = False):
    """Phase 4: the tracked orbit through init_state + kinfu_step. With
    `no_sync`, each step runs under torch.cuda's sync-debug mode "error":
    any operation in it that synchronises the host with the device fails
    the run, naming the operation. Returns (poses [N,4,4], oks [N],
    inliers [N], per-frame ms [N], final state, launches)."""
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
    for k, (d, c) in enumerate(dev_frames):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            if no_sync:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, out = step(state, d, c)
            except RuntimeError as e:
                _fail(f"frame {k}: the step synchronised the host with the device: {e}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
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


def run_cli(frames, gt, ref_poses, params, intr, out_dir: Path, n: int):
    """Phase 5b: the orbit's first `n` frames written as a bundled dataset
    under `out_dir` through the port's writers (colour/*.png RGB8,
    depth/*.png u16 mm, intr.txt with c = 1000), then `python -m
    kinfu_tpu_torch run` on them as a subprocess on the card and
    `python -m kinfu_tpu_torch eval` of its poses against the ground truth;
    then a KinFuSession in this process over the same PNG frames, with the
    launch counts set to 0 just before. Fails unless the subprocesses exit
    0, every frame after the bootstrap tracks, the aligned ATE is <= 1 mm,
    the PLY holds at least SESSION_MIN_POINTS points, the session's poses
    are the CLI's within SESSION_POSE_TOL, and the session launched K2 and
    K5 once a frame. Returns the session's launches."""
    import shutil

    import torch

    from kinfu_tpu_torch.data.bundled import BundledDataset
    from kinfu_tpu_torch.io.images import write_color_png, write_depth_png
    from kinfu_tpu_torch.io.ply import read_ply
    from kinfu_tpu_torch.io.poses import (
        read_poses_reference_format,
        write_poses_reference_format,
    )
    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.pipeline.session import KinFuSession

    if out_dir.exists():
        shutil.rmtree(out_dir)
    data = out_dir / "data"
    (data / "color").mkdir(parents=True)
    (data / "depth").mkdir()
    for i, (depth, color) in enumerate(frames[:n]):
        write_color_png(str(data / "color" / f"{i:04d}.png"), color)
        write_depth_png(str(data / "depth" / f"{i:04d}.png"),
                        np.clip(np.rint(depth), 0, 65535).astype(np.uint16))
    (data / "intr.txt").write_text(f"{intr.fx} {intr.cx} {intr.fy} {intr.cy} 1000\n")
    write_poses_reference_format(str(out_dir / "gt.txt"), gt[:n])
    poses_f, ply_f, metrics_f = (out_dir / "poses.txt", out_dir / "cloud.ply",
                                 out_dir / "metrics.jsonl")

    def cli(*argv):
        cmd = [sys.executable, "-m", "kinfu_tpu_torch", *argv]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, timeout=600)
        print(f"    $ {' '.join(cmd[1:])}\n      exit {res.returncode} in "
              f"{time.perf_counter() - t0:.1f} s; {res.stdout.strip().splitlines()[-1:]}",
              flush=True)
        if res.returncode != 0:
            _fail(f"CLI: {' '.join(argv[:1])} exited {res.returncode}:\n{res.stderr[-3000:]}")
        return res.stdout

    cli("run", "--data", str(data), "--frames", str(n), "--save-poses", str(poses_f),
        "--save-ply", str(ply_f), "--metrics", str(metrics_f), "--quiet")
    ev = json.loads(cli("eval", "--est", str(poses_f), "--gt", str(out_dir / "gt.txt"))
                    .strip().splitlines()[-1])
    rows = [json.loads(line) for line in metrics_f.read_text().splitlines()]
    tracked = sum(bool(r["tracking_ok"]) for r in rows[1:])
    cli_poses = np.stack(read_poses_reference_format(str(poses_f)))
    pts = read_ply(str(ply_f))
    gap4 = float(np.abs(cli_poses - ref_poses[:n]).max()) if len(cli_poses) == n else np.inf
    print(f"    CLI: tracked {tracked}/{n - 1} after the bootstrap; eval {ev}; {len(pts)} points "
          f"in the PLY; max |pose - phase 4 pose| {gap4:.3g} (depth quantised to 1 mm)",
          flush=True)
    if len(rows) != n or tracked != n - 1 or len(cli_poses) != n:
        _fail(f"CLI: {len(rows)} frames run, {tracked}/{n - 1} tracked, {len(cli_poses)} poses")
    if ev["ate_rmse_m"] > ATE_MAX:
        _fail(f"CLI: aligned ATE {ev['ate_rmse_m'] * 1e3:.4f} mm > {ATE_MAX * 1e3} mm")
    if len(pts) < SESSION_MIN_POINTS:
        _fail(f"CLI: the PLY holds {len(pts)} points, fewer than {SESSION_MIN_POINTS}")

    ds = BundledDataset(str(data))
    sess = KinFuSession(ds.intrinsics, params.replace(fused_mode="on",
                                                      depth_scale=ds.intrinsics.depth_scale))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    oks = [sess.pipeline(*ds[i]) for i in range(n)]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    gap = float(np.abs(np.stack(sess.pose_record) - cli_poses).max())
    print(f"    session over the same PNG frames: {sum(oks)}/{n} ok, max |pose - CLI pose| "
          f"{gap:.3g}; launches {launches}", flush=True)
    if not all(oks) or gap > SESSION_POSE_TOL:
        _fail(f"CLI: the in-process session differs from the CLI's poses by {gap}")
    if launches.get("build_face") != n or launches.get("resample_face") != n:
        _fail(f"CLI: the session launched K2 {launches.get('build_face')} and K5 "
              f"{launches.get('resample_face')} times in {n} frames, not once a frame each")
    return launches


def profile_steps(frames, params, intr, device, out_path: str, ms_frame: float,
                  n: int = 10, first: int = 2, label: str = "orbit",
                  icp: bool = True) -> None:
    """Phase 6: torch.profiler over frames first..n-1 of a fresh run. Prints
    the kernels by device time, their sum per frame and its share of
    `ms_frame` (the step's time without the profiler), each port kernel's
    device time per frame and a launch (per frame, its longest launch and
    the median of the others: where one face is live, the active face and
    the gated-off ones), and writes the full table to `out_path`; with
    `icp`, then profiles the ICP of a frame alone (`profile_icp`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kinfu_tpu_torch.pipeline.kinfu import init_state, make_step_fn

    step = make_step_fn(params, intr)
    state = init_state(params, intr, device=device)
    dev = [(torch.as_tensor(d, device=device), torch.as_tensor(c, device=device))
           for d, c in frames[:n]]
    for d, c in dev[:first]:
        state, _ = step(state, d, c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for d, c in dev[first:]:
            state, _ = step(state, d, c)
        torch.cuda.synchronize()
    m = n - first
    wall = (time.perf_counter() - t0) * 1e3 / m
    # kernel events only: an operator's self device time repeats its kernels'
    ev = sorted((e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / m
    launches = sum(e.count for e in ev) / m
    print(f"[6] profile, {label}, frames {first}-{n - 1} of a fresh run: kernels busy "
          f"{busy:.3f} ms/frame in {launches:.0f} launches/frame; {busy / ms_frame:.1%} of the "
          f"{ms_frame:.3f} ms/frame step (device idle {1 - busy / ms_frame:.1%}); "
          f"{wall:.1f} ms/frame wall under the profiler", flush=True)
    for e in ev[:12]:
        print(f"      {e.self_device_time_total / 1e3 / m:9.3f} ms/frame "
              f"{e.count // m:5d}x  {e.key[:90]}", flush=True)
    launches_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for key, name, *_ in KERNELS:
        mine = sorted((e for e in launches_ev if f"{key}_kernel" in e.name),
                      key=lambda e: e.time_range.start)
        each = [e.time_range.elapsed_us() / 1e3 for e in mine]
        per = len(each) // m
        line = (f"    {name}: device {sum(each) / m:.4f} ms/frame in "
                f"{len(each) / m:.0f} launches/frame")
        if per > 1 and per * m == len(each):
            frames_ = [sorted(each[i * per:(i + 1) * per]) for i in range(m)]
            line += (f"; a launch: {float(np.median([f[-1] for f in frames_])):.4f} ms the "
                     f"longest of a frame, {float(np.median([t for f in frames_ for t in f[:-1]])):.4f}"
                     f" ms the others (medians)")
        print(line, flush=True)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=80, max_name_column_width=90))
    if icp:
        profile_icp(state, dev[-1][0], params, intr, device)


def profile_icp(state, depth, params, intr, device, n: int = 8) -> None:
    """Phase 6, the ICP of a frame alone: device time and launches a call of
    rigid_icp (K1's finishing form, one host call) and of the same ICP as
    one-iteration K1 launches with the eager finish, each over `n` calls on
    the measurement pyramid of `depth` against the model maps of `state`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kinfu_tpu_torch.frontend.maps import build_measurement_pyramid
    from kinfu_tpu_torch.ops import icp_warped as iw
    from kinfu_tpu_torch.tracking import icp as ticp

    p = params
    _, cvs, cns = build_measurement_pyramid(
        depth, intr, pyramid_height=p.pyramid_height,
        bfilter_kernel_size=p.bfilter_kernel_size, bfilter_color_sigma=p.bfilter_color_sigma,
        bfilter_spatial_sigma=p.bfilter_spatial_sigma, depth_scale=p.depth_scale,
        max_dist=p.dfilter_dist, normal_disc_threshold=p.normal_disc_threshold)
    args = (cvs, cns, state.model_vmaps, state.model_nmaps, intr, params)
    for name, fn in (("rigid_icp, one host call", lambda: ticp.rigid_icp(*args)),
                     ("one-iteration K1 launches with the eager finish",
                      lambda: ticp.icp_loop(*args, iw.icp_normal_eqs_warped))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in ev) / 1e3 / n
        launches = sum(e.count for e in ev) / n
        print(f"    ICP of a frame, {name}: device {busy:.4f} ms in {launches:.0f} launches",
              flush=True)


def gate_runs(gates: np.ndarray) -> str:
    """'1 face on frames 0-18 [+z]; 2 faces on frames 19-49 [+z, +x]': the
    runs of frames with the same faces gated on."""
    from kinfu_tpu_torch.ops.facewarp import face_frames

    names = [f.name for f in face_frames()]
    runs, start = [], 0
    for k in range(1, len(gates) + 1):
        if k == len(gates) or (gates[k] != gates[start]).any():
            on = [names[f] for f in np.nonzero(gates[start])[0]]
            runs.append(f"{len(on)} on frames {start}-{k - 1} {on}")
            start = k
    return "; ".join(runs)


def check_launches(launches, n: int, k1_want: int, where: str) -> None:
    """Every kernel launched on the run of `n` frames; K1 19 times a frame
    from one call, K2 (all six face stacks) and K5 (all six faces'
    composite) once a frame."""
    for key, name, *_ in KERNELS:
        if launches.get(key, 0) <= 0:
            _fail(f"{name} was not launched in {where}")
    if launches["icp_normal_eqs"] != k1_want:
        _fail(f"K1 launched {launches['icp_normal_eqs']} times in {where}, not {k1_want}")
    for key in ("build_face", "resample_face"):
        if launches[key] != n:
            _fail(f"{key} launched {launches[key]} times in {where}, not once a frame ({n})")


def run_corner(frames, gt, params, intr, device, res, k1_want: int, smi: str) -> float:
    """Phase 4b: bench.py --corner's 50 frames through init_state +
    kinfu_step, each step under sync-debug mode "error". Fails unless every
    frame after the first tracks, the aligned ATE is <= 1 mm, K1 launches
    19 times a frame and K2 and K5 once, and a +-x face is gated on in some
    frame; prints the gap to the JAX package's golden poses and the faces
    gated on at each frame. Then holds K2 (six faces, one launch), K3 and
    K4 on every live face, and K5's composite against their plain versions
    at the last frame's tracked pose on the volume the run fused, where two
    faces are live, adding their largest errors to `res`. Returns the
    run's ms/frame."""
    import torch

    from kinfu_tpu_torch.eval.ate import ate_rmse
    from kinfu_tpu_torch.io.poses import read_poses_reference_format
    from kinfu_tpu_torch.ops.facewarp import face_frames

    n = len(frames)
    print(f"[4b] corner orbit (bench.py --corner): {n} frames through init_state + kinfu_step, "
          f"each step under sync-debug mode \"error\"", flush=True)
    poses, oks, inliers, frame_ms, state, launches = run_orbit(frames, params, intr, device,
                                                               no_sync=True)
    gates = face_gates(poses, oks, params, intr, device)
    ate = ate_rmse(list(poses), gt)
    ate_raw = ate_rmse(list(poses), gt, align=False)
    golden = read_poses_reference_format(str(GOLDEN_CORNER))[:n]
    gap = max(float(np.linalg.norm(p[:3, 3] - g[:3, 3])) for p, g in zip(poses, golden))
    ms_frame = float(np.median(frame_ms[2:])) if frame_ms is not None else float("nan")
    x_faces = [f for f, fr in enumerate(face_frames()) if fr.name.endswith("x")]
    x_frames = int(gates[:, x_faces].any(axis=1).sum())
    print(f"    tracked {int(oks[1:].sum())}/{n - 1} frames after bootstrap; inliers at the last frame "
          f"{int(inliers[-1])}; ATE vs exact ground truth: aligned {ate * 1e3:.4f} mm, raw "
          f"{ate_raw * 1e3:.4f} mm; max translation gap to {GOLDEN_CORNER.name} "
          f"{gap * 1e3:.4f} mm (printed, not gated)", flush=True)
    print(f"    {ms_frame:.3f} ms/frame (median of frames 2-{n - 1}, CUDA events) on {smi}",
          flush=True)
    print(f"    faces gated on a frame: {gate_runs(gates)}; K3 active launches a frame: "
          f"{np.bincount(gates.sum(axis=1)).tolist()} frames with 0, 1, 2, ... live faces; "
          f"a +-x face on {x_frames} frames", flush=True)
    print(f"    launches: {launches}; a frame: "
          f"{ {k: v / n for k, v in sorted(launches.items())} }", flush=True)
    if not oks[1:].all() or not np.isfinite(poses).all():
        _fail(f"corner orbit: tracking failed at frames {np.nonzero(~oks[1:])[0] + 1}")
    if ate > ATE_MAX:
        _fail(f"corner orbit: aligned ATE {ate * 1e3:.4f} mm > {ATE_MAX * 1e3} mm")
    check_launches(launches, n, k1_want, "the corner orbit")
    if not x_frames or not gates.sum(axis=1).all():
        _fail("corner orbit: no +-x face was gated on, or a frame had no live face")

    T = poses[-1]
    live = tuple(fr.name for f, fr in enumerate(face_frames()) if gates[-1, f])
    print(f"    kernels against their plain versions at frame {n - 1}'s tracked pose, on the "
          f"volume the corner orbit fused; live faces {list(live)}:", flush=True)
    if len(live) < 2:
        _fail(f"corner orbit: frame {n - 1} has live faces {live}, not two")
    got = check_kernels(state, frames[-1], [("corner", T, live)], params, intr, device)
    got["resample_face"] = check_composite(state, [("corner", T)], params, intr, device)
    for key, r in got.items():
        res[key][0] = max(res[key][0], r[0])
    del state
    torch.cuda.empty_cache()
    return ms_frame


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-table", metavar="PATH", default=str(PROFILE_TABLE),
                    help="where to write the full profiler table (default: %(default)s)")
    ap.add_argument("--count-syncs", action="store_true",
                    help="only count the host syncs of a step (frames 2-5 of the orbit, "
                         "under sync-debug mode \"warn\") and exit, printing no result")
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
    if args.count_syncs:
        frames, _ = orbit_frames(6, intr)
        print(f"host syncs a step: {count_syncs(frames, params, intr, device):g} "
              f"(frames 2-5 of the orbit)", flush=True)
        return
    n = ORBIT_FRAMES
    t0 = time.perf_counter()
    # one frame more than the orbit: the session resumes from its checkpoint on it
    frames, gt = orbit_frames(n + 1, intr)
    c_frames, c_gt = corner_frames(n, intr)
    print(f"    rendered {n + 1} orbit and {n} corner-orbit frames {intr.width}x{intr.height} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
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
    from kinfu_tpu_torch.ops.facewarp import face_frames

    names = tuple(f.name for f in face_frames())
    inside = [(f"inside {f.name}", inside_view(f, params)) for f in face_frames()]
    res = {"icp_normal_eqs": check_icp(state, frames[3], params, intr, device)}
    res.update(check_kernels(state, frames[3],
                             [("orbit", gt[3], names)]
                             + [(tag, T, (tag.split()[1],)) for tag, T in inside],
                             params, intr, device, timed=("orbit", "+z")))
    res["resample_face"] = check_composite(state, [("orbit", gt[3])] + inside, params, intr,
                                           device, timed="orbit")
    del state
    torch.cuda.empty_cache()

    syncs = count_syncs(frames[:6], params, intr, device)
    print(f"[4] orbit: {n} frames through init_state + kinfu_step, icp_mode="
          f"{params.icp_mode!r}, each step under sync-debug mode \"error\"; host syncs a "
          f"step: {syncs:g} (counted over 4 steps under \"warn\")", flush=True)
    poses, oks, inliers, frame_ms, state, launches = run_orbit(frames[:n], params, intr, device,
                                                               no_sync=True)
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
    print(f"    launches in the orbit: {launches}; a frame: "
          f"{ {k: v / n for k, v in sorted(launches.items())} }", flush=True)
    print(f"    faces gated on a frame: {gate_runs(face_gates(poses, oks, params, intr, device))}",
          flush=True)
    if ate > ATE_MAX:
        _fail(f"aligned ATE {ate * 1e3:.4f} mm > {ATE_MAX * 1e3} mm")
    check_launches(launches, n, k1_want, "the orbit")
    if syncs:
        _fail(f"the step synchronised the host {syncs:g} times a frame")

    gather = params.replace(icp_mode="gather")
    g_poses, g_oks, _, g_ms, g_state, g_launches = run_orbit(frames[:GATHER_FRAMES], gather,
                                                             intr, device, no_sync=True)
    del g_state
    g_gap = float(np.abs(g_poses - poses[:GATHER_FRAMES]).max())
    print(f"    gather leg: {GATHER_FRAMES} frames with icp_mode='gather', each step under "
          f"sync-debug mode \"error\", tracked {int(g_oks[1:].sum())}/{GATHER_FRAMES - 1}; "
          f"max |pose - warped pose| {g_gap:.3g}; launches {g_launches}", flush=True)
    print(f"    frames 2-{GATHER_FRAMES - 1}, median ms/frame (CUDA events): gather "
          f"{float(np.median(g_ms[2:])):.3f}, warped {float(np.median(frame_ms[2:GATHER_FRAMES])):.3f} "
          f"(warped ran first)", flush=True)
    if not g_oks[1:].all() or g_launches.get("icp_normal_eqs", 0) != 0:
        _fail("the gather leg lost tracking or launched K1")
    torch.cuda.empty_cache()

    c_ms = run_corner(c_frames, c_gt, params, intr, device, res, k1_want, smi)

    print(f"[5] session: {n} frames through KinFuSession (default device)", flush=True)
    s_launches, s_host_ms = run_session(frames, gt, poses, params, intr, SESSION_OUT)
    if s_launches["icp_normal_eqs"] != k1_want:
        _fail(f"K1 launched {s_launches['icp_normal_eqs']} times in the session, not {k1_want}")
    torch.cuda.empty_cache()
    print(f"[5b] CLI: the first {CLI_FRAMES} orbit frames as a bundled dataset under "
          f"{CLI_OUT.relative_to(REPO)}, through python -m kinfu_tpu_torch run and eval",
          flush=True)
    run_cli(frames, gt, poses, params, intr, CLI_OUT, CLI_FRAMES)
    torch.cuda.empty_cache()

    for key, name, *_ in KERNELS:
        err, ms, plain_ms, bound_ms, bound_by = res[key]
        print(f"    {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), max abs err {err:.3g}, {launches[key] / n:g} launches a frame  "
              f"[{smi}]", flush=True)
    profile_steps(frames[:n], params, intr, device, args.profile_table, ms_frame)
    profile_steps(c_frames, params, intr, device, str(Path(args.profile_table).with_suffix(
        ".corner.txt")), c_ms, n=28, first=20, label="corner orbit (two faces live)", icp=False)

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
