#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kinfu_tpu_torch) on one NVIDIA GPU.

Phases; any failure exits non-zero before the result line:
  1. report the card (torch and nvidia-smi);
  2. build the CUDA kernels of kinfu_tpu_torch/csrc from this checkout: the
     normal build and the bounds-checked one of phase 7, every nvcc at once;
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
     it); R1 face_fields, the shading of all six faces in one launch, on
     the orbit's view and the six centre views, every face swept and with
     the step's gates (t and valid bit for bit, normals within 1e-6, none
     flipped), timed eagerly and replayed from a CUDA graph beside its byte
     bound; K5 resample_face, the resample and composite of all six faces in
     one launch, on the same views; K3's and
     K4's time for a gated-off call, K3's footprint voxels beside the voxels
     of its admitted planes, and K4's count of rays whose hit or back bits
     differ from the plain version's (no profiler before phase 6: once
     started in a process it slows every later launch);
  3c. kinfu_tpu_torch/tools/raycast_parity_probe.py at 512^3 / 640x480: one
     frame fused at the identity pose, the warped raycast (K4 and K5)
     against the unit-step march; prints its JSON line and fails where the
     march hits 1% of the pixels or more that the sweep misses (the
     reference's target, DIVERGENCES.md item 20);
  4. count the host syncs of a step (sync-debug mode "warn"), then run the
     50-frame orbit of bench.py (640x480, fx=fy=525, 512^3 over 3 m,
     3-level pyramid, ICP (4,5,10), icp_mode="auto", which is the warped ICP
     kernel K1 on the card) through init_state + kinfu_step with the launch
     counts set to 0 just before, each step under sync-debug mode "error"
     (a host sync in the step fails the run); every frame after the first
     must track, the aligned ATE against exact ground truth must be <= 1 mm,
     K1 must launch 19 times a frame, K2, R1 and K5 once, every other kernel
     at least once; the same frames through tools/accuracy_run.py's `track`
     and `metrics`, whose ATE must equal the orbit's; then 10 frames with
     icp_mode="gather", also under sync-debug mode "error", which must
     track without launching K1;
  4b. the corner orbit of bench.py --corner (the orbit yawed 50 degrees
     through the corner-facing scene), 50 frames under sync-debug mode
     "error", with the orbit's checks, the gap to the JAX package's golden
     poses and the faces gated on at each frame (a +-x face must be live on
     some frames); then K2-K5 against their plain versions at its last
     frame, where the +z and +x faces are live;
  4c. the orbit's 50 frames through kinfu_step with fused_mode="off" (the
     integrate and raycast dispatchers on K2 + K3 and K4 + R1 + K5, the
     raycast gated by its cam2vol face flags), each step under
     sync-debug mode "error": every frame after the first tracks, the
     aligned ATE is <= 1 mm, the poses are within 1e-4 m of phase 4's fused
     ones, a frame launches K1 19 times, K2, R1 and K5 once, K3 and K4 six
     times each; prints the frames where the cam2vol and vol2cam face sets
     differ;
  4e. the march raycasts, which JAX runs outside Pallas and the port on
     two kernels of its own, one thread a ray: M1 (csrc/march_rays.cu, the
     step march) and M2 (csrc/march_hier.cu, the two-level march). M1, its
     Z-slab form (an interior slab of phase 4d's four, halo-padded, with
     per-ray k_start and t_end) and M2 against their plain twins on phase
     4's final volume at frame 49's pose: events bit for bit, CUDA-event
     times and bounds (the distinct voxels and cells and the operations
     the rays need); then the orbit's 50 frames with
     fused_mode="off" and raycast_mode "hier", then "step", and 20 frames
     at 320^3 with "auto" (which must resolve to "hier": the gather
     integrate and M2), each with no host sync a step (sync-debug "warn",
     frames 2-5) and every step under "error": every frame after the
     first tracks, the orbits' aligned ATE is <= 1 mm, and a frame
     launches M2 or M1 once; then four cameras inside the volume,
     tests/test_pallas_integrate.py:249's 170 degrees about y and three
     that look along -x (yaw -100 degrees), -y and +y (pitch +-90), each one
     frame fused through the fused step's update and raycast through M2
     and through the warped path: the view's face (-z, -x, -y, +y) is live
     in the fusion and the raycast, no face gated off writes, and the
     march hits under 1% of the pixels that the sweep misses;
  4f. `python -m kinfu_tpu_torch bench` and `bench --corner`
     (kinfu_tpu_torch/bench.py, the port of bench.py) as subprocesses at
     their defaults (640x480, 512^3, 20 + 2 frames): each exits 0 and
     prints one JSON line with exactly bench.py's keys and metric name and
     a finite value > 0 (printed with its stderr diagnostics beside phase
     4's and 4b's ms/frame); `bench.run` over the long run in this process
     with its loop under sync-debug mode "error" (no host sync, every
     frame after the first tracks); and the bench's slower paths
     (--integrate gather, --raycast hier and step, --fused off) in this
     process at 5 frames;
  5. the same 50 frames through KinFuSession with its default device, numpy
     frames in, the counts set to 0 just before: every frame tracks, the
     aligned ATE is <= 1 mm, the pose record agrees with phase 4's, K1
     launches 19 times a frame, K2, R1 and K5 once; the
     Phong render, the point cloud, the PLY and pose files, and a
     checkpoint that is loaded and tracks one more frame;
  5b. the first 20 orbit frames written as a bundled dataset (PNGs and
     intr.txt) through the port's writers, then `python -m kinfu_tpu_torch
     run` and `eval` on it as subprocesses on the card: every frame tracks,
     the aligned ATE is <= 1 mm, the PLY has enough points, and a session
     in this process over the same PNGs gives the CLI's poses, launching K2
     and K5 once a frame; then `run --relocalize` and `run --pose-graph` on
     the same PNGs (every frame tracks, the aligned ATE is <= 1 mm, the
     summary line gives the keyframe and closure counts);
  5c. KinFuSession(relocalize=True) over orbit frames 0-29, two all-zero
     frames (both fail, each a step with the map kept and a relocalize_step
     whose ICP fails; the volume's bits and weight count unchanged), frame
     29 again (recovered within 0.02 m, the record one longer, the path
     that recovered printed), a direct relocalize_step seeded from the
     keyframe nearest a pose 5 cm and 3 degrees off frame 29's under
     sync-debug mode "error" (recovered within 0.02 m; K1 19, K4 12, K5 2,
     K2 1, K3 6 launches) and on an all-zero frame (the volume's bits
     unchanged), then frames 30-49 (aligned ATE over the record <= 1 mm);
  5d. the out-and-back loop of tests/test_mapping.py at this width through
     KinFuSession(pose_graph=True) beside a plain session: a closure
     against a non-adjacent keyframe fires, the rebuild launches K2 and K3
     once per re-fused frame and the warped raycast once, the corrected
     ATE is <= 1 mm and the map error no worse than the plain session's x
     1.05; then every keyframe pose shifted 0.12 m and the map rebuilt:
     the fused sphere sits on the shifted sphere;
  5e. the corridor of tests/test_session.py::test_streaming_corridor_scale
     (100 frames walking 1.386 m along +z through the orbit's scene, at this
     width) through kinfu_step, the fixed volume, then through the streaming
     step (the grid follows the camera, pipeline/streaming.py), fused and
     with fused_mode="off", each step under sync-debug mode "error", then
     through KinFuSession(streaming=True): every frame after the first
     tracks; the grid shifts (the frames are printed); the streaming
     poses before the first shift are the fixed volume's bit for bit, and
     within 1e-4 m of them on the frames after it; shift_volume on the
     last volume equals a slice copy on the card (and the CPU's
     shift_volume) bit for bit, for a shift along each axis; S1, the
     in-place shift kernel (csrc/shift_volume.cu, `shift_volume_`), on a
     copy of that volume and of a 1037x7x5 one (X odd, several chunks of
     its x pass) equals shift_volume on the card bit for bit for
     +-1..3 voxels along each axis, a three-axis shift, zero and two wipes,
     3 launches a call, its counter counting the calls and the moves, and
     is timed replayed from a CUDA graph beside its byte bound (also alone,
     on a seeded random 512^3 volume: --shift); the
     aligned ATE is <= 1 mm (or within 1.1x the fixed volume's where that
     exceeds 1 mm); K1 launches 19 times a frame, K2 and K5 once, K3 and K4
     six times, S1 three; the streaming step makes no host sync ("warn"); the
     non-fused run gives the fused one's grid offsets and its poses within
     1e-4 m; the session gives the step's poses and offset, a point cloud
     inside the moved volume, a 3D view and a checkpoint that loads with
     its offset and tracks the next frame; prints one grid shift's time
     beside its bound and the streaming step's ms/frame beside the orbit's;
  5f. (run after 5e) the session's step replayed from CUDA graphs
     (pipeline/graphed.py): a graphed and an eager KinFuSession side by
     side on the benchmark's configurations and mixes (kfbench/), the
     orbit on kinfu-pcl-512 (50 frames) and the corridor on
     kinfu-stream-512 (until the grid has shifted on 100 frames), each then
     a blank depth frame (tracking fails; the state is reset on the
     device), 10 frames, `reset()` and 4 frames: the tracking flags, poses,
     model maps, volume, frame count, grid origin and kernel launch counts
     equal bit for bit at every frame, one capture a session, and a traced
     replayed frame launching one graph a segment, whose operations copy
     nothing from the host (also alone: --graphs);
  4d. (run after 5f, before the profiler) the sharded step on the one card.
     In this process, the shard forms against their plain versions at the
     main path's shapes, on the 512^3 volume of frames 0-2 cut into 4 Z
     slabs and 4 Y slabs: K2 and K3 on each slab with its origin folded
     into the pose, bit for bit (the Y slabs' +-x faces in the (2, 1, 0)
     frame), K4 on each halo-padded slab (hit bits equal, back events by
     phase 3's rule) and the ranks' minimum against the unsharded K4 (at
     most 0.1% of a face's rays may differ), on the orbit view and the six
     centre views, then R1 on the orbit view's six reduced events [6, 2, F,
     F] as a rank shades them, against face_fields_plain; K1's
     one-iteration form on each of 4 row shards of every level, and their
     sum against the whole; CUDA-event times of the shard
     forms beside the unsharded launches, and their bounds. K3's shard form
     where a sweep's planes pass 48 KB of shared memory: 4 Y slabs of
     6144x16x256 (the cell shard.big-orbit's planes and voxel) fusing
     frames 3 and 4, every face, bit for bit (also alone: --deep-slab).
     Then 4 ranks
     on the card (gloo, "spawn" processes that load the kernels phase 2
     built) run the orbit's 50 frames Z-sharded and Y-sharded through the
     fused sharded step, and 10 frames Z-sharded with fused_mode="off":
     every frame after the first tracks, the aligned ATE is <= 1 mm, each
     rank launches K1 19 times a frame, K2, R1 and K5 once, K3 and K4 six
     times; each leg's step of frames 10, 30 and 45 from phase 4's state of
     the frame before gives phase 4's pose within 1e-6 m and its ICP inlier
     count within 0.01%, and the gathered volume and model map of frame 30
     agree with phase 4's (tests/test_distributed.py's tolerances); 10 more
     non-fused Z-sharded frames with raycast_mode "step" march the slabs
     (M1's Z-slab form, once a frame a rank, in place of K4 and K5; their
     frame-30 model maps must equal the single-device "step" raycast of
     the gathered volume on every pixel, and are printed against phase
     4's warped ones); prints
     the free-running poses' gap to phase 4's (4c's), the collectives and
     bytes a frame and the host syncs of steps 2-4 under sync-debug
     "warn" (and, with --profile-table, rank 0's kernels under
     torch.profiler). Then `python -m
     kinfu_tpu_torch sweep --devices 2` over two copies of phase 5b's PNGs:
     each sequence's poses are phase 5b's session's;
  6. (through kinfu_tpu_torch/tools/trace_step.py) profile 8 steps of a
     fresh run of the orbit: kernel time per frame,
     each port kernel's device time per frame and a launch (per frame, its
     longest launch, the active face, and the others, gated off), and the
     device's idle share (the full table goes to --profile-table); then the
     device time and launches of the ICP of a frame alone, one host call
     against one-iteration launches with the eager finish; then 8 steps of
     the corner orbit where two faces are live (frames 20-27); then 8 steps
     of the non-fused orbit, one relocalize_step call, and 8 steps of the
     streaming corridor over frames where the grid shifts (90-97) (S1's
     own time is phase 5e's);
  7. the sanitizer pass (kinfu_tpu_torch/tools/sanitize.py) in child
     processes, in the bounds-checked build of the kernels that phase 2
     built beside the normal one (compute-sanitizer refuses this card's
     machine): every form of K1-K5 and R1, the shard forms, M1 (both forms)
     and M2 at the main path's
     shapes and at test scale must run without a fault and launch each
     kernel; then K5 with a vertex buffer one row short must trap;
  7b. the stand-in for compute-sanitizer's racecheck, initcheck and
     synccheck (sanitize.py --repeat, a child process, the normal build):
     every form of phase 7 at the main path's shapes launched 20 times on
     the same inputs, every output and K1's partial sums filled with one
     of four sentinel bytes before each launch, must give the same bits
     every time, K1's ticket must read 0 after each, and K1 (at 131
     blocks) and K3 (on a 61-block persistent grid) launched 20 times more
     on a second grid must give the same bits (K1: one iteration the same
     counts and floats within 1e-4 of their largest entry, the finishing
     form its pose within 1e-6 and its counts within 0.01%, as K1's row
     shards in phase 4d);
  8. print one JSON line describing the kernels, the shard forms and M1
     and M2 (with
     each kernel's launches on every path this script drives, the sharded
     ones summed over the ranks), then the card, then the result line.

Usage: python3 chip_smoke.py [--profile-table PATH] [--count-syncs] [--graphs] [--deep-slab]
                            [--shift]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
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
    ("face_fields", "R1 face_fields", "kinfu_tpu_torch/csrc/face_fields.cu",
     "kinfu_tpu/ops/pallas_raycast.py:482 (_face_fields, XLA outside Pallas)"),
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
#: the non-fused step's poses against the fused step's (metres)
NONFUSED_POSE_TOL = 1e-4
#: relocalization: the recovered translation against ground truth
#: (metres), the bound of tests/test_mapping.py:221-223
RELOC_TOL = 0.02
#: orbit frames the relocalization phase tracks before the loss
RELOC_FRAMES = 30

#: NVIDIA H100 SXM peaks (data sheet): HBM bytes/s and float32 FLOP/s
#: outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
#: float32 operations per work item, counted from each kernel's source and
#: rounded up: K1 per current pixel; K2 per level-0 pixel of a live face; K3 per voxel of
#: a plane's footprint (projection and ownership), per voxel it updates and
#: per voxel whose colour it mixes; K4 per ray-plane step; K5 per camera
#: pixel and gated face (the primed ray and the ownership test) and per
#: camera pixel (its owner's resample and unprime); R1 per face pixel (the
#: sums, the vertex, the cross product, two norms, the flip and the fill)
OPS = {"icp_normal_eqs": 150, "build_face": 40, "face_integrate_gate": 24,
       "face_integrate_update": 24, "face_integrate_colour": 20, "sweep_rays": 15,
       "resample_face_own": 20, "resample_face": 40, "face_fields": 120}
#: R1 against face_fields_plain: normals within this (the plain version's
#: torch kernels contract products into fused multiply-adds, R1 does not);
#: t and valid bit for bit
R1_N_TOL = 1e-6


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
           for k, *_ in KERNELS if k not in ("icp_normal_eqs", "resample_face", "face_fields")}
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


def check_shading(hits, backs, prm, rspec, tag: str, device, timed: bool = False):
    """R1 (`face_fields`, every face in one launch) against
    `face_fields_plain` face by face on the same events: t and valid bit
    for bit, normals within R1_N_TOL and none flipped (printed: the
    normals past 1e-9 and the flips), and some valid pixel. With `timed`,
    times R1 and the plain version (CUDA events: one eager call, and
    replayed from a CUDA graph as the step replays them) beside R1's byte
    bound (hit and back read, t, n and valid written once). Returns
    [max |n gap|, ms, plain_ms, bound_ms, bound_by, graph_ms,
    plain_graph_ms]."""
    import torch

    from kinfu_tpu_torch.ops import face_raycast as fr

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    nan = float("nan")

    def plain():
        fields = [fr.face_fields_plain(h, b, prm[f, 9:12], rspec)
                  for f, (h, b) in enumerate(zip(hits, backs))]
        return tuple(torch.stack(x) for x in zip(*fields))

    tk, nk, vk = fr.face_fields(hits, backs, prm, rspec)
    tp, np_, vp = plain()
    sync()
    t_bits = int((tk.view(torch.int32) != tp.view(torch.int32)).sum())
    v_diff = int((vk != vp).sum())
    gap = (nk - np_).abs()
    err = float(gap.max())
    past = int((gap > 1e-9).any(-1).sum())
    flips = int(((nk * np_).sum(-1) < 0).sum())
    print(f"  R1 {tag}: {int(vk.sum())} valid face pixels (plain {int(vp.sum())}); {t_bits} t "
          f"values with other bits, {v_diff} valid flags differ; normals: max |R1 - plain| "
          f"{err:.3g}, {past} past 1e-9, {flips} flipped", flush=True)
    if t_bits or v_diff or not err <= R1_N_TOL or flips:
        _fail(f"R1 {tag}: the shading differs from face_fields_plain")
    if not bool(vk.any()):
        _fail(f"R1 {tag}: no valid face pixel, so the comparison tested nothing")
    res = [err, nan, nan, nan, "", nan, nan]
    if timed and device.type == "cuda":
        res[1] = cuda_ms(lambda: fr.face_fields(hits, backs, prm, rspec))
        res[2] = cuda_ms(plain, reps=10, warmup=1)
        res[3:5] = bound(nbytes(*hits, *backs, tk, nk, vk), OPS["face_fields"] * tk.numel())
        for k, fn in ((5, lambda: fr.face_fields(hits, backs, prm, rspec)), (6, plain)):
            fn()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            res[k] = cuda_ms(graph.replay)
            del graph
        print(f"  R1 {tag}: kernel {res[1]:.4f} ms (one call), {res[5]:.4f} ms replayed from a "
              f"CUDA graph; plain {res[2]:.4f} ms, {res[6]:.4f} ms replayed; bound "
              f"{res[3]:.4f} ms ({res[4]})", flush=True)
    return res


def check_composite(state, views, params, intr, device, timed=None):
    """Phase 3, R1 and K5, on each view of `views` [(tag, world-from-camera
    pose)]: R1's shading of all six faces against its plain version
    (`check_shading`) on K4's events of every face and of the faces gated
    by faces_needed as the step gates them; then K5's one-launch resample
    and composite of the six faces against its plain version, on R1's
    fields of the step's gates. The valid mask, the vertices and the
    normals must be equal (the count of values whose bits differ, a signed
    zero, is printed), and each view must have valid pixels. Times the
    view tagged `timed`. Returns {"face_fields": R1's record,
    "resample_face": [max_abs_err, ms, plain_ms, bound_ms, bound_by]}."""
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
    r1 = [0.0] + [float("nan")] * 3 + [""] + [float("nan")] * 2
    every = torch.ones(fw.FACES, dtype=torch.bool, device=device)
    for tag, T in views:
        cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32, device=device))
        cam2vol = compose(inverse(volp), cam)
        gates = fi.faces_needed(compose(inverse(cam), volp), intr)
        prm = fr.composite_params(cam2vol, params)
        for on, label in ((every, "every face swept"), (gates, f"gates {gates.int().tolist()}")):
            events = fr.sweep_faces(state.vol.tsdf, prm, params, rspec, on)
            timed_here = tag == timed and on is every
            got = check_shading(*events, prm, rspec, f"{tag}, {label}", device, timed_here)
            r1[0] = max(r1[0], got[0])
            if timed_here:
                r1[1:] = got[1:]
        t_f, n_f, _ = fr.face_fields(*events, prm, rspec)
        args = (t_f.unbind(0), n_f.unbind(0), prm, gates, intr, rspec)
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
    return {"face_fields": r1, "resample_face": res}


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


def step_syncs(frames, params, intr, device, streaming: bool = False) -> dict:
    """Host synchronisations, kernel launches and CUDA-event ms of a step,
    per frame: kinfu_step (with `streaming`, streaming_step) over `frames`
    from a fresh state under torch.cuda's sync-debug mode "warn", counting
    its warnings (after two frames that build the step's constant caches).
    The mode sees the synchronising CUDA calls PyTorch makes (copies
    between host and device, reads of a device value); PyTorch calls it a
    prototype that may miss some. Returns {"syncs", "launches" (per kernel),
    "ms" (median), "frames"}; the times include the mode's warnings."""
    import warnings

    import torch

    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.pipeline.kinfu import init_state, kinfu_step

    if streaming:
        from kinfu_tpu_torch.pipeline.streaming import init_streaming_state, streaming_step

        init_state, kinfu_step = init_streaming_state, streaming_step
    dev = [(torch.as_tensor(d, device=device), torch.as_tensor(c, device=device))
           for d, c in frames]
    state = init_state(params, intr, device=device)
    for d, c in dev[:2]:
        state, _ = kinfu_step(state, d, c, params, intr)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for d, c in dev[2:]:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                state, _ = kinfu_step(state, d, c, params, intr)
                b.record()
                times.append((a, b))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n = len(dev) - 2
    where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                                if "called a synchronizing CUDA operation" in str(w.message))
    if where:
        print(f"    host syncs in {n} steps, by the line that made them: "
              f"{dict(where)}", flush=True)
    return {"syncs": sum(where.values()) / n,
            "launches": {k: v / n for k, v in sorted(kernels.LAUNCHES.items())},
            "ms": float(np.median([a.elapsed_time(b) for a, b in times])), "frames": n}


def run_orbit(frames, params, intr, device, no_sync: bool = False, origins=None):
    """Phase 4: the tracked orbit through init_state + kinfu_step. With
    `no_sync`, each step runs under torch.cuda's sync-debug mode "error":
    any operation in it that synchronises the host with the device fails
    the run, naming the operation. With a list `origins`, the frames go
    through init_streaming_state + streaming_step instead (the session's
    margin), and each frame's grid offset (`origin_vox`, numpy int32 [3])
    is appended to it. Returns (poses [N,4,4], oks [N], inliers [N],
    per-frame ms [N], final state, launches)."""
    import torch

    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.pipeline.kinfu import init_state, make_step_fn

    dev_frames = [(torch.as_tensor(d, device=device), torch.as_tensor(c, device=device))
                  for d, c in frames]
    if origins is None:
        step = make_step_fn(params, intr)
        state = init_state(params, intr, device=device)
    else:
        from kinfu_tpu_torch.pipeline.streaming import (
            init_streaming_state,
            make_streaming_step_fn,
        )

        step = make_streaming_step_fn(params, intr)
        state = init_streaming_state(params, intr, device=device)
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
        if origins is not None:
            origins.append(state.origin_vox)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if origins is not None:
        origins[:] = [o.cpu().numpy() for o in origins]
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
    oks, frame_ms = [], []
    for d, c in frames[:n]:
        t0 = time.perf_counter()
        oks.append(sess.pipeline(c, d))
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    sync()
    launches = dict(kernels.LAUNCHES)
    if not all(oks):
        _fail(f"session: tracking failed at frames {[k for k, ok in enumerate(oks) if not ok]}")
    record = np.stack(sess.pose_record)
    gap = float(np.abs(record - ref_poses).max()) if record.shape == ref_poses.shape else np.inf
    ate = ate_rmse(list(record), gt[:n])
    host_ms = float(np.median(frame_ms[2:]))
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
    K5 once a frame. Returns the session's launches and pose record."""
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
    if launches.get("build_face") != n or launches.get("resample_face") != n \
            or launches.get("face_fields") != n:
        _fail(f"CLI: the session launched K2 {launches.get('build_face')}, R1 "
              f"{launches.get('face_fields')} and K5 {launches.get('resample_face')} times in "
              f"{n} frames, not once a frame each")

    for flag, summary in (("--relocalize", "relocalize: "), ("--pose-graph", "pose graph: ")):
        tag = flag.lstrip("-")
        poses_m, metrics_m = out_dir / f"poses_{tag}.txt", out_dir / f"metrics_{tag}.jsonl"
        stdout = cli("run", "--data", str(data), "--frames", str(n), flag, "--save-poses",
                     str(poses_m), "--metrics", str(metrics_m), "--quiet")
        ev = json.loads(cli("eval", "--est", str(poses_m), "--gt", str(out_dir / "gt.txt"))
                        .strip().splitlines()[-1])
        rows = [json.loads(line) for line in metrics_m.read_text().splitlines()]
        tracked = sum(bool(r["tracking_ok"]) for r in rows[1:])
        lines = [ln for ln in stdout.splitlines() if ln.startswith(summary)]
        print(f"    run {flag}: tracked {tracked}/{n - 1} after the bootstrap; aligned ATE "
              f"{ev['ate_rmse_m'] * 1e3:.4f} mm; summary {lines}", flush=True)
        if len(rows) != n or tracked != n - 1 or ev["ate_rmse_m"] > ATE_MAX or not lines:
            _fail(f"CLI {flag}: {tracked}/{n - 1} tracked, ATE {ev['ate_rmse_m']}, "
                  f"summary {lines}")
    return launches, list(sess.pose_record)


def profile_steps(frames, params, intr, device, out_path: str, ms_frame: float,
                  n: int = 10, first: int = 2, label: str = "orbit",
                  icp: bool = True, streaming: bool = False) -> None:
    """Phase 6, through kinfu_tpu_torch/tools/trace_step.py: torch.profiler
    over frames first..n-1 of a fresh run (with `streaming`, of the
    streaming step). Prints the kernels by device time, their sum per frame
    and its share of `ms_frame` (the step's time without the profiler), each
    port kernel's device time per frame and a launch (per frame, its longest
    launch and the median of the others: where one face is live, the active
    face and the gated-off ones), and writes the full table to `out_path`;
    with `icp`, then the ICP of a frame alone (`trace_step.icp_profile`)."""
    import torch

    from kinfu_tpu_torch.tools import trace_step as ts

    prof, state = ts.trace_steps(frames[:n], params, intr, device, first=first,
                                 streaming=streaming)
    m, busy = prof.calls, prof.busy_ms
    print(f"[6] profile, {label}, frames {first}-{n - 1} of a fresh run: kernels busy "
          f"{busy:.3f} ms/frame in {prof.count:.0f} launches/frame; {busy / ms_frame:.1%} of the "
          f"{ms_frame:.3f} ms/frame step (device idle {1 - busy / ms_frame:.1%}); "
          f"{prof.wall_ms:.1f} ms/frame wall under the profiler", flush=True)
    for name, total, count in prof.rows[:12]:
        print(f"      {total / m:9.3f} ms/frame {count // m:5d}x  {name[:90]}", flush=True)
    for line in ts.kernel_lines(prof, [(key, name) for key, name, *_ in KERNELS]):
        print(f"    {line}", flush=True)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(prof.table)
    if icp:
        depth = torch.as_tensor(frames[n - 1][0], device=device)
        for name, ms, count in ts.icp_profile(state, depth, params, intr):
            print(f"    ICP of a frame, {name}: device {ms:.4f} ms in {count:.0f} launches",
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
    from one call, K2 (all six face stacks), R1 (all six faces' shading)
    and K5 (all six faces' composite) once a frame."""
    for key, name, *_ in KERNELS:
        if launches.get(key, 0) <= 0:
            _fail(f"{name} was not launched in {where}")
    if launches["icp_normal_eqs"] != k1_want:
        _fail(f"K1 launched {launches['icp_normal_eqs']} times in {where}, not {k1_want}")
    for key in ("build_face", "face_fields", "resample_face"):
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
    got.update(check_composite(state, [("corner", T)], params, intr, device))
    for key, r in got.items():
        res[key][0] = max(res[key][0], r[0])
    del state
    torch.cuda.empty_cache()
    return ms_frame


def camvol_face_gap(poses, oks, params, intr, device) -> list:
    """Frames whose raycast face flags (`faces_needed_cam2vol` of the
    camera-to-volume pose) differ from the fusion's (`faces_needed` of the
    volume-to-camera pose), from the tracked poses."""
    import torch

    from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
    from kinfu_tpu_torch.ops.face_integrate import faces_needed
    from kinfu_tpu_torch.ops.face_raycast import faces_needed_cam2vol

    volp = pose_from_matrix(torch.as_tensor(params.volume_pose, device=device))
    differ = []
    for k, (T, ok) in enumerate(zip(poses, oks)):
        cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32, device=device))
        a = faces_needed(compose(inverse(cam), volp), intr)
        b = faces_needed_cam2vol(compose(inverse(volp), cam), intr)
        if ok and not torch.equal(a, b):
            differ.append(k)
    return differ


def check_counts(launches, want: dict, where: str) -> None:
    """Each kernel of `want` launched exactly that many times in `where`."""
    for key, n in want.items():
        if launches.get(key, 0) != n:
            _fail(f"{where}: {key} launched {launches.get(key, 0)} times, not {n} "
                  f"(launches {launches})")


def run_nonfused(frames, gt, params, intr, device, fused_poses, smi: str):
    """Phase 4c: the orbit through kinfu_step with fused_mode="off" (the
    integrate and raycast dispatchers: K2 + K3 and K4 + face shading + K5),
    each step under sync-debug mode "error". Fails unless every frame after
    the first tracks, the aligned ATE is <= 1 mm, the poses are within
    NONFUSED_POSE_TOL of phase 4's fused ones, and a frame launches K1 19
    times, K2 and K5 once, K3 and K4 six times each. Returns (launches,
    ms/frame, poses)."""
    import torch

    from kinfu_tpu_torch.eval.ate import ate_rmse

    n = len(frames)
    off = params.replace(fused_mode="off")
    print(f"[4c] non-fused step: the orbit's {n} frames through kinfu_step with "
          f"fused_mode='off', each step under sync-debug mode \"error\"", flush=True)
    poses, oks, inliers, frame_ms, state, launches = run_orbit(frames, off, intr, device,
                                                               no_sync=True)
    del state
    _empty_cache(device)
    ate = ate_rmse(list(poses), gt[:n])
    gap = float(np.abs(poses - fused_poses[:n]).max())
    ms_frame = float(np.median(frame_ms[2:])) if frame_ms is not None else float("nan")
    differ = camvol_face_gap(poses, oks, params, intr, device)
    print(f"    tracked {int(oks[1:].sum())}/{n - 1} frames after bootstrap; aligned ATE "
          f"{ate * 1e3:.4f} mm; max |pose - fused pose| {gap:.3g}; inliers at the last frame "
          f"{int(inliers[-1])}", flush=True)
    print(f"    {ms_frame:.3f} ms/frame (median of frames 2-{n - 1}, CUDA events) on {smi}; "
          f"launches a frame: { {k: v / n for k, v in sorted(launches.items())} }", flush=True)
    print(f"    frames where the raycast's cam2vol face set differs from the fusion's "
          f"vol2cam set: {differ}", flush=True)
    if not oks[1:].all() or not np.isfinite(poses).all():
        _fail(f"non-fused step: tracking failed at frames {np.nonzero(~oks[1:])[0] + 1}")
    if ate > ATE_MAX:
        _fail(f"non-fused step: aligned ATE {ate * 1e3:.4f} mm > {ATE_MAX * 1e3} mm")
    if gap > NONFUSED_POSE_TOL:
        _fail(f"non-fused step: poses {gap} from the fused step's")
    check_counts(launches, {"icp_normal_eqs": 19 * n, "build_face": n, "resample_face": n,
                            "face_fields": n, "face_integrate": 6 * n, "sweep_rays": 6 * n},
                 "the non-fused step")
    return launches, ms_frame, poses


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _empty_cache(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def sync_errors(device, what: str):
    """Sync-debug mode "error" on a CUDA device for the block (nothing on the
    CPU): a synchronising call in it fails the run, naming `what`."""
    import torch

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as e:
        _fail(f"{what} synchronised the host with the device: {e}")
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode("default")


def _checksum_equal(vol, before) -> bool:
    import torch

    return all(torch.equal(a, b) for a, b in zip(vol, before))


def run_relocalize(frames, gt, params, intr, smi: str, **session_kw) -> dict:
    """Phase 5c: KinFuSession(relocalize=True) on its default device over
    orbit frames 0..RELOC_FRAMES-1; two all-zero frames (both fail, each a
    fused step with the map kept and one relocalize_step whose ICP fails,
    the volume and the weight count bit-unchanged); frame RELOC_FRAMES-1
    again (recovers within RELOC_TOL, the record grows by one); a direct
    relocalize_step seeded from the keyframe nearest a pose 5 cm and 3
    degrees off that frame's, under sync-debug mode "error" (recovers
    within RELOC_TOL, K1 19, K4 12, K5 2, K2 1 and K3 6 launches), and the
    same call on an all-zero frame (the volume bit-unchanged); then the
    orbit's remaining frames track and the aligned ATE over the record is
    <= 1 mm. Returns the launches of the direct call."""
    import torch

    from kinfu_tpu_torch.eval.ate import ate_rmse
    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.pipeline.kinfu import relocalize_step
    from kinfu_tpu_torch.pipeline.session import KinFuSession

    m = RELOC_FRAMES
    n = len(gt)
    print(f"[5c] relocalization: KinFuSession(relocalize=True) over orbit frames 0-{m - 1}, "
          f"two all-zero frames, frame {m - 1} again, a direct relocalize_step, frames "
          f"{m}-{n - 1}", flush=True)
    sess = KinFuSession(intr, params, relocalize=True, **session_kw)
    dev = sess.device
    for k in range(m):
        if not sess.pipeline(frames[k][1], frames[k][0]):
            _fail(f"relocalization: frame {k} lost tracking before the loss")
    zero_d, zero_c = np.zeros_like(frames[0][0]), np.zeros_like(frames[0][1])
    before = [a.clone() for a in sess.state.vol]
    count = int((sess.state.vol.weight > 0).sum())
    _sync(dev)
    kernels.reset_launch_counts()
    res = [sess.pipeline(zero_c, zero_d) for _ in range(2)]
    _sync(dev)
    lost = dict(kernels.LAUNCHES)
    kept = _checksum_equal(sess.state.vol, before) and \
        int((sess.state.vol.weight > 0).sum()) == count
    del before
    print(f"    {len(sess.keyframes)} keyframes; two all-zero frames: returned {res}, volume "
          f"bits and the {count} weighted voxels kept: {kept}; launches {lost}", flush=True)
    if res != [False, False] or not kept:
        _fail("relocalization: an all-zero frame tracked, or the map changed across the loss")
    check_counts(lost, {"icp_normal_eqs": 4 * 19, "build_face": 4, "face_integrate": 24,
                        "sweep_rays": 2 * (6 + 12), "resample_face": 2 * 3,
                        "face_fields": 2 * 3},
                 "the two failed frames (each: a step, then relocalize_step)")

    n_rec = len(sess.pose_record)
    _sync(dev)
    kernels.reset_launch_counts()
    ok = sess.pipeline(frames[m - 1][1], frames[m - 1][0])
    _sync(dev)
    again = dict(kernels.LAUNCHES)
    path = ("relocalize_step" if again.get("icp_normal_eqs") == 38
            else "the session's own step (the kept model maps)")
    gap = float(np.linalg.norm(sess.pose_record[-1][:3, 3] - gt[m - 1][:3, 3]))
    print(f"    frame {m - 1} again: returned {ok}, the record grew {n_rec} -> "
          f"{len(sess.pose_record)}, recovered translation {gap * 1e3:.4f} mm from ground "
          f"truth; recovered by {path}", flush=True)
    if not ok or len(sess.pose_record) != n_rec + 1 or gap > RELOC_TOL:
        _fail(f"relocalization: frame {m - 1} again returned {ok}, translation gap {gap}")

    a = np.radians(3.0)
    off = np.array([[np.cos(a), 0, np.sin(a), 0.05], [0, 1, 0, 0],
                    [-np.sin(a), 0, np.cos(a), 0], [0, 0, 0, 1]])
    kf = sess.keyframes.nearest(gt[m - 1] @ off)
    d = torch.as_tensor(frames[m - 1][0], device=dev)
    c = torch.as_tensor(frames[m - 1][1], device=dev)
    _sync(dev)
    kernels.reset_launch_counts()
    with sync_errors(dev, "relocalize_step"):
        st, out = relocalize_step(sess.state, d, c, kf.pose, params, intr)
    _sync(dev)
    direct = dict(kernels.LAUNCHES)
    ok = bool(out.tracking_ok)
    gap = float(np.linalg.norm(out.pose_matrix.cpu().numpy()[:3, 3] - gt[m - 1][:3, 3]))
    seed_gap = float(np.linalg.norm(kf.pose[:3, 3] - gt[m - 1][:3, 3]))
    print(f"    direct relocalize_step from keyframe {kf.index} (seed {seed_gap * 1e3:.1f} mm "
          f"from frame {m - 1}), under sync-debug mode \"error\": ok {ok}, "
          f"{int(out.icp_inliers)} inliers, translation {gap * 1e3:.4f} mm from ground truth; "
          f"launches {direct}", flush=True)
    if not ok or gap > RELOC_TOL:
        _fail(f"relocalize_step from a keyframe seed: ok {ok}, translation gap {gap}")
    check_counts(direct, {"icp_normal_eqs": 19, "sweep_rays": 12, "resample_face": 2,
                          "face_fields": 2, "build_face": 1, "face_integrate": 6},
                 "relocalize_step")
    sess.state = st
    before = [t.clone() for t in st.vol]
    st2, out2 = relocalize_step(st, torch.zeros_like(d), torch.zeros_like(c), kf.pose,
                                params, intr)
    kept = _checksum_equal(st2.vol, before) and not bool(out2.tracking_ok)
    del before
    print(f"    the same call on an all-zero frame: ok {bool(out2.tracking_ok)}, volume bits "
          f"kept: {kept}", flush=True)
    if not kept:
        _fail("relocalize_step on an all-zero frame tracked or changed the volume")

    for k in range(m, n):
        if not sess.pipeline(frames[k][1], frames[k][0]):
            _fail(f"relocalization: frame {k} lost tracking after the recovery")
    ref = list(gt[:m]) + [gt[m - 1]] + list(gt[m:n])
    ate = ate_rmse(sess.pose_record, ref)
    print(f"    frames {m}-{n - 1} tracked; aligned ATE over the {len(sess.pose_record)} poses "
          f"of the record {ate * 1e3:.4f} mm [{smi}]", flush=True)
    if ate > ATE_MAX:
        _fail(f"relocalization: aligned ATE {ate * 1e3:.4f} mm > {ATE_MAX * 1e3} mm")
    del sess, st, st2
    _empty_cache(dev)
    return direct


def _yaw_x(deg: float, x: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s, x], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float32)


def run_pose_graph(params, intr, smi: str, **session_kw) -> dict:
    """Phase 5d: (1) the out-and-back loop of
    tests/test_mapping.py::test_loop_closure_corrects_drift at this
    workload's width, through KinFuSession(pose_graph=True) beside a plain
    session: a closure against a non-adjacent keyframe fires, the rebuild
    launches K2 and K3 once per frame it re-fuses and then the warped
    raycast, the corrected ATE is <= 1 mm and the map error (mean |scene
    sdf| of the extracted cloud) no worse than the plain session's x 1.05.
    (2) test_closure_rebuild_realigns_map: every keyframe pose shifted by
    0.12 m in x and the map rebuilt: the fused sphere sits on the shifted
    sphere, and > 20% of the rebuilt model normals are valid. Returns the
    pose-graph session's launches."""
    import torch

    from kinfu_tpu_torch.data.synthetic import default_test_scene
    from kinfu_tpu_torch.eval.ate import ate_rmse
    from kinfu_tpu_torch.mapping.loop_closure import LoopClosureConfig
    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.pipeline.session import KinFuSession

    scene = default_test_scene()
    n_out = 24
    traj = [_yaw_x(0.25 * i, 0.005 * i) for i in range(n_out)]
    traj += [_yaw_x(0.25 * i, 0.005 * i) for i in range(n_out - 2, -1, -1)]
    frames = [scene.render_frame(T, intr) for T in traj]
    gt = [np.linalg.inv(traj[0]) @ T for T in traj]
    cfg = LoopClosureConfig(max_translation=0.04, max_angle_deg=10.0, min_keyframe_gap=3,
                            kf_min_translation=0.025, kf_min_rotation_deg=4.0,
                            cooldown_frames=100, min_inlier_frac=0.05)
    print(f"[5d] pose graph: the out-and-back loop of tests/test_mapping.py ({len(frames)} "
          f"frames, {intr.width}x{intr.height}, {params.volume_dims[0]}^3) through "
          f"KinFuSession(pose_graph=True) and a plain session", flush=True)
    ates, errs, rebuilds = {}, {}, []
    for pg in (False, True):
        sess = KinFuSession(intr, params, pose_graph=pg, loop_config=cfg, **session_kw)
        dev = sess.device
        if pg:
            rebuild = sess._rebuild_map

            def counted(*a, _f=rebuild):
                _sync(dev)
                start = dict(kernels.LAUNCHES)
                _f(*a)
                _sync(dev)
                rebuilds.append((len(sess.pg_keyframes.keyframes),
                                 {k: v - start.get(k, 0) for k, v in kernels.LAUNCHES.items()}))
            sess._rebuild_map = counted
        _sync(dev)
        kernels.reset_launch_counts()
        oks = [sess.pipeline(c, d) for d, c in frames]
        _sync(dev)
        launches = dict(kernels.LAUNCHES)
        if not all(oks):
            _fail(f"pose graph: tracking failed at frames {[k for k, o in enumerate(oks) if not o]}")
        ates[pg] = ate_rmse(sess.pose_record, gt[:len(sess.pose_record)])
        errs[pg] = float(np.abs(scene.sdf(sess.extract_pointcloud())).mean())
        if pg:
            closures, n_kf = sess.loop_closures, len(sess.pg_keyframes)
        del sess
        _empty_cache(dev)
    print(f"    plain: aligned ATE {ates[False] * 1e3:.4f} mm, map error {errs[False] * 1e3:.4f} "
          f"mm; pose graph: aligned ATE {ates[True] * 1e3:.4f} mm, map error "
          f"{errs[True] * 1e3:.4f} mm; {n_kf} keyframes, closures {closures}", flush=True)
    print(f"    rebuilds (keyframes stored, launches): {rebuilds}; the session's launches "
          f"{launches} [{smi}]", flush=True)
    if not closures or closures[0]["frame"] - closures[0]["keyframe"] <= cfg.min_keyframe_gap:
        _fail(f"pose graph: no closure against a non-adjacent keyframe fired: {closures}")
    for n_kf_r, lr in rebuilds:
        check_counts(lr, {"build_face": n_kf_r + 1, "face_integrate": 6 * (n_kf_r + 1),
                          "sweep_rays": 6, "resample_face": 1, "face_fields": 1},
                     "the map rebuild")
    if ates[True] > ATE_MAX:
        _fail(f"pose graph: corrected ATE {ates[True] * 1e3:.4f} mm > {ATE_MAX * 1e3} mm")
    if errs[True] > errs[False] * 1.05:
        _fail(f"pose graph: map error {errs[True]} > the plain session's {errs[False]} x 1.05")

    cfg2 = LoopClosureConfig(kf_min_translation=0.002, kf_min_rotation_deg=0.5)
    traj = []
    for i in range(4):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.004 * i
        traj.append(T)
    frames = [scene.render_frame(T, intr) for T in traj]
    sess = KinFuSession(intr, params, pose_graph=True, loop_config=cfg2, **session_kw)
    if not all(sess.pipeline(c, d) for d, c in frames):
        _fail("pose graph realignment: tracking failed")
    if len(sess.pg_keyframes.keyframes) < 2 or any(k.depth is None
                                                   for k in sess.pg_keyframes.keyframes):
        _fail("pose graph realignment: fewer than two keyframes with frames")
    cloud0 = sess.extract_pointcloud().copy()
    dx = 0.12
    shift = np.eye(4)
    shift[0, 3] = dx
    for kf in sess.pg_keyframes.keyframes:
        kf.pose = (shift @ kf.pose.astype(np.float64)).astype(np.float32)
    new_cur = (shift @ sess.pose_record[-1].astype(np.float64)).astype(np.float32)
    d, c = frames[-1]
    sess._rebuild_map(torch.as_tensor(d, device=sess.device),
                      torch.as_tensor(c, device=sess.device), new_cur)
    cloud1 = sess.extract_pointcloud()
    sph_c, sph_r = np.array([0.45, -0.25, 1.7]), 0.4

    def on_sphere(pts, centre, band=0.03):
        return int((np.abs(np.linalg.norm(pts - centre, axis=1) - sph_r) < band).sum())

    n0 = on_sphere(cloud0, sph_c)
    n_shift, n_orig = on_sphere(cloud1, sph_c + [dx, 0, 0]), on_sphere(cloud1, sph_c)
    valid = float((sess.state.model_nmaps[0].abs().sum(-1) > 0).float().mean())
    print(f"    realignment: {len(sess.pg_keyframes.keyframes)} keyframes shifted 0.12 m in x and "
          f"the map rebuilt: points on the sphere before {n0}; after, on the shifted sphere "
          f"{n_shift}, on the original {n_orig}; valid model normals {valid:.3f}", flush=True)
    if not (n0 > 200 and n_shift > 200 and n_shift > 2.5 * n_orig and valid > 0.2):
        _fail("pose graph realignment: the rebuilt map did not move with the keyframes")
    del sess
    _empty_cache(dev)
    return launches


def profile_relocalize(frames, params, intr, device, n: int = 10) -> None:
    """Phase 6, relocalize_step alone: device time and launches of one call
    on the state fused from `n` orbit frames, seeded from that state's pose
    (after one call that warms its caches)."""
    import torch

    from kinfu_tpu_torch.geometry.se3 import pose_matrix
    from kinfu_tpu_torch.pipeline.kinfu import init_state, make_step_fn, relocalize_step
    from kinfu_tpu_torch.tools.trace_step import profile

    step = make_step_fn(params, intr, auto_reset=False)
    state = init_state(params, intr, device=device)
    dev = [(torch.as_tensor(d, device=device), torch.as_tensor(c, device=device))
           for d, c in frames[:n]]
    for d, c in dev:
        state, _ = step(state, d, c)
    seed = pose_matrix(state.pose).cpu().numpy()
    d, c = dev[-1]
    state, _ = relocalize_step(state, d, c, seed, params, intr)
    torch.cuda.synchronize()
    outs = []
    prof = profile(lambda: outs.append(relocalize_step(state, d, c, seed, params, intr)), 1,
                   device)
    print(f"    relocalize_step, one call: device {prof.busy_ms:.4f} ms in {prof.count:.0f} "
          f"launches (ok {bool(outs[0][1].tracking_ok)})", flush=True)


# ---- phase 5e: the streaming (camera-following) volume --------------------

#: tests/test_session.py::test_streaming_corridor_scale's corridor: frames
#: of a walk along +z through default_test_scene, metres a frame
CORRIDOR_FRAMES = 100
CORRIDOR_STEP = (0.0, 0.0, 0.014)
#: where the streaming session writes its 3D view and checkpoint
STREAM_OUT = REPO / "build" / "chip_smoke_stream"
#: the streaming step's aligned ATE bound as a multiple of the fixed
#: volume's, where that exceeds ATE_MAX on the corridor
STREAM_ATE_FACTOR = 1.1
#: the corridor frames phase 6 profiles (the grid shifts on them)
STREAM_PROFILE = (90, 98)
#: how far the streaming step's poses may lie from the fixed volume's on
#: the frames tracked against a shifted grid, metres: the volume's pose
#: moves by whole voxels, which rounds its voxel centres otherwise (2.23e-5
#: m measured on frames 91-99 on an H100); a shift off by one voxel moves
#: the map by 5.9 mm
SHIFTED_POSE_TOL = 1e-4
#: (sx, sy, sz) shifts that `check_shift` holds shift_volume to on the
#: card: each axis in both directions, and one past the far side
SHIFT_CHECKS = ((0, 0, 2), (3, -1, -2), (-5, 4, 0), (0, 600, 0))
#: the kernel the port adds for the streaming shift: (launch-count key,
#: name, source, what it replaces)
SHIFT_KERNEL = ("shift_volume", "S1 shift_volume", "kinfu_tpu_torch/csrc/shift_volume.cu",
                "no TPU kernel: kinfu_tpu/volume/stream.py:24-47 rolls and masks outside Pallas")
#: (sx, sy, sz) shifts that `check_shift_kernel` holds S1 to its plain twin
#: on: 1-3 voxels each way along each axis, all three axes at once, zero,
#: and past the far side (a wipe)
SHIFT_KERNEL_CHECKS = tuple(
    tuple(d * k if i == axis else 0 for i in range(3))
    for axis in range(3) for k in (1, 2, 3) for d in (1, -1)) + (
    (2, -3, 1), (0, 0, 0), (0, 600, 0), (-600, 5, 0))
#: (X, Y, Z) of the second volume S1 is checked on: X odd (the kernel's
#: y and z passes then move one voxel a thread, not two) and more than one
#: 512-voxel chunk of its x pass
SHIFT_ODD_DIMS = (1037, 7, 5)
#: the in-place shifts that `check_shift_kernel` times, each captured in a
#: CUDA graph as the step replays it: one axis each, two axes, none
SHIFT_TIMED = ((0, 0, 2), (0, 2, 0), (2, 0, 0), (2, 2, 0), (0, 0, 0))


def corridor_frames(n: int, intr):
    """The corridor's frames and the ground truth relative to the first
    camera."""
    from kinfu_tpu_torch.data.synthetic import default_test_scene, make_translation_trajectory

    scene = default_test_scene()
    traj = make_translation_trajectory(n, step=CORRIDOR_STEP)
    gt = [np.linalg.inv(traj[0]) @ T for T in traj]
    return [scene.render_frame(T, intr) for T in traj], gt


def shift_frames(origins) -> list:
    """[(frame, origin_vox)] of each frame whose grid offset changed."""
    out, prev = [], np.zeros(3, np.int32)
    for k, o in enumerate(origins):
        if (o != prev).any():
            out.append((k, o.tolist()))
            prev = o
    return out


def random_volume(dims_xyz, device, seed: int = 20):
    """A volume of `dims_xyz` whose voxels take every value of their type's
    range (the TSDF), 0-64 (the weight) and 24 bits (the colour), seeded."""
    import torch

    from kinfu_tpu_torch.volume.tsdf import TSDFVolume

    g = torch.Generator(device=device).manual_seed(seed)
    shape = tuple(reversed(dims_xyz))

    def draw(lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32,
                             device=device).to(dtype)

    return TSDFVolume(draw(-32768, 32768, torch.int16), draw(0, 65, torch.int16),
                      draw(0, 1 << 24, torch.int32))


def check_shift_kernel(vol, device) -> dict:
    """S1 (`shift_volume_`, csrc/shift_volume.cu) in place on a copy of
    `vol`, and of a seeded volume of SHIFT_ODD_DIMS, against its plain twin
    `shift_volume` on the card, bit for bit, for each of
    SHIFT_KERNEL_CHECKS: the copy keeps its tensors, S1 makes 3 launches a
    call and its counter counts every call and the calls that move. Then
    each of SHIFT_TIMED on a copy of `vol`, captured in a CUDA graph as the
    step replays it, timed by CUDA events (median of 10 replays), beside
    the byte bound (the volume read and written once) and one call of the
    twin. Fails on any difference. Returns the kernels line's record."""
    import torch

    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.volume.stream import shift_volume, shift_volume_
    from kinfu_tpu_torch.volume.tsdf import TSDFVolume

    key = SHIFT_KERNEL[0]
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    before = kernels.LAUNCHES[key]
    differ = 0
    for v in (vol, random_volume(SHIFT_ODD_DIMS, device)):
        for s in SHIFT_KERNEL_CHECKS:
            shift = torch.tensor(s, dtype=torch.int32, device=device)
            want = shift_volume(v, shift)
            got = TSDFVolume(*(a.clone() for a in v))
            ptrs = [a.data_ptr() for a in got]
            if shift_volume_(got, shift, counts) is not got or \
                    [a.data_ptr() for a in got] != ptrs:
                _fail(f"{SHIFT_KERNEL[1]} by {s} did not shift the volume it was given")
            for name, g, w in zip(TSDFVolume._fields, got, want):
                if not torch.equal(g, w):
                    differ += 1
                    print(f"    {SHIFT_KERNEL[1]} by {s} on {tuple(v.tsdf.shape)}: {name} "
                          f"differs from shift_volume's on {int((g != w).sum())} voxels",
                          flush=True)
            del want, got
    launches = kernels.LAUNCHES[key] - before
    n, moved = 2 * len(SHIFT_KERNEL_CHECKS), 2 * sum(any(s) for s in SHIFT_KERNEL_CHECKS)
    if differ:
        _fail(f"{SHIFT_KERNEL[1]} differs from its plain twin on {differ} arrays")
    if launches != 3 * n or counts.tolist() != [n, moved]:
        _fail(f"{SHIFT_KERNEL[1]}: {launches} launches for {n} calls (want {3 * n}), counter "
              f"{counts.tolist()} (want {[n, moved]})")
    work = TSDFVolume(*(a.clone() for a in vol))
    ms = {}
    for s in SHIFT_TIMED:
        shift = torch.tensor(s, dtype=torch.int32, device=device)
        shift_volume_(work, shift, counts)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            shift_volume_(work, shift, counts)
        ms[str(s)] = cuda_ms(graph.replay)
        del graph
    z2 = torch.tensor(SHIFT_TIMED[0], dtype=torch.int32, device=device)
    plain_ms = cuda_ms(lambda: shift_volume(work, z2))
    del work
    bound_ms, bound_by = bound(2 * nbytes(*vol), 0)
    return {"max_abs_err": 0.0, "ms": ms[str(SHIFT_TIMED[0])], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "ms_by_shift": ms,
            "shifts_checked": n, "launches_checked": launches}


def print_shift_kernel(res: dict, dims, smi: str) -> None:
    by = ", ".join(f"{s} {v:.4f}" for s, v in res["ms_by_shift"].items())
    print(f"    {SHIFT_KERNEL[1]} equal to shift_volume on the card bit for bit on "
          f"{res['shifts_checked']} shifts of a {dims} and a {SHIFT_ODD_DIMS} volume (+-1..3 "
          f"voxels along each axis, three axes, zero, two wipes), {res['launches_checked']} "
          f"launches; in place, "
          f"replayed from a CUDA graph, ms by shift: {by} (bound {res['bound_ms']:.4f} ms, "
          f"{res['bound_by']}); shift_volume {res['plain_ms']:.4f} ms  [{smi}]", flush=True)


def shift_plain(a, s):
    """`a` [Z, Y, X] shifted by (sx, sy, sz) Python ints as shift_volume
    shifts it, new[k] = old[k + s] and zero where k + s falls outside: one
    slice copy into zeros."""
    import torch

    out = torch.zeros_like(a)
    dst, src = [], []
    for n, k in zip(a.shape, (s[2], s[1], s[0])):
        lo, hi = max(0, -k), min(n, n - k)
        if lo >= hi:
            return out
        dst.append(slice(lo, hi))
        src.append(slice(lo + k, hi + k))
    out[tuple(dst)] = a[tuple(src)]
    return out


def check_shift(vol, device) -> str:
    """Holds shift_volume on the card to `shift_plain` on the card and, for
    the first shift, to shift_volume on the CPU, bit for bit, for each of
    SHIFT_CHECKS on `vol`. Fails on any difference; returns a summary."""
    import torch

    from kinfu_tpu_torch.volume.stream import shift_volume
    from kinfu_tpu_torch.volume.tsdf import TSDFVolume

    kept = []
    for k, s in enumerate(SHIFT_CHECKS):
        got = shift_volume(vol, torch.tensor(s, dtype=torch.int32, device=device))
        for name, g, a in zip(TSDFVolume._fields, got, vol):
            if g.dtype != a.dtype or not torch.equal(g, shift_plain(a, s)):
                _fail(f"shift_volume by {s} on the card: {name} differs from the slice copy")
        if k == 0:
            cpu = shift_volume(TSDFVolume(*(a.cpu() for a in vol)),
                               torch.tensor(s, dtype=torch.int32))
            for name, g, c in zip(TSDFVolume._fields, got, cpu):
                if not torch.equal(g.cpu(), c):
                    _fail(f"shift_volume by {s}: {name} on the card differs from the CPU's")
        kept.append(int((got.weight > 0).sum()))
        del got
    return ", ".join(f"{s}: {n} weighted voxels" for s, n in zip(SHIFT_CHECKS, kept))


def run_streaming(frames, gt, params, intr, device, smi: str, orbit_ms: float) -> dict:
    """Phase 5e: the corridor (`frames[:-1]`; the last frame is the resumed
    session's) through (a) kinfu_step, the fixed volume, as the reference
    run; (b) streaming_step, fused, under sync-debug mode "error", with the
    launch counts set to 0 just before; (c) streaming_step with
    fused_mode="off", under "error"; (d) KinFuSession(streaming=True).
    Fails unless every frame after the first tracks on each; the grid
    shifts; (b) gives (a)'s poses bit for bit on the frames before its
    first shift, and within SHIFTED_POSE_TOL on the frames after it;
    shift_volume on (b)'s last volume agrees bit for bit with its slice
    copy and with the CPU (`check_shift`); (b)'s aligned ATE is <= 1 mm (or, where (a)'s exceeds
    that, within (a)'s x STREAM_ATE_FACTOR); (b) and (c) launch K1 19 times
    a frame, K2 and K5 once, K3 and K4 six times, S1 three; the step makes
    no host sync (counted under "warn"); (c) gives (b)'s grid offsets and
    its poses within NONFUSED_POSE_TOL; the session gives (b)'s poses and
    grid offset, a point cloud inside the moved volume, a 3D view, and a
    checkpoint that loads with its offset and tracks the next frame.
    Prints the frames where the grid shifted, the time of one shift beside
    its bound and ms/frame beside the orbit's `orbit_ms`; holds S1 to its
    twin on (b)'s last volume and times it (`check_shift_kernel`). Returns
    (the launches of (b), (c) and (d) by path, (b)'s ms/frame, S1's
    record)."""
    import torch

    from kinfu_tpu_torch.eval.ate import ate_rmse
    from kinfu_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.pipeline.session import KinFuSession
    from kinfu_tpu_torch.pipeline.streaming import _vol_pose_dyn

    t_5e = time.perf_counter()
    n = len(frames) - 1
    per_frame = {"icp_normal_eqs": 19 * n, "build_face": n, "resample_face": n,
                 "face_fields": n, "face_integrate": 6 * n, "sweep_rays": 6 * n,
                 SHIFT_KERNEL[0]: 3 * n}
    print(f"[5e] streaming volume: the corridor ({n} frames, {CORRIDOR_STEP[2] * 1e3:g} mm a "
          f"frame along +z) through the fixed volume, streaming_step fused and non-fused, "
          f"and KinFuSession(streaming=True)", flush=True)
    a_poses, a_oks, _, a_ms, a_state, _ = run_orbit(frames[:n], params, intr, device,
                                                    no_sync=True)
    del a_state
    _empty_cache(device)
    a_ate = ate_rmse(list(a_poses), gt[:n])
    print(f"    (a) fixed volume: tracked {int(a_oks[1:].sum())}/{n - 1}; aligned ATE "
          f"{a_ate * 1e3:.4f} mm", flush=True)
    if not a_oks[1:].all():
        _fail(f"corridor, fixed volume: tracking failed at frames {np.nonzero(~a_oks[1:])[0] + 1}")

    syncs = step_syncs(frames[:6], params, intr, device, streaming=True)["syncs"]
    origins = []
    poses, oks, inliers, frame_ms, state, launches = run_orbit(
        frames[:n], params, intr, device, no_sync=True, origins=origins)
    shifts = shift_frames(origins)
    first = shifts[0][0] if shifts else n
    before = bool(np.array_equal(poses[:first], a_poses[:first]))
    at_first = float(np.abs(poses[:first + 1] - a_poses[:first + 1]).max())
    # frames after the first shift track against a shifted grid
    shifted_gap = float(np.abs(poses[first + 1:] - a_poses[first + 1:]).max(initial=0.0))
    ate = ate_rmse(list(poses), gt[:n])
    limit = ATE_MAX if a_ate <= ATE_MAX else a_ate * STREAM_ATE_FACTOR
    ms_frame = float(np.median(frame_ms[2:])) if frame_ms is not None else float("nan")
    ms_shifting = (float(np.median(frame_ms[first:])) if frame_ms is not None and first < n
                   else float("nan"))
    shift_checked = check_shift(state.kinfu.vol, device)
    s1 = check_shift_kernel(state.kinfu.vol, device)
    del state
    _empty_cache(device)
    print(f"    (b) streaming_step, fused, each step under sync-debug mode \"error\": tracked "
          f"{int(oks[1:].sum())}/{n - 1}; aligned ATE {ate * 1e3:.4f} mm (bound "
          f"{limit * 1e3:.4f}); inliers at the last frame {int(inliers[-1])}; host syncs a step "
          f"{syncs:g} (4 steps under \"warn\")", flush=True)
    print(f"    the grid shifted on {len(shifts)} frames, (frame, origin_vox): {shifts}", flush=True)
    print(f"    poses before the first shift (frames 0-{first - 1}) equal to the fixed volume's "
          f"bit for bit: {before}; max gap through frame {first}: {at_first:.3g}; over "
          f"frames {first + 1}-{n - 1}, on the shifted grid: {shifted_gap:.3g} (limit "
          f"{SHIFTED_POSE_TOL})", flush=True)
    print(f"    shift_volume on the card equal to its slice copy (and the CPU's, for the "
          f"first) bit for bit, on (b)'s last volume shifted by {shift_checked}", flush=True)
    print(f"    {ms_frame:.3f} ms/frame (median of frames 2-{n - 1}, CUDA events; the orbit "
          f"{orbit_ms:.3f}), {ms_shifting:.3f} ms/frame over frames {first}-{n - 1} on {smi}",
          flush=True)
    print_shift_kernel(s1, tuple(params.volume_dims), smi)
    print(f"    launches a frame: { {k: v / n for k, v in sorted(launches.items())} }",
          flush=True)
    if not oks[1:].all() or not np.isfinite(poses).all():
        _fail(f"streaming step: tracking failed at frames {np.nonzero(~oks[1:])[0] + 1}")
    if not shifts:
        _fail("streaming step: the grid never shifted on the corridor")
    if not before:
        _fail("streaming step: the poses before the first shift differ from the fixed volume's")
    if shifted_gap > SHIFTED_POSE_TOL:
        _fail(f"streaming step: poses on the shifted grid {shifted_gap} from the fixed "
              f"volume's (limit {SHIFTED_POSE_TOL})")
    if ate > limit:
        _fail(f"streaming step: aligned ATE {ate * 1e3:.4f} mm > {limit * 1e3:.4f} mm")
    if syncs:
        _fail(f"the streaming step synchronised the host {syncs:g} times a frame")
    check_counts(launches, per_frame, "the streaming step")

    nf_origins = []
    nf_poses, nf_oks, _, nf_ms, nf_state, nf_launches = run_orbit(
        frames[:n], params.replace(fused_mode="off"), intr, device, no_sync=True,
        origins=nf_origins)
    del nf_state
    _empty_cache(device)
    same_grid = all(np.array_equal(a, b) for a, b in zip(nf_origins, origins))
    nf_gap = float(np.abs(nf_poses - poses).max())
    print(f"    (c) streaming_step, fused_mode='off', under \"error\": tracked "
          f"{int(nf_oks[1:].sum())}/{n - 1}; origin_vox on every frame equal to (b)'s: "
          f"{same_grid}; max |pose - (b) pose| {nf_gap:.3g}; "
          f"{float(np.median(nf_ms[2:])) if nf_ms is not None else float('nan'):.3f} ms/frame",
          flush=True)
    if not nf_oks[1:].all() or not same_grid or nf_gap > NONFUSED_POSE_TOL:
        _fail("non-fused streaming step: tracking lost, other grid offsets, or poses "
              f"{nf_gap} from the fused step's")
    check_counts(nf_launches, per_frame, "the non-fused streaming step")

    sess = KinFuSession(intr, params, device=device, streaming=True)
    _sync(device)
    kernels.reset_launch_counts()
    s_oks = [sess.pipeline(c, d) for d, c in frames[:n]]
    _sync(device)
    s_launches = dict(kernels.LAUNCHES)
    record = np.stack(sess.pose_record)
    s_gap = float(np.abs(record - poses).max()) if record.shape == poses.shape else np.inf
    origin = sess.state.origin_vox.cpu().numpy()
    pts = sess.extract_pointcloud()
    lo = _vol_pose_dyn(params, sess.state.origin_vox).t.cpu().numpy()
    inside = bool(((pts >= lo) & (pts <= lo + np.asarray(params.volume_range, np.float32))).all())
    STREAM_OUT.mkdir(parents=True, exist_ok=True)
    view = STREAM_OUT / "3d.png"
    sess.save_3d(str(view))
    ckpt = STREAM_OUT / "stream.npz"
    save_checkpoint(str(ckpt), sess)
    resumed = load_checkpoint(str(ckpt), device=sess.device)
    ckpt.unlink()
    kept = (resumed.streaming and np.array_equal(resumed.state.origin_vox.cpu().numpy(), origin)
            and all(torch.equal(a, b) for a, b in zip(resumed.state.kinfu.vol,
                                                      sess.state.kinfu.vol)))
    del sess
    ok = resumed.pipeline(frames[n][1], frames[n][0])
    print(f"    (d) session: tracked {sum(s_oks)}/{n}; max |pose record - (b) poses| {s_gap:.3g}; "
          f"origin_vox {origin.tolist()} ((b): {origins[-1].tolist()}); extracted {len(pts)} "
          f"points, all inside the moved volume [{lo.tolist()} + range]: {inside}; 3D view "
          f"{view.stat().st_size} bytes; checkpoint loaded with its origin_vox and volume: "
          f"{kept}; frame {n} tracked after resuming: {ok} (origin_vox then "
          f"{resumed.state.origin_vox.cpu().numpy().tolist()})", flush=True)
    if not all(s_oks) or s_gap > SESSION_POSE_TOL or not np.array_equal(origin, origins[-1]):
        _fail("streaming session: tracking lost, or poses or grid offset other than (b)'s")
    if len(pts) <= SESSION_MIN_POINTS or not inside or view.stat().st_size == 0:
        _fail(f"streaming session: {len(pts)} points, all inside the moved volume: {inside}")
    if not (kept and ok):
        _fail("streaming session: the checkpoint did not load as saved, or the next frame "
              "lost tracking")
    for path, got in (("streaming", launches), ("streaming_non_fused", nf_launches),
                      ("streaming_session", s_launches)):
        for key, name, *_ in KERNELS:
            if got.get(key, 0) <= 0:
                _fail(f"{name} was not launched on the path {path}")
    print(f"  phase 5e took {time.perf_counter() - t_5e:.1f} s", flush=True)
    return {"streaming": launches, "streaming_non_fused": nf_launches,
            "streaming_session": s_launches}, ms_frame, s1


# ---- phase 4e: the march raycasts (M1, M2) --------------------------------

#: the kernels the port adds for JAX loops outside Pallas: (launch-count key,
#: name, source, the JAX function whose lax.while_loop it runs)
MARCH_KERNELS = (
    ("march_rays", "M1 march_rays", "kinfu_tpu_torch/csrc/march_rays.cu",
     "kinfu_tpu/volume/raycast.py:122"),
    ("march_hier", "M2 march_hier", "kinfu_tpu_torch/csrc/march_hier.cu",
     "kinfu_tpu/volume/raycast.py:299"),
)
#: float32 operations of the march kernels, counted from their sources as
#: written (an arithmetic operation, a comparison, a min or max, a rint or
#: floor, a conversion to or from float32: one each; the integer index
#: arithmetic is not counted, having no rate in the table): per ray before
#: the loop, per loop iteration of a live ray (M2: in fine and in coarse
#: mode), per iteration whose two samples are valid (the four comparisons
#: of the crossing rules), per front (the refinement) and per back event
MARCH_OPS = {"march_rays": dict(ray=30, fine=30, coarse=0, test=4, front=10, back=3),
             "march_hier": dict(ray=14, fine=26, coarse=52, test=4, front=10, back=3)}
#: the untileable leg: a volume side that is not a multiple of 128, its frames
MARCH_DIM = 320
MARCH_DIM_FRAMES = 20
#: the slab form's setup: phase 4d's ranks, its interior slab
MARCH_SLAB = 1


def _march_inputs(params, intr, T, device):
    """(org, dirs, t_start, t_end, step, inv_vs) of the raycast dispatcher
    at camera pose T (world from camera, the orbit's frame)."""
    import torch

    from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
    from kinfu_tpu_torch.volume import raycast as rc

    volp = pose_from_matrix(torch.as_tensor(params.volume_pose, device=device))
    cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32, device=device))
    return rc.march_inputs(compose(inverse(volp), cam), intr, params)


def _march_pair(key: str, kernel, plain, work, inputs, smi: str, tag: str):
    """One kernel call against its plain twin on the same inputs (the
    float32 ray arrays `inputs`): the events bit for bit, CUDA-event times
    (the kernel's median of 10; the twin's one call, the compared one: it
    reads the device once a loop step, ~10^4 times at 512^3 for "hier"),
    and the bound of what this run's rays need (`work`, the twin's counts):
    each distinct voxel they read at 2 bytes and occupancy cell at 1, each
    ray input read and output written once, and the MARCH_OPS operations.
    Returns (max abs err, ms, plain ms, bound ms, bound by)."""
    import torch

    got = kernel()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    want = plain()
    b.record()
    b.synchronize()
    plain_ms = a.elapsed_time(b)
    equal = all(torch.equal(x, y) for x, y in zip(got, want))
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    counts = [int(c) for c in work()]
    if key == "march_rays":
        (voxels, fine, tests), cells, coarse = counts, 0, 0
    else:
        voxels, cells, fine, tests, coarse = counts
    n_rays = got.hit_t.numel()
    fronts = int((got.hit_t < 1e30).sum())
    backs = int((got.back_t < 1e30).sum())
    o = MARCH_OPS[key]
    ops = (o["ray"] * n_rays + o["fine"] * fine + o["coarse"] * coarse + o["test"] * tests
           + o["front"] * fronts + o["back"] * backs)
    nb = 2 * voxels + cells + nbytes(*inputs, got.hit_t, got.back_t)
    b_ms, b_by = bound(nb, ops)
    hits = int(((got.hit_t < got.back_t) & (got.hit_t < 1e30)).sum())
    ms = cuda_ms(kernel)
    iters = f"{fine} fine and {coarse} coarse" if coarse else f"{fine}"
    print(f"    {tag}: events bit for bit: {equal} (max abs err {err:.3g}); {hits} hits of "
          f"{n_rays} rays; {iters} loop iterations ({(fine + coarse) / n_rays:.1f} a ray), "
          f"{tests} with both samples valid, {fronts} fronts, {backs} backs; {voxels} distinct "
          f"voxels{f' and {cells} occupancy cells' if coarse else ''} read; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nb} bytes, {ops} "
          f"operations)  [{smi}]", flush=True)
    if not equal:
        _fail(f"{tag}: the kernel's events differ from its plain twin's")
    return err, ms, plain_ms, b_ms, b_by


def check_marches(tsdf, T, params, intr, device, smi: str) -> dict:
    """Phase 4e (a) and (d): M1 against `march` and M2 against `march_hier`,
    both twins plain on the card, on `tsdf` (phase 4's final volume) from
    the camera pose T; then M1's Z-slab form against `march` on the
    interior slab MARCH_SLAB of phase 4d's SHARD_RANKS, padded with
    `HALO` rows, with its per-ray k_start and t_end (`_local_t_interval`).
    Returns {key: (err, ms, plain ms, bound ms, bound by)} with "march_slab"."""
    from kinfu_tpu_torch.parallel.sharded import HALO, _local_t_interval
    from kinfu_tpu_torch.tools.sanitize import padded_slab
    from kinfu_tpu_torch.volume import raycast as rc

    org, dirs, ts, te, step, inv_vs = _march_inputs(params, intr, T, device)
    dims = tuple(tsdf.shape)
    vs = params.voxel_size
    bnd = rc.march_steps_bound(dims, vs, step)
    rays = (org, dirs, ts, te, inv_vs)
    m1 = (tsdf, dims, 0, *rays[:4], step, inv_vs)
    res = {"march_rays": _march_pair(
        "march_rays", lambda: rc.march_rays(*m1, max_steps=bnd),
        lambda: rc.march(*m1, max_steps=bnd), lambda: rc.march_work(*m1, max_steps=bnd),
        rays, smi, "M1 march_rays, full volume")}
    occ = rc.build_occupancy(tsdf)
    m2 = (tsdf, occ, *rays[:4], step, inv_vs)
    res["march_hier"] = _march_pair(
        "march_hier", lambda: rc.march_hier_rays(*m2), lambda: rc.march_hier(*m2),
        lambda: rc.march_hier_work(*m2), rays, smi, "M2 march_hier")
    Zl = dims[0] // SHARD_RANKS
    z0 = MARCH_SLAB * Zl
    padded = padded_slab(tsdf, 0, MARCH_SLAB, SHARD_RANKS, HALO)
    vsz = vs[2]
    z_lo = float(np.float32(z0) * np.float32(vsz))
    z_hi = float(np.float32(z0 + Zl) * np.float32(vsz))
    k_lo, t_hi = _local_t_interval(org[2], dirs[..., 2], z_lo, z_hi, ts, te, step)
    slab = (padded, dims, z0 - HALO, org, dirs, ts, t_hi, step, inv_vs)
    kw = dict(k_start=k_lo, max_steps=bnd)
    res["march_slab"] = _march_pair(
        "march_rays", lambda: rc.march_rays(*slab, **kw), lambda: rc.march(*slab, **kw),
        lambda: rc.march_work(*slab, **kw), (org, dirs, ts, t_hi, k_lo, inv_vs), smi,
        f"M1 march_rays, Z-slab form (slab {MARCH_SLAB} of {SHARD_RANKS}, "
        f"{tuple(padded.shape)} with {HALO} halo rows a side)")
    return res


def run_march_leg(frames, gt, params, intr, device, smi: str, want: dict, tag: str,
                  fused_poses=None) -> dict:
    """One leg of phase 4e: the host syncs, launches and ms a frame of
    frames 2-5 under sync-debug "warn" (`step_syncs`), then `frames`
    through kinfu_step with each step under sync-debug "error". Fails
    unless there are no syncs, every frame after the first tracks and the
    launches a frame are `want`. Returns the leg's record."""
    from kinfu_tpu_torch.eval.ate import ate_rmse

    n = len(frames)
    costs = step_syncs(frames[:6], params, intr, device)
    print(f"  [{tag}] fused_mode={params.fused_mode!r}, raycast_mode={params.raycast_mode!r}, "
          f"{params.volume_dims[0]}^3: host syncs a step {costs['syncs']:g}, "
          f"{costs['ms']:.3f} ms/frame and launches a frame {costs['launches']} (frames 2-5, "
          f"sync-debug \"warn\", CUDA events) on {smi}", flush=True)
    poses, oks, inliers, frame_ms, state, launches = run_orbit(frames, params, intr, device,
                                                               no_sync=True)
    del state
    _empty_cache(device)
    ate = ate_rmse(list(poses), gt[:n])
    ms_frame = float(np.median(frame_ms[2:])) if frame_ms is not None else float("nan")
    gap = (f"; max |pose - phase 4 fused pose| {float(np.abs(poses - fused_poses[:n]).max()):.3g}"
           if fused_poses is not None else "")
    print(f"    {n} frames under sync-debug \"error\": tracked {int(oks[1:].sum())}/{n - 1} "
          f"after bootstrap; aligned ATE {ate * 1e3:.4f} mm{gap}; {ms_frame:.3f} ms/frame "
          f"(median of frames 2-{n - 1}, CUDA events); launches a frame "
          f"{ {k: v / n for k, v in sorted(launches.items())} }", flush=True)
    if costs["syncs"]:
        _fail(f"{tag}: the step synchronised the host {costs['syncs']:g} times a frame")
    if not oks[1:].all() or not np.isfinite(poses).all():
        _fail(f"{tag}: tracking failed at frames {np.nonzero(~oks[1:])[0] + 1}")
    check_counts(launches, {k: v * n for k, v in want.items()}, tag)
    return {"launches": launches, "ate": ate, "ms": ms_frame, "syncs": costs["syncs"],
            "warn_ms": costs["ms"], "warn_launches": costs["launches"]}


def _roty(deg: float, t=(0.0, 0.0, 0.0)) -> np.ndarray:
    """tests/test_pallas_integrate.py::_roty: a rotation about y, then t."""
    a = np.radians(deg)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    T[:3, 3] = t
    return T


def _rotx(deg: float, t=(0.0, 0.0, 0.0)) -> np.ndarray:
    """A rotation about x, then t (tests/test_torch_integrate_paths.py)."""
    a = np.radians(deg)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    T[:3, 3] = t
    return T


def inside_scene(name: str):
    """The scenes of INSIDE_VIEWS: tests/test_pallas_integrate.py:249's
    sphere before a plane ("backward"), and tests/test_torch_integrate_
    paths.py's room, walls at x = -1.1 and y = +-1.1 with a sphere before
    each ("room")."""
    from kinfu_tpu_torch.data.synthetic import SyntheticScene, plane, sphere

    if name == "backward":
        return SyntheticScene(primitives=[sphere((0.25, 0.0, 1.5), 0.5),
                                          plane(np.array([0.0, 0.0, 0.7]),
                                                np.array([0.0, 0.0, 1.0]))])
    return SyntheticScene(primitives=[
        plane(np.array([-1.1, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])),
        plane(np.array([0.0, 1.1, 0.0]), np.array([0.0, -1.0, 0.0])),
        plane(np.array([0.0, -1.1, 0.0]), np.array([0.0, 1.0, 0.0])),
        sphere((-0.5, 0.2, 2.2), 0.3), sphere((0.2, 0.6, 1.8), 0.25),
        sphere((-0.2, -0.6, 2.2), 0.25)])


#: cameras inside the volume (tag, scene, world from camera, the face that
#: must be live in the fusion and the raycast): tests/test_pallas_integrate
#: .py:249's 170 degrees about y, looking back along -z (with +x), and the
#: faces no orbit reaches: a yaw of -100 degrees (-x, with -z) and pitches
#: of +-90 degrees (-y and +y; the camera's y axis points down)
INSIDE_VIEWS = (("170 degrees about y", "backward", _roty(170.0, t=(0.0, 0.0, 3.3)), "-z"),
                ("yaw -100 degrees", "room", _roty(-100.0, t=(0.5, 0.0, 2.2)), "-x"),
                ("pitch +90 degrees", "room", _rotx(90.0, t=(0.0, 0.3, 2.0)), "-y"),
                ("pitch -90 degrees", "room", _rotx(-90.0, t=(0.0, -0.3, 2.0)), "+y"))


def run_inside(params, intr, device, smi: str) -> dict:
    """Phase 4e (e): each camera of INSIDE_VIEWS, at this width: one frame
    fused into a fresh volume through the fused step's update (its
    fusion, warped raycast and composite), then raycast through M2
    ("hier") and through the warped path. The faces live in the fusion
    are those that own the direction of a fused voxel, in the raycast
    those that own a hit pixel's ray (`face_counts`). Fails unless the
    view's face is live in both, no face is live that `faces_needed` /
    `faces_needed_cam2vol` gated off, M2 launched once, and the march hits
    under PARITY_MAX of the pixels that the sweep misses. Returns {tag:
    the parity numbers and the live faces}."""
    import torch

    from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.ops.face_integrate import faces_needed
    from kinfu_tpu_torch.ops.face_raycast import faces_needed_cam2vol, raycast_warped
    from kinfu_tpu_torch.ops.facewarp import face_frames
    from kinfu_tpu_torch.pipeline.kinfu import update_volume
    from kinfu_tpu_torch.tools.raycast_parity_probe import face_counts, parity_stats
    from kinfu_tpu_torch.volume.raycast import raycast
    from kinfu_tpu_torch.volume.tsdf import create_volume

    names = [f.name for f in face_frames()]
    volp = pose_from_matrix(torch.as_tensor(params.volume_pose, device=device))
    good = torch.ones((), dtype=torch.bool, device=device)
    out = {}
    for tag, scene, T, face in INSIDE_VIEWS:
        depth, color = inside_scene(scene).render_frame(T, intr)
        depth_m = torch.as_tensor(depth * np.float32(params.depth_scale), device=device)
        cam = pose_from_matrix(torch.as_tensor(T, device=device))
        vol2cam, cam2vol = compose(inverse(cam), volp), compose(inverse(volp), cam)
        vol = create_volume(params.volume_dims, device=device)
        vol, _, nmap = update_volume(vol, depth_m, vol2cam, cam2vol, good,
                                     color_rgb=torch.as_tensor(color, device=device),
                                     intr=intr, params=params, fused=True)
        kernels.reset_launch_counts()
        march = raycast(vol, cam2vol, intr, params.replace(raycast_mode="hier"))
        m_launches = kernels.LAUNCHES.get("march_hier", 0)
        warped = raycast_warped(vol, cam2vol, intr, params)
        fuse_on = {nm for nm, g in zip(names, faces_needed(vol2cam, intr).tolist()) if g}
        cast_on = {nm for nm, g in zip(names, faces_needed_cam2vol(cam2vol, intr).tolist())
                   if g}
        counts = face_counts(vol.weight, nmap, cam2vol, intr, params)
        fuse_live = {nm for nm in names if counts[nm][0] > 0}
        cast_live = {nm for nm in names if counts[nm][1] > 0}
        stats = parity_stats(*(a.cpu().numpy() for a in warped),
                             *(a.cpu().numpy() for a in march))
        print(f"  [4e] {tag} ({scene} scene) at {intr.width}x{intr.height} / "
              f"{params.volume_dims[0]}^3: gated by the fusion {sorted(fuse_on)}, by the "
              f"raycast {sorted(cast_on)}; fused voxels and hit pixels by owning face "
              f"{ {nm: c for nm, c in counts.items() if c != (0, 0)} }; M2 launched "
              f"{m_launches} time(s); the warped raycast against M2: {json.dumps(stats)}  "
              f"[{smi}]", flush=True)
        del vol, march, warped, nmap
        _empty_cache(device)
        if m_launches != 1:
            _fail(f"{tag}: the raycast launched M2 {m_launches} times, not once")
        if face not in fuse_live or face not in cast_live:
            _fail(f"{tag}: {face} is not live (fusion {sorted(fuse_live)}, raycast "
                  f"{sorted(cast_live)})")
        if not fuse_live <= fuse_on or not cast_live <= cast_on:
            _fail(f"{tag}: faces gated off wrote voxels or pixels (fusion {sorted(fuse_live)} "
                  f"of {sorted(fuse_on)}, raycast {sorted(cast_live)} of {sorted(cast_on)})")
        if not stats["march_hits_sweep_misses"] < PARITY_MAX:
            _fail(f"{tag}: the march hits {stats['march_hits_sweep_misses']:.4%} of the "
                  f"pixels that the sweep misses, not under {PARITY_MAX:.0%}")
        out[tag] = {**stats, "fusion_live": sorted(fuse_live), "raycast_live": sorted(cast_live)}
    return out


def run_marches(frames, gt, params, intr, device, tsdf, T_last, fused_poses, smi: str):
    """Phase 4e: the march raycasts on the card. (a) M1 and M2 against
    their plain twins on phase 4's final volume at its last pose, and (d)
    M1's Z-slab form (`check_marches`); (b) the orbit non-fused with
    raycast_mode "hier" and then "step" (`run_march_leg`: no host sync,
    every frame tracked, the aligned ATE <= ATE_MAX, one M2 or M1 launch a
    frame); (c) MARCH_DIM_FRAMES frames at MARCH_DIM^3, which "auto"
    resolves to "hier" (the gather integrate, M2); (e) the cameras inside
    the volume (`run_inside`). Returns (kernel results, {path: launches},
    {leg: record})."""
    import dataclasses

    from kinfu_tpu_torch.volume.raycast import resolve_raycast_mode

    t0 = time.perf_counter()
    print(f"[4e] the march raycasts: M1 and M2 against their plain twins on phase 4's final "
          f"volume at frame {len(fused_poses) - 1}'s pose", flush=True)
    res = check_marches(tsdf, T_last, params, intr, device, smi)
    n = len(frames)
    base = {"icp_normal_eqs": 19, "build_face": 1, "face_integrate": 6, "sweep_rays": 0,
            "resample_face": 0, "face_fields": 0}
    legs = {}
    for mode, key, other in (("hier", "march_hier", "march_rays"),
                             ("step", "march_rays", "march_hier")):
        p = params.replace(fused_mode="off", raycast_mode=mode)
        legs[f"march_{mode}"] = run_march_leg(frames, gt, p, intr, device, smi,
                                              {**base, key: 1, other: 0}, f"4e {mode}",
                                              fused_poses)
        if legs[f"march_{mode}"]["ate"] > ATE_MAX:
            _fail(f"4e {mode}: aligned ATE {legs[f'march_{mode}']['ate'] * 1e3:.4f} mm > "
                  f"{ATE_MAX * 1e3} mm")
    p = dataclasses.replace(params, volume_dims=(MARCH_DIM,) * 3, trunc_dist=None)
    mode = resolve_raycast_mode(p, p.volume_dims, device)
    if mode != "hier":
        _fail(f"raycast_mode 'auto' resolves to {mode!r} at {MARCH_DIM}^3 on the card, not 'hier'")
    legs[f"march_{MARCH_DIM}"] = run_march_leg(
        frames[:MARCH_DIM_FRAMES], gt, p, intr, device, smi,
        {"icp_normal_eqs": 19, "march_hier": 1, "march_rays": 0, "build_face": 0,
         "face_integrate": 0, "sweep_rays": 0, "resample_face": 0, "face_fields": 0},
        f"4e auto at {MARCH_DIM}^3 (resolved to {mode!r}, the gather integrate)")
    legs["inside"] = run_inside(params, intr, device, smi)
    print(f"  phase 4e took {time.perf_counter() - t0:.1f} s", flush=True)
    paths = {k: v["launches"] for k, v in legs.items() if k != "inside"}
    return res, paths, legs


# ---- phase 4f: the bench command --------------------------------------------

#: bench.py's JSON keys, no more and no fewer
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
#: the bench's slower paths, each run once in this process at BENCH_MODE_FRAMES
BENCH_MODES = (("--integrate", "gather"), ("--raycast", "hier"), ("--raycast", "step"),
               ("--fused", "off"))
BENCH_MODE_FRAMES = 5


def _bench_line(stdout: str, corner: bool, where: str) -> dict:
    """The bench's JSON line (its last stdout line), held to bench.py's
    keys, metric name and a finite positive value."""
    lines = stdout.strip().splitlines()
    row = json.loads(lines[-1]) if lines else {}
    metric = "ms_per_frame_640x480_512^3" + ("_corner" if corner else "")
    if set(row) != BENCH_KEYS or row["metric"] != metric or row["unit"] != "ms" \
            or not (isinstance(row["value"], float) and math.isfinite(row["value"])
                    and row["value"] > 0):
        _fail(f"{where}: the JSON line {lines[-1:]} is not bench.py's ({metric}, a finite "
              f"value > 0)")
    return row


def run_bench(device, ms_frame: float, c_ms: float, smi: str) -> dict:
    """Phase 4f: `python -m kinfu_tpu_torch bench` and `bench --corner` as
    subprocesses at their defaults (640x480, 512^3, 20 + 2 frames): each
    must exit 0 and print bench.py's JSON line; then `bench.run` once in
    this process over the orbit's long run with the loop under sync-debug
    mode "error" (the fetch after it outside), which must make no sync and
    track every frame after the first; then the bench's slower paths
    (BENCH_MODES) in this process at BENCH_MODE_FRAMES frames. Returns
    {"orbit", "corner": the JSON lines, modes: theirs}."""
    import functools
    import io

    from kinfu_tpu_torch import bench

    t0 = time.perf_counter()
    print(f"[4f] the bench command: python -m kinfu_tpu_torch bench (bench.py's workload, "
          f"method and JSON line) and bench --corner, as subprocesses", flush=True)
    out = {}
    for corner in (False, True):
        cmd = [sys.executable, "-m", "kinfu_tpu_torch", "bench"] + (["--corner"] if corner
                                                                     else [])
        t1 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, timeout=600)
        print(f"    $ {' '.join(cmd[1:])}\n      exit {res.returncode} in "
              f"{time.perf_counter() - t1:.1f} s; stdout {res.stdout.strip().splitlines()}",
              flush=True)
        for line in res.stderr.strip().splitlines()[-6:]:
            print(f"      {line}", flush=True)
        if res.returncode != 0:
            _fail(f"bench{' --corner' if corner else ''} exited {res.returncode}:\n"
                  f"{res.stderr[-3000:]}")
        out["corner" if corner else "orbit"] = _bench_line(res.stdout, corner, "bench")
    print(f"    beside: phase 4's {ms_frame:.3f} ms/frame and phase 4b's {c_ms:.3f} ms/frame "
          f"(medians of frames 2-{ORBIT_FRAMES - 1}, CUDA events) on {smi}", flush=True)

    args = bench.parse_args([])
    params, intr, depths, colors = bench.workload(args)
    step = bench.make_step_fn(params, intr)
    init = functools.partial(bench.init_state, params, intr, device)
    try:
        poses, oks, inl, dt = bench.run(step, init, depths, colors, sync_debug="error")
    except RuntimeError as e:
        _fail(f"bench.run: the timed loop synchronised the host with the device: {e}")
    print(f"    bench.run in this process over the {len(oks)} frames of the long run, the loop "
          f"under sync-debug mode \"error\": 0 syncs, {dt:.3f} s with the fetch; tracked "
          f"{int(oks[1:].sum())}/{len(oks) - 1} after the bootstrap", flush=True)
    if not oks[1:].all() or not np.isfinite(poses).all():
        _fail(f"bench.run: tracking failed at frames {np.nonzero(~oks[1:])[0] + 1}")
    del depths, colors
    _empty_cache(device)

    for mode in BENCH_MODES:
        argv = [*mode, "--frames", str(BENCH_MODE_FRAMES)]
        buf, err = io.StringIO(), io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = bench.main(argv)
        row = _bench_line(buf.getvalue(), False, f"bench {' '.join(argv)}")
        wall = [ln for ln in err.getvalue().splitlines() if "wall s" in ln or "CUDA-event" in ln]
        print(f"    bench {' '.join(argv)} (in this process): exit {rc} in "
              f"{time.perf_counter() - t1:.1f} s; {json.dumps(row)}; {' | '.join(wall)}",
              flush=True)
        out[" ".join(mode)] = row
        _empty_cache(device)
    print(f"  phase 4f took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ---- phase 4d: the sharded step on the one card ---------------------------

#: ranks of phase 4d, all on the one card (gloo stages CUDA tensors through
#: the host; NCCL refuses two ranks on one card)
SHARD_RANKS = 4
#: frames of the non-fused sharded leg
SHARD_NONFUSED_FRAMES = 10
#: the gathered sharded volume and model maps against phase 4's, with
#: tests/test_distributed.py's tolerances: TSDF mismatch above 2e-2 on under
#: 0.2% of voxels, weights differing on under 0.2%, the model maps' 99th
#: percentile gap under 2e-3 m
SHARD_TSDF_TOL = 2e-2
SHARD_TSDF_SHARE = 2e-3
SHARD_WEIGHT_SHARE = 2e-3
SHARD_VMAP_P99 = 2e-3
#: the sharded step's pose against the unsharded step's, both started from
#: the unsharded step's state (metres; the H100 gave at most 1.43e-7: the
#: ranks' sums of the normal equations round in another order)
SHARD_POSE_TOL = 1e-6
#: the sharded step's ICP inlier count against the unsharded step's from
#: the same state, relative (a pose some ulps off may flip a rint tie; a
#: rank's rows missing from the sum would cost about a quarter)
SHARD_INLIER_SHARE = 1e-4
#: the frames each sharded leg also steps from phase 4's state of the frame
#: before. Free-running, the orbit's poses part from phase 4's under any
#: change of rounding (the unsharded step with the gather ICP parts by
#: 2.7e-4 m over the 50 frames), so each step is held to the unsharded one
#: from the same state, as the CPU tests hold the port's step from each JAX
#: state; the middle one also gathers the volume and holds it to phase 4's
SHARD_FORCED = (10, 30, 45)
#: the most of a face's rays whose hit (where it comes before the back
#: event) may differ between the ranks' pmin and the unsharded K4 (the
#: composite is exact: 0 expected)
SHARD_PMIN_SHARE = 1e-3
#: where phase 4d keeps its frames and phase 4's final volume for the ranks
SHARD_OUT = REPO / "build" / "chip_smoke_shard"
#: the shard forms in the kernels line: (launch-count key, name, source, the
#: TPU kernel's call in its shard form)
SHARD_KERNELS = (
    ("icp_normal_eqs", "K1 icp_normal_eqs, row-shard form",
     "kinfu_tpu_torch/csrc/icp_normal_eqs.cu", "kinfu_tpu/ops/pallas_icp.py:149"),
    ("face_integrate", "K3 face_integrate, shard form", "kinfu_tpu_torch/csrc/face_integrate.cu",
     "kinfu_tpu/ops/pallas_integrate.py:393"),
    ("sweep_rays", "K4 sweep_rays, shard form", "kinfu_tpu_torch/csrc/sweep_rays.cu",
     "kinfu_tpu/ops/pallas_raycast.py:287"),
)


def _rank_mesh(rank: int, device, shard_dim: int):
    """A rank's `Mesh` without a process group, for the checks that run
    every rank's part in this process."""
    from kinfu_tpu_torch.parallel.mesh import Mesh

    return Mesh(world=SHARD_RANKS, rank=rank, device=device, backend="gloo",
                shard_dim=shard_dim)


def check_shard_kernels(state, frame, views, params, intr, device, phase3_k3_ms: float):
    """Phase 4d, part 1, in this process: the shard forms against their
    plain versions at the main path's shapes, on the 512^3 volume fused
    from orbit frames 0-2, cut into SHARD_RANKS Z slabs and as many Y slabs.
    For each view of `views` [(tag, world-from-camera pose, faces)] and
    shard dim: K2 on each slab's folded pose and K3 on each listed face of
    each slab (all faces gated on), bit for bit; K4 on each rank's
    halo-padded slab, hit bits equal and the back events by phase 3's rule,
    then the ranks' minimum against the unsharded K4 in the same frame set:
    the hits that come before their back events, which the shading reads
    (fails where more than SHARD_PMIN_SHARE of a face's rays differ), and
    R1 on a view's six reduced events [6, 2, F, F] as a rank shades them,
    against face_fields_plain (`check_shading`). Every
    listed face of a view but the orbit's must do real work over the
    slabs. K1's one-iteration form on each row shard of frame 3's pyramid
    against its plain version, and the shards' sum against the whole.
    Times the interior slab's +z shard forms of the orbit view (Z slabs)
    and K1's level-0 row shard beside the unsharded launches (K3's from
    phase 3, `phase3_k3_ms`). Returns
    {key: [max_abs_err, ms, plain_ms, bound_ms, bound_by, unsharded_ms]}."""
    import torch

    from kinfu_tpu_torch.frontend.maps import build_measurement_pyramid
    from kinfu_tpu_torch.geometry.se3 import Pose, compose, inverse, pose_from_matrix, rodrigues
    from kinfu_tpu_torch.ops import face_integrate as fi
    from kinfu_tpu_torch.ops import face_raycast as fr
    from kinfu_tpu_torch.ops import facewarp as fw
    from kinfu_tpu_torch.ops import icp_warped as iw
    from kinfu_tpu_torch.parallel.sharded import HALO8, ray_shard, row_shard
    from kinfu_tpu_torch.tools.sanitize import padded_slab
    from kinfu_tpu_torch.volume.integrate import fold_shard_origin
    from kinfu_tpu_torch.volume.tsdf import TSDFVolume, pack_rgb

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ms = cuda_ms if device.type == "cuda" else (lambda fn, **k: float("nan"))
    nan = float("nan")
    res = {k: [0.0, nan, nan, nan, "", nan] for k, *_ in SHARD_KERNELS}
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
    W = SHARD_RANKS

    for sd in (0, 1):
        frames_sd = fw.face_frames(sd)
        L = vol.tsdf.shape[sd]
        Ll = L // W
        for view, T, names in views:
            cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32, device=device))
            vol2cam, cam2vol = compose(inverse(cam), volp), compose(inverse(volp), cam)
            prm5 = fr.composite_params(cam2vol, params, sd)
            faces = [(f, frm) for f, frm in enumerate(frames_sd) if frm.name in names]
            prm4 = {f: fr.ray_params(prm5[f, 9:12], fw.primed_voxel_size(frm, vs), rspec, on)
                    for f, frm in faces}
            whole = {f: fr.sweep_rays(vol.tsdf, frm, prm4[f], rspec) for f, frm in faces}
            comp = {f: [torch.full((rspec.size,) * 2, 1e30, device=device)] * 2
                    for f, _ in faces}
            work = {f: 0 for f, _ in faces}
            k4_differ = 0
            for r in range(W):
                off0 = r * Ll
                tag = f"{view} {'ZY'[sd]} slab {r}"
                slab = TSDFVolume(*(a.narrow(sd, off0, Ll).contiguous() for a in vol))
                v2c = fold_shard_origin(vol2cam, off0, sd, vs)
                dims_xyz = tuple(reversed(slab.tsdf.shape))
                geo = [fw.face_geometry(v2c, frm, dims_xyz, vs) for frm in frames_sd]
                prm6 = torch.stack([fw.face_params(A, intr, on, fspec) for A, _ in geo])
                rk6, ck6, mk6 = fw.build_faces(depth_m, col_packed, prm6, fspec)
                rp6, cp6, mp6 = fw.build_faces_plain(depth_m, col_packed, prm6, fspec)
                sync()
                if not (torch.equal(rk6, rp6) and torch.equal(ck6, cp6)
                        and torch.equal(mk6, mp6)):
                    _fail(f"K2 {tag}: the stacks of the folded pose differ from the plain "
                          f"version's")
                for f, frm in faces:
                    prm3 = fi.sweep_params(geo[f][1], fw.primed_voxel_size(frm, vs), fspec,
                                           params, mk6[f].float(), on, prm6[f], intr)
                    dims_p = tuple(slab.tsdf.shape[a] for a in frm.axes)
                    table = fi.plane_table(fspec, prm3, dims_p)
                    vk = TSDFVolume(*(a.clone() for a in slab))
                    vp = TSDFVolume(*(a.clone() for a in slab))
                    fi.sweep_face(vk, frm, rk6[f], ck6[f], prm3, table)
                    n_upd, n_col = (int(c) for c in
                                    fi.sweep_face_plain(vp, frm, rk6[f], ck6[f], prm3, table))
                    sync()
                    err3 = max(int((a.int() - b.int()).abs().max()) for a, b in zip(vk, vp))
                    changed = int((vk.weight != slab.weight).sum())
                    work[f] += changed
                    if err3 or changed != n_upd:
                        _fail(f"K3 {tag} {frm.name} {frm.axes}: kernel and plain version differ "
                              f"(max |diff| {err3}, {changed} against {n_upd} voxels updated)")
                    if (sd, view, r, frm.name) == (0, "orbit", 1, "+z"):
                        res["face_integrate"][1] = ms(
                            lambda: fi.sweep_face(vk, frm, rk6[f], ck6[f], prm3, table))
                        res["face_integrate"][2] = ms(
                            lambda: fi.sweep_face_plain(vp, frm, rk6[f], ck6[f], prm3, table),
                            reps=5, warmup=1)
                        in_fp = int(fi.footprint_voxels(fi.plane_footprint(table, prm3, dims_p)))
                        res["face_integrate"][3:5] = bound(
                            8 * n_upd + 8 * n_col + nbytes(rk6[f], ck6[f], prm3, table),
                            OPS["face_integrate_gate"] * in_fp
                            + OPS["face_integrate_update"] * n_upd
                            + OPS["face_integrate_colour"] * n_col)
                    del vk, vp

                padded = padded_slab(vol.tsdf, sd, r, SHARD_RANKS, HALO8)
                for f, frm in faces:
                    sh = ray_shard(frm, padded.shape, L, Ll, off0, sd)
                    hk, bk = fr.sweep_rays(padded, frm, prm4[f], rspec, sh)
                    hp, bp = fr.sweep_rays_plain(padded, frm, prm4[f], rspec, sh)
                    sync()
                    okk, okp = (hk < bk) & (hk < 1e30), (hp < bp) & (hp < 1e30)
                    agree = float((okk == okp).float().mean())
                    both = okk & okp
                    dt4 = float((hk - hp).abs()[both].max()) if bool(both.any()) else 0.0
                    k4_differ += int((bk.view(torch.int32) != bp.view(torch.int32)).sum())
                    if not torch.equal(hk.view(torch.int32), hp.view(torch.int32)) \
                            or agree < K4_MASK_AGREE or dt4 > K4_T_TOL:
                        _fail(f"K4 {tag} {frm.name} {sh}: hit bits differ from the plain "
                              f"version's, or mask agreement {agree} / |dt| {dt4}")
                    comp[f] = [torch.minimum(comp[f][0], hk), torch.minimum(comp[f][1], bk)]
                    if (sd, view, r, frm.name) == (0, "orbit", 1, "+z"):
                        res["sweep_rays"][1] = ms(
                            lambda: fr.sweep_rays(padded, frm, prm4[f], rspec, sh))
                        res["sweep_rays"][2] = ms(
                            lambda: fr.sweep_rays_plain(padded, frm, prm4[f], rspec, sh),
                            reps=3, warmup=1)
                        n_vox, n_steps = (int(c) for c in fr.sweep_rays_work(
                            padded, frm, prm4[f], rspec, sh))
                        res["sweep_rays"][3:5] = bound(2 * n_vox + nbytes(prm4[f], hk, bk),
                                                       OPS["sweep_rays"] * n_steps)
                        res["sweep_rays"][5] = ms(
                            lambda: fr.sweep_rays(vol.tsdf, frm, prm4[f], rspec))
                del padded
            worst = 0.0
            for f, frm in faces:
                hw, bw = whole[f]
                hc, bc = comp[f]
                # what the shading reads: a hit where it comes before the back
                # event (a rank past an earlier back event may still find a
                # later hit, which the back event then masks)
                tw = torch.where((hw < bw) & (hw < 1e30), hw, 1e30)
                tc = torch.where((hc < bc) & (hc < 1e30), hc, 1e30)
                okc = tc < 1e30
                differ = int((tw.view(torch.int32) != tc.view(torch.int32)).sum())
                share = differ / hw.numel()
                worst = max(worst, share)
                if share > SHARD_PMIN_SHARE:
                    _fail(f"K4 {view} {'ZY'[sd]} {frm.name}: the ranks' minimum differs from the "
                          f"unsharded sweep on {differ} rays ({share:.3%})")
                if view != "orbit" and not work[f]:
                    _fail(f"K3 {view} {'ZY'[sd]} {frm.name}: no voxel updated over the slabs, so "
                          f"the comparison tested nothing")
                if view != "orbit" and not bool(okc.any()):
                    _fail(f"K4 {view} {'ZY'[sd]} {frm.name}: no ray hit over the slabs")
            if len(faces) == len(frames_sd):
                events = torch.stack([torch.stack(comp[f]) for f in range(len(frames_sd))])
                check_shading([e[0] for e in events], [e[1] for e in events], prm5, rspec,
                              f"{view} {'ZY'[sd]}: the ranks' reduced events "
                              f"{list(events.shape)}", device)
            print(f"  {'ZY'[sd]} slabs, {view}: faces {[frm.name for _, frm in faces]} "
                  f"({[frm.axes for _, frm in faces]}); K2, K3 bit for bit on {W} slabs, voxels "
                  f"updated {[work[f] for f, _ in faces]}; K4 hit bits equal, {k4_differ} rays "
                  f"with other back bits; ranks' minimum against the unsharded K4: worst face "
                  f"{worst:.4%} of rays differ", flush=True)
    res["face_integrate"][5] = phase3_k3_ms

    # K1's row-shard form at every level, the small increment of phase 3
    p = params
    _, cvs, cns = build_measurement_pyramid(
        torch.as_tensor(depth, device=device), intr, pyramid_height=p.pyramid_height,
        bfilter_kernel_size=p.bfilter_kernel_size, bfilter_color_sigma=p.bfilter_color_sigma,
        bfilter_spatial_sigma=p.bfilter_spatial_sigma, depth_scale=p.depth_scale,
        max_dist=p.dfilter_dist, normal_disc_threshold=p.normal_disc_threshold)
    sin_t = math.sin(math.radians(p.icp_angle_threshold))
    inc = Pose(rodrigues(torch.tensor([0.002, -0.004, 0.001], device=device)),
               torch.tensor([0.004, -0.002, 0.003], device=device))
    for level in range(p.pyramid_height):
        li = intr.level(level)
        mv, mn = state.model_vmaps[level], state.model_nmaps[level]
        tail = (mv, mn, li, p.icp_dist_threshold, sin_t)
        A, b, n = iw.icp_normal_eqs_warped(inc, cvs[level], cns[level], *tail)
        sA, sb, sn = torch.zeros_like(A), torch.zeros_like(b), 0
        for r in range(W):
            mesh = _rank_mesh(r, device, 0)
            cv, cn = row_shard(cvs[level], mesh), row_shard(cns[level], mesh)
            Ak, bk, nk = iw.icp_normal_eqs_warped(inc, cv, cn, *tail)
            Ap, bp, np_ = iw.icp_normal_eqs_warped_plain(inc, cv, cn, *tail)
            sync()
            err = max(float((Ak - Ap).abs().max()), float((bk - bp).abs().max()))
            if int(nk) != int(np_) or float((Ak - Ap).abs().max()) > K1_TOL * float(
                    Ap.abs().max()) or float((bk - bp).abs().max()) > K1_TOL * float(
                    bp.abs().max()):
                _fail(f"K1 level {level} row shard {r}: {int(nk)} inliers (plain {int(np_)}) or "
                      f"A, b beyond {K1_TOL} of their largest entry")
            res["icp_normal_eqs"][0] = max(res["icp_normal_eqs"][0], err)
            sA, sb, sn = sA + Ak, sb + bk, sn + int(nk)
            if level == 0 and r == 1:
                res["icp_normal_eqs"][1] = ms(lambda: iw.icp_normal_eqs_warped(inc, cv, cn, *tail))
                res["icp_normal_eqs"][2] = ms(
                    lambda: iw.icp_normal_eqs_warped_plain(inc, cv, cn, *tail))
                gathered = int(iw.icp_normal_eqs_warped_work(inc, cv, cn, mv, li))
                res["icp_normal_eqs"][3:5] = bound(
                    nbytes(cv, cn, Ak, bk, nk) + 24 * gathered,
                    OPS["icp_normal_eqs"] * cv.shape[0] * cv.shape[1])
                res["icp_normal_eqs"][5] = ms(
                    lambda: iw.icp_normal_eqs_warped(inc, cvs[level], cns[level], *tail))
        dA = float((sA - A).abs().max()) / max(float(A.abs().max()), 1e-30)
        db = float((sb - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        print(f"  K1 level {level}: {W} row shards of {row_shard(cvs[level], mesh).shape[0]} "
              f"rows, each equal to its plain version; their sum: {sn} inliers (whole "
              f"{int(n)}), A and b within {dA:.2g} and {db:.2g} of the whole's largest entry",
              flush=True)
        if sn != int(n) or dA > K1_TOL or db > K1_TOL:
            _fail(f"K1 level {level}: the row shards' sum differs from the whole image's")
    for key, name, *_ in SHARD_KERNELS:
        err, k_ms, p_ms, b_ms, b_by, u_ms = res[key]
        print(f"  {name}: kernel {k_ms:.4f} ms (unsharded {u_ms:.4f}), plain {p_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), max abs err {err:.3g}", flush=True)
    return res


#: a rank's slab (Z planes, Y rows, X columns) of phase 4d's deep check: the
#: Z planes of the cell shard.big-orbit's slabs at its voxel, 16 rows and
#: 256 columns so that the plain version stays quick
DEEP_SLAB = (6144, 16, 256)
#: the planes a K3 sweep schedules in 48 KB of shared memory (20 B a plane);
#: past them the launch opts in to the card's larger limit a block
K3_DEFAULT_PLANES = 48 * 1024 // 20


def check_deep_slab(frames, gts, params, intr, device) -> dict:
    """Phase 4d, part 1b, in this process: K3's shard form against its
    plain version where a sweep crosses more than K3_DEFAULT_PLANES planes,
    on SHARD_RANKS Y slabs of DEEP_SLAB, a grid of the configuration's
    voxel centred on the first camera's axis and 0.5 m ahead of it: each
    slab with its origin folded into the pose, every face gated on, bit
    for bit; frames[0] at gts[0] on the empty slabs, then frames[1] at
    gts[1] on what the kernel fused. Fails unless the +-z sweeps (a plane
    a Z plane) updated voxels. Returns the kernels line's "deep_slab":
    {planes, voxels_updated, max_abs_err, ms, plain_ms} (ms: the +z sweep
    of slab 1's second frame, CUDA events)."""
    import torch

    from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
    from kinfu_tpu_torch.ops import face_integrate as fi
    from kinfu_tpu_torch.ops import facewarp as fw
    from kinfu_tpu_torch.volume.integrate import fold_shard_origin
    from kinfu_tpu_torch.volume.tsdf import TSDFVolume, create_volume, pack_rgb

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ms = cuda_ms if device.type == "cuda" else (lambda fn, **k: float("nan"))
    nz, ny, nx = DEEP_SLAB
    W = SHARD_RANKS
    v = params.voxel_size[0]
    p = params.replace(volume_dims=(nx, ny * W, nz), volume_range=(nx * v, ny * W * v, nz * v),
                       volume_origin=(-nx * v / 2, -ny * W * v / 2, 0.5))
    vs = p.voxel_size
    volp = pose_from_matrix(torch.as_tensor(p.volume_pose, device=device))
    fspec = fw.default_face_spec()
    on = torch.ones((), dtype=torch.bool, device=device)
    frames_sd = fw.face_frames(1)
    slabs = [create_volume((nx, ny, nz), device=device) for _ in range(W)]
    out = {"planes": nz, "voxels_updated": 0, "max_abs_err": 0, "ms": float("nan"),
           "plain_ms": float("nan")}
    deep_work = 0
    for k, ((depth, color), T) in enumerate(zip(frames, gts)):
        depth_m = torch.as_tensor(depth * np.float32(p.depth_scale), device=device)
        col_packed = pack_rgb(torch.as_tensor(color, device=device))
        cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32, device=device))
        vol2cam = compose(inverse(cam), volp)
        for r, slab in enumerate(slabs):
            v2c = fold_shard_origin(vol2cam, r * ny, 1, vs)
            geo = [fw.face_geometry(v2c, frm, (nx, ny, nz), vs) for frm in frames_sd]
            prm6 = torch.stack([fw.face_params(A, intr, on, fspec) for A, _ in geo])
            rk6, ck6, mk6 = fw.build_faces(depth_m, col_packed, prm6, fspec)
            for f, frm in enumerate(frames_sd):
                prm3 = fi.sweep_params(geo[f][1], fw.primed_voxel_size(frm, vs), fspec, p,
                                       mk6[f].float(), on, prm6[f], intr)
                dims_p = tuple(slab.tsdf.shape[a] for a in frm.axes)
                table = fi.plane_table(fspec, prm3, dims_p)
                vk = TSDFVolume(*(a.clone() for a in slab))
                vp = TSDFVolume(*(a.clone() for a in slab))
                fi.sweep_face(vk, frm, rk6[f], ck6[f], prm3, table)
                n_upd = int(fi.sweep_face_plain(vp, frm, rk6[f], ck6[f], prm3, table)[0])
                sync()
                err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(vk, vp))
                changed = int((vk.weight != slab.weight).sum())
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["voxels_updated"] += changed
                if err or changed != n_upd:
                    _fail(f"K3 deep slab {r} ({nz}x{ny}x{nx}), frame {k}, {frm.name} "
                          f"{frm.axes}: kernel and plain version differ (max |diff| {err}, "
                          f"{changed} against {n_upd} voxels updated)")
                if dims_p[0] > K3_DEFAULT_PLANES:
                    deep_work += changed
                if (k, r, frm.name) == (1, 1, "+z"):
                    out["ms"] = ms(lambda: fi.sweep_face(vk, frm, rk6[f], ck6[f], prm3, table))
                    out["plain_ms"] = ms(lambda: fi.sweep_face_plain(vp, frm, rk6[f], ck6[f],
                                                                     prm3, table),
                                         reps=3, warmup=1)
                del vp
                slab = vk
            slabs[r] = slab
    if not deep_work:
        _fail(f"K3 deep slab: no voxel updated by a sweep of more than {K3_DEFAULT_PLANES} "
              f"planes, so the check tested nothing")
    print(f"  K3 shard form on {W} Y slabs of {nz}x{ny}x{nx} (+-z sweeps of {nz} planes, "
          f"{nz * 20} B of shared memory), 2 frames, every face: bit for bit, "
          f"{out['voxels_updated']} voxel updates ({deep_work} by the +-z sweeps); +z sweep "
          f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms", flush=True)
    return out


def _volume_gap(full: dict, ref: str) -> dict:
    """A gathered state (`unshard_state`) against the unsharded one saved
    at the path prefix `ref` (`save_states`): the share of voxels whose
    TSDF differs by more than SHARD_TSDF_TOL, of voxels whose weight
    differs, and the 99th percentile of the level-0 model vertex map's gap
    where both have a vertex."""
    ref_t = np.load(ref + "_tsdf.npy", mmap_mode="r")
    ref_w = np.load(ref + "_weight.npy", mmap_mode="r")
    with np.load(ref + ".npz") as z:
        ref_v = z["model_vmaps_0"]
    tsdf_share = float(np.mean(np.abs(full["tsdf"].astype(np.float32)
                                      - ref_t.astype(np.float32)) / 32767.0 > SHARD_TSDF_TOL))
    dv = full["model_vmaps"][0]
    both = (np.abs(ref_v[..., 2]) > 0) & (np.abs(dv[..., 2]) > 0)
    gap = np.abs(ref_v - dv).max(axis=-1)[both]
    return dict(tsdf_share=tsdf_share, weight_share=float(np.mean(full["weight"] != ref_w)),
                vmap_p99=float(np.percentile(gap, 99)) if gap.size else float("inf"),
                hits=int(both.sum()), weighted=int((full["weight"] > 0).sum()))


def _march_map_gap(full: dict, params, intr, device) -> dict:
    """A gathered state (`unshard_state`) of the sharded march against the
    single-device march raycast ("step": M1 on the whole volume on the
    card) of its own volume at its own pose: the pixels whose level-0
    model vertex or normal differs, the largest difference, and the pixels
    with a vertex. The composite is exact, so 0 and 0 are expected."""
    from kinfu_tpu_torch.geometry.se3 import compose, inverse
    from kinfu_tpu_torch.pipeline.kinfu import _volume_pose
    from kinfu_tpu_torch.pipeline.state import state_from_numpy
    from kinfu_tpu_torch.volume.raycast import raycast

    state = state_from_numpy(full, device=device)
    cam2vol = compose(inverse(_volume_pose(params, device)), state.pose)
    rv, rn = raycast(state.vol, cam2vol, intr, params)
    dv = np.abs(rv.cpu().numpy() - full["model_vmaps"][0]).max(axis=-1)
    dn = np.abs(rn.cpu().numpy() - full["model_nmaps"][0]).max(axis=-1)
    del state
    return dict(differ=int(((dv != 0) | (dn != 0)).sum()), max=float(max(dv.max(), dn.max())),
                hits=int((np.abs(full["model_vmaps"][0][..., 2]) > 0).sum()))


def _load_state(prefix: str) -> dict:
    """The fields of `state_to_numpy` saved at `prefix` by `save_states`,
    the volume memory-mapped (a rank reads its slab only)."""
    d = {k: np.load(f"{prefix}_{k}.npy", mmap_mode="r") for k in ("tsdf", "weight", "color")}
    with np.load(prefix + ".npz") as z:
        d.update(pose=z["pose"], frame_count=z["frame_count"],
                 model_vmaps=[z[f"model_vmaps_{i}"] for i in range(int(z["levels"]))],
                 model_nmaps=[z[f"model_nmaps_{i}"] for i in range(int(z["levels"]))])
    return d


def _shard_rank(mesh, job):
    """Phase 4d, part 2, one rank (a process of its own): each leg of
    `job["legs"]` [(path, shard dim, params, frames)] from a fresh state
    through the sharded step on this rank's device, the launch and
    collective counts set to 0 just before and read just after; frames 2-4
    run under sync-debug mode "warn", counting its warnings from the step's
    thread and from gloo's (which print to stderr). Then, for each frame k
    of `job["forced"]`, one sharded step of frame k from phase 4's state
    after frame k - 1 (`shard_state`), gathering the volume after the
    middle one (`unshard_state`), which rank 0 holds against phase 4's and,
    on the march leg, against the single-device march of itself
    (`_march_map_gap`). Returns {path: record}."""
    import dataclasses
    import os
    import tempfile
    import warnings

    import torch
    import torch.distributed as dist

    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.parallel import mesh as pmesh
    from kinfu_tpu_torch.parallel.sharded import (
        init_state_local,
        make_sharded_step_fn,
        shard_state,
        unshard_state,
    )

    with np.load(job["frames"]) as z:
        depths, colors = z["depth"], z["color"]
    intr = job["intr"]
    out = {}
    for path, sd, params, n in job["legs"]:
        m = dataclasses.replace(mesh, shard_dim=sd)
        step = make_sharded_step_fn(params, intr, m)
        state = init_state_local(params, intr, m)
        frames = [(torch.as_tensor(depths[k], device=m.device),
                   torch.as_tensor(colors[k], device=m.device)) for k in range(n)]
        on_card = m.device.type == "cuda"
        _sync(m.device)
        dist.barrier()
        kernels.reset_launch_counts()
        pmesh.reset_collective_counts()
        outs, events, syncs = [], [], []
        for k, (d, c) in enumerate(frames):
            count = on_card and 2 <= k <= 4
            a = torch.cuda.Event(enable_timing=True) if on_card else None
            if on_card:
                a.record()
            # the step's own thread warns through Python; gloo's worker
            # threads, which stage CUDA tensors through the host, print from
            # C++ to stderr, which is read from a file here
            with warnings.catch_warnings(record=True) as caught, \
                    tempfile.TemporaryFile() as err:
                warnings.simplefilter("always")
                if count:
                    saved = os.dup(2)
                    os.dup2(err.fileno(), 2)
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    state, o = step(state, d, c)
                finally:
                    if count:
                        torch.cuda.set_sync_debug_mode("default")
                        _sync(m.device)
                        os.dup2(saved, 2)
                        os.close(saved)
                        err.seek(0)
                        syncs.append((sum("called a synchronizing CUDA operation"
                                          in str(w.message) for w in caught),
                                      err.read().count(b"called a synchronizing CUDA operation")))
            if on_card:
                b = torch.cuda.Event(enable_timing=True)
                b.record()
                events.append((a, b))
            outs.append(o)
        _sync(m.device)
        rec = dict(launches=dict(kernels.LAUNCHES), collectives=dict(pmesh.COLLECTIVES),
                   syncs=syncs,
                   ms=[a.elapsed_time(b) for a, b in events] if on_card else [float("nan")] * n,
                   poses=np.stack([o.pose_matrix.cpu().numpy() for o in outs]),
                   oks=np.array([bool(o.tracking_ok) for o in outs]),
                   inliers=np.array([int(o.icp_inliers) for o in outs]))
        del state
        rec["forced"] = {}
        forced = job["forced"]
        for k in forced:
            state = shard_state(_load_state(f"{job['states']}{k - 1}"), m)
            state, o = step(state, torch.as_tensor(depths[k], device=m.device),
                            torch.as_tensor(colors[k], device=m.device))
            rec["forced"][k] = (o.pose_matrix.cpu().numpy(), bool(o.tracking_ok),
                                int(o.icp_inliers))
            if k == forced[1]:
                full = unshard_state(state, m)
                if m.rank == 0:
                    rec["forced_volume"] = _volume_gap(full, f"{job['states']}{k}")
                    if params.raycast_mode == "step":
                        rec["march_gap"] = _march_map_gap(full, params, intr, m.device)
                del full
            del state
        del frames
        _empty_cache(m.device)
        out[path] = rec
    if job.get("profile"):
        out["profile"] = _profile_rank(mesh, job, depths, colors)
    return out


def _profile_rank(mesh, job, depths, colors, first: int = 2, n: int = 6):
    """Z-sharded fused steps of frames 0..n-1 from a fresh state on every
    rank, rank 0 under torch.profiler for frames first..n-1 (the profiler
    stays off until the rank's other work is done: once started, it slows
    every later launch). Returns rank 0's device ms a frame of each port
    kernel, its launches a frame, and its busy ms a frame; the ranks share
    the card, so a kernel's span may include other ranks' time slices."""
    import dataclasses

    import torch

    from kinfu_tpu_torch.parallel.sharded import init_state_local, make_sharded_step_fn
    from kinfu_tpu_torch.tools.trace_step import profile

    params = job["legs"][0][2]
    m = dataclasses.replace(mesh, shard_dim=0)
    step = make_sharded_step_fn(params, job["intr"], m)
    state = init_state_local(params, job["intr"], m)
    frames = [(torch.as_tensor(depths[k], device=m.device),
               torch.as_tensor(colors[k], device=m.device)) for k in range(n)]
    for d, c in frames[:first]:
        state, _ = step(state, d, c)
    _sync(m.device)
    rest = iter(frames[first:])
    box = [state]

    def one():
        d, c = next(rest)
        box[0], _ = step(box[0], d, c)

    if m.rank != 0:
        for _ in range(n - first):
            one()
        _sync(m.device)
        return None
    prof = profile(one, n - first, m.device)
    out = {"busy": prof.busy_ms, "launches": prof.count}
    for key, *_ in KERNELS:
        mine = prof.kernel(key)
        out[key] = (sum(mine) / prof.calls, len(mine) / prof.calls)
    return out


def save_states(frames, params, intr, device, keep) -> Path:
    """The unsharded step over `frames` from a fresh state, each state after
    a frame of `keep` saved under SHARD_OUT (the volume as .npy files, the
    rest in an .npz) for the ranks of phase 4d; the run repeats phase 4's
    bits. Returns the path prefix, to which the frame index is added."""
    import torch

    from kinfu_tpu_torch.pipeline.kinfu import init_state, make_step_fn
    from kinfu_tpu_torch.pipeline.state import state_to_numpy

    prefix = SHARD_OUT / "state"
    step = make_step_fn(params, intr)
    state = init_state(params, intr, device=device)
    for k, (d, c) in enumerate(frames[:max(keep) + 1]):
        state, _ = step(state, torch.as_tensor(d, device=device),
                        torch.as_tensor(c, device=device))
        if k in keep:
            s = state_to_numpy(state)
            for key in ("tsdf", "weight", "color"):
                np.save(f"{prefix}{k}_{key}.npy", s[key])
            np.savez(f"{prefix}{k}.npz", pose=s["pose"], frame_count=s["frame_count"],
                     levels=len(s["model_vmaps"]),
                     **{f"model_vmaps_{i}": v for i, v in enumerate(s["model_vmaps"])},
                     **{f"model_nmaps_{i}": v for i, v in enumerate(s["model_nmaps"])})
    del state
    _empty_cache(device)
    return prefix


def run_sharded(frames, gt, params, intr, device, fused_poses, fused_inliers, nf_poses,
                gather_gap: float, smi, profile: bool):
    """Phase 4d, part 2: SHARD_RANKS ranks on the one card (gloo, "spawn"
    processes that load the kernels phase 2 built) run the orbit's frames
    through the sharded step: all of them Z-sharded and fused, all of them
    Y-sharded and fused (the +-x faces, live on frames 19-49, sweep in the
    (2, 1, 0) frame), SHARD_NONFUSED_FRAMES Z-sharded with
    fused_mode="off", and as many with fused_mode="off" and
    raycast_mode="step" (the march raycast over the slabs: M1's Z-slab
    form); then each leg steps each frame of SHARD_FORCED from phase 4's
    state. Fails unless every rank gives the same poses, every frame after
    the first tracks, the aligned ATE is <= 1 mm, each rank launches K1 19
    times a frame, K2 and K5 once, K3 and K4 six times (a launch a face,
    each reading its gate; on the march leg M1 once in place of K4 and
    K5), and each step from phase 4's
    state gives phase 4's pose within SHARD_POSE_TOL and its ICP inlier
    count within SHARD_INLIER_SHARE (the non-fused step tracks as the fused
    one does) and, at the middle frame, its volume and model map within
    tests/test_distributed.py's tolerances (the march leg's model map,
    raycast otherwise than phase 4's, is printed there, and held instead
    to the single-device march of the gathered volume, which it must equal
    on every pixel). Prints the
    free-running legs' pose gap against phase 4's (4c's), ungated, over all their frames and
    over the first GATHER_FRAMES beside `gather_gap`, the gap of phase 4's
    gather-ICP leg over those frames. With `profile`, rank 0
    also runs Z-sharded steps under torch.profiler. Returns {path:
    launches summed over the ranks} and the legs' ms/frame."""
    from kinfu_tpu_torch.eval.ate import ate_rmse
    from kinfu_tpu_torch.parallel.mesh import spawn

    n = len(frames)
    t0 = time.perf_counter()
    np.savez(SHARD_OUT / "frames.npz", depth=np.stack([d for d, _ in frames]),
             color=np.stack([c for _, c in frames]))
    keep = {SHARD_FORCED[1], *(k - 1 for k in SHARD_FORCED)}
    states = save_states(frames, params, intr, device, keep)
    legs = [("sharded_z", 0, params, n), ("sharded_y", 1, params, n),
            ("sharded_nonfused", 0, params.replace(fused_mode="off"), SHARD_NONFUSED_FRAMES),
            ("sharded_march", 0, params.replace(fused_mode="off", raycast_mode="step"),
             SHARD_NONFUSED_FRAMES)]
    print(f"  phase 4's states after frames {sorted(keep)} saved in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  {SHARD_RANKS} ranks on the one card (gloo): the orbit's {n} frames Z-sharded "
          f"and Y-sharded (fused), {SHARD_NONFUSED_FRAMES} frames Z-sharded non-fused with the "
          f"warped raycast and as many with the march (raycast_mode 'step'); each leg "
          f"then steps frames {SHARD_FORCED} from phase 4's state", flush=True)
    t0 = time.perf_counter()
    ranks = spawn(_shard_rank, SHARD_RANKS, dict(frames=str(SHARD_OUT / "frames.npz"), intr=intr,
                                                 legs=legs, states=str(states),
                                                 forced=SHARD_FORCED, profile=profile),
                  backend="gloo", device=device.type, threads=2, workdir=str(SHARD_OUT))
    print(f"  the ranks ran in {time.perf_counter() - t0:.1f} s (start-up included)", flush=True)
    prof = ranks[0].get("profile")
    if prof:
        print(f"  rank 0 of the Z-sharded step under torch.profiler, frames 2-5: kernels busy "
              f"{prof['busy']:.3f} ms/frame in {prof['launches']:.0f} launches; "
              + "; ".join(f"{name} {prof[key][0]:.4f} ms/frame in {prof[key][1]:g} launches"
                          for key, name, *_ in KERNELS)
              + " (the 4 ranks share the card: a span may hold other ranks' time slices)",
              flush=True)
    launches, ms = {}, {}
    for path, sd, p, m in legs:
        recs = [r[path] for r in ranks]
        poses, oks = recs[0]["poses"], recs[0]["oks"]
        same = all(np.array_equal(r["poses"], poses) for r in recs)
        ate = ate_rmse(list(poses), gt[:m])
        ref = nf_poses if p.fused_mode == "off" else fused_poses
        gap = float(np.abs(poses - ref[:m]).max())
        gap_g = float(np.abs(poses[:GATHER_FRAMES] - ref[:GATHER_FRAMES]).max())
        ms[path] = float(np.median([np.median(r["ms"][2:]) for r in recs]))
        coll = recs[0]["collectives"]
        per_frame = {k: v / m for k, v in sorted(coll.items()) if not k.endswith("_bytes")}
        mb = {k[:-6]: round(v / m / 2**20, 3) for k, v in sorted(coll.items())
              if k.endswith("_bytes")}
        launches[path] = {k: sum(r["launches"].get(k, 0) for r in recs)
                          for k in recs[0]["launches"]}
        print(f"  [{path}] shard dim {sd}, fused_mode={p.fused_mode!r}: tracked "
              f"{int(oks[1:].sum())}/{m - 1} after the bootstrap; aligned ATE {ate * 1e3:.4f} mm; "
              f"ranks agree: {same}", flush=True)
        print(f"    {ms[path]:.3f} ms/frame a rank (median over the ranks of each one's median "
              f"of frames 2-{m - 1}, CUDA events) with {SHARD_RANKS} ranks sharing one card on "
              f"{smi}: not a speed measure of a {SHARD_RANKS}-card mesh", flush=True)
        print(f"    collectives a frame (rank 0): {per_frame}, MiB a frame {mb}; host syncs a "
              f"step under sync-debug \"warn\" (frames 2-4, each rank, (the step's thread, "
              f"gloo's threads)): {[r['syncs'] for r in recs]}; launches a frame a rank: "
              f"{ {k: v / m for k, v in sorted(recs[0]['launches'].items())} }", flush=True)
        if not same:
            _fail(f"{path}: the ranks' poses differ")
        if not oks[1:].all() or not np.isfinite(poses).all():
            _fail(f"{path}: tracking failed at frames {np.nonzero(~oks[1:])[0] + 1}")
        if ate > ATE_MAX:
            _fail(f"{path}: aligned ATE {ate * 1e3:.4f} mm > {ATE_MAX * 1e3} mm")
        forced = {k: float(np.abs(recs[0]["forced"][k][0] - fused_poses[k]).max())
                  for k in SHARD_FORCED}
        inl = {k: (recs[0]["forced"][k][2], int(fused_inliers[k])) for k in SHARD_FORCED}
        print(f"    free-running, the poses part from phase "
              f"{'4c' if p.fused_mode == 'off' else '4'}'s by {gap:.3g} m over {m} frames and "
              f"{gap_g:.3g} m over the first {GATHER_FRAMES} (phase 4's gather-ICP leg: "
              f"{gather_gap:.3g} m; printed, not gated); "
              f"one step from phase 4's state: |pose - phase 4 pose| at frames {forced}, ICP "
              f"inliers (sharded, phase 4) {inl}", flush=True)
        if any(not r["forced"][k][1] or not np.array_equal(r["forced"][k][0],
                                                           recs[0]["forced"][k][0])
               for r in recs for k in SHARD_FORCED):
            _fail(f"{path}: a step from phase 4's state lost tracking or the ranks differ")
        if max(forced.values()) > SHARD_POSE_TOL:
            _fail(f"{path}: a step from phase 4's state is {max(forced.values())} m from "
                  f"phase 4's pose")
        if any(abs(a - b) > SHARD_INLIER_SHARE * b for a, b in inl.values()):
            _fail(f"{path}: a step from phase 4's state counts other ICP inliers: {inl}")
        march = p.raycast_mode == "step"
        raycast = ({"march_rays": m, "sweep_rays": 0, "resample_face": 0, "face_fields": 0}
                   if march else {"resample_face": m, "face_fields": m, "sweep_rays": 6 * m})
        for r, rec in enumerate(recs):
            check_counts(rec["launches"], {"icp_normal_eqs": 19 * m, "build_face": m,
                                           "face_integrate": 6 * m, **raycast},
                         f"{path}, rank {r}")
        v = recs[0]["forced_volume"]
        print(f"    the volume of frame {SHARD_FORCED[1]} stepped from phase 4's state against "
              f"phase 4's: TSDF beyond {SHARD_TSDF_TOL} on {v['tsdf_share']:.4%} of voxels, "
              f"weights differ on {v['weight_share']:.4%} ({v['weighted']} weighted voxels); "
              f"model map 99th percentile gap {v['vmap_p99']:.3g} m over {v['hits']} pixels"
              f"{' (the march against the warped raycast: printed, not gated)' if march else ''}",
              flush=True)
        if (v["tsdf_share"] >= SHARD_TSDF_SHARE or v["weight_share"] >= SHARD_WEIGHT_SHARE
                or (v["vmap_p99"] >= SHARD_VMAP_P99 and not march) or not v["hits"]):
            _fail(f"{path}: the volume of frame {SHARD_FORCED[1]} differs from phase 4's")
        if march:
            g = recs[0]["march_gap"]
            print(f"    its model maps against the single-device march (M1 on the whole "
                  f"gathered volume, its pose): {g['differ']} of {g['hits']} hit pixels differ, "
                  f"largest difference {g['max']:.3g}", flush=True)
            if g["differ"] or not g["hits"]:
                _fail(f"{path}: the sharded march's model maps differ from the single-device "
                      f"march on {g['differ']} pixels (largest {g['max']:.3g})")
        if sd == 1:
            gates = face_gates(poses, oks, params, intr, device)
            print(f"    faces gated on a frame: {gate_runs(gates)}", flush=True)
            if not gates[:, [2, 5]].any():
                _fail(f"{path}: no +-x face went live, so the (2, 1, 0) frame never ran")
    return launches, ms


def run_sweep(cli_dir: Path, session_poses, n: int):
    """Phase 4d, part 3: `python -m kinfu_tpu_torch sweep --devices 2` (two
    ranks on the one card, gloo) over two copies of phase 5b's PNG dataset
    at 512^3, each sequence's poses written to disk. Fails unless the
    command exits 0, prints one JSON line per sequence with no tracking
    failure, and each sequence's poses are the session's over the same
    PNGs (phase 5b) within SESSION_POSE_TOL. Returns the launches the ranks
    report."""
    import shutil

    from kinfu_tpu_torch.io.poses import read_poses_reference_format

    data = cli_dir / "data"
    copy = SHARD_OUT / "data_copy"
    out = SHARD_OUT / "sweep_poses"
    for d in (copy, out):
        if d.exists():
            shutil.rmtree(d)
    shutil.copytree(data, copy)
    cmd = [sys.executable, "-m", "kinfu_tpu_torch", "sweep", "--devices", "2", "--synthetic",
           "0", "--data", str(data), "--data", str(copy), "--frames", str(n), "--dims", "512",
           "--save-poses", str(out)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, timeout=600)
    print(f"  $ {' '.join(cmd[1:])}\n    exit {res.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if res.returncode != 0:
        _fail(f"sweep exited {res.returncode}:\n{res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    launches = json.loads(next(ln for ln in lines if ln.startswith("# launches"))
                          .split(":", 1)[1])
    for ln in lines:
        print(f"    {ln}", flush=True)
    if len(rows) != 2 or any(r["tracking_failures"] or r["frames"] != n for r in rows):
        _fail(f"sweep: rows {rows}")
    for name in ("data", "data_copy"):
        poses = np.stack(read_poses_reference_format(str(out / f"{name}_512.txt")))
        gap = float(np.abs(poses - np.stack(session_poses[:n])).max())
        print(f"    {name}: max |pose - phase 5b session pose| {gap:.3g}", flush=True)
        if gap > SESSION_POSE_TOL:
            _fail(f"sweep: {name}'s poses are {gap} from the session's over the same PNGs")
    return launches


# ---- phase 3c: raycast parity; phase 7: the checked build ------------------

#: DIVERGENCES.md item 20, ACCURACY.md:27-30: the share of pixels that the
#: unit-step march hits and the warped sweep misses must stay under 1%
PARITY_MAX = 0.01
#: the checked build's runs (tools/sanitize.py), seconds each at most
SANITIZE_TIMEOUT = 300


def run_parity(params, intr, device, smi: str) -> None:
    """Phase 3c: kinfu_tpu_torch/tools/raycast_parity_probe.py at the main
    path's size, one frame fused at the identity pose: the warped raycast
    (K4 and K5) against the unit-step march. Fails where the march hits
    PARITY_MAX of the pixels or more that the sweep misses."""
    from kinfu_tpu_torch.tools.raycast_parity_probe import probe

    t0 = time.perf_counter()
    res = probe(params, intr, device)
    print(f"[3c] raycast parity, warped sweep against the unit-step march "
          f"({time.perf_counter() - t0:.1f} s) on {smi}: {json.dumps(res)}", flush=True)
    if not res["march_hits_sweep_misses"] < PARITY_MAX:
        _fail(f"raycast parity: the march hits {res['march_hits_sweep_misses']:.4%} of the "
              f"pixels that the sweep misses, not under {PARITY_MAX:.0%}")


def run_sanitizer(smi: str) -> None:
    """Phase 7: kinfu_tpu_torch/tools/sanitize.py in child processes, in the
    bounds-checked build of the kernels (compute-sanitizer refuses this
    card's machine): every kernel form at the main path's shapes and at
    test scale, each run ending without a fault and launching each of the
    kernels K1-K5 and R1, M1, M2 and S1; then the negative run, K5 with an output one row short,
    which must trap, or the check is not live."""
    from kinfu_tpu_torch.tools import sanitize

    for scale in ("main", "test"):
        r = sanitize.run_child(scale, timeout=SANITIZE_TIMEOUT)
        print(f"[7] checked build, every kernel form at scale {scale}: rc {r['rc']}, "
              f"{r['seconds']:.1f} s, launches {r['launches']}  [{smi}]", flush=True)
        if r["rc"] != 0 or r["launches"] is None:
            print(r["output"][-4000:], flush=True)
            _fail(f"the checked build's run at scale {scale} failed (a kernel indexed outside "
                  f"its arrays: {r['trap']})")
        for key, name, *_ in KERNELS + MARCH_KERNELS + (SHIFT_KERNEL,):
            if r["launches"].get(key, 0) <= 0:
                _fail(f"{name} was not launched in the checked build's run at scale {scale}")
    r = sanitize.run_child(negative=True, timeout=SANITIZE_TIMEOUT)
    out = r["output"]
    caught = (r["rc"] != 0 and "negative: launched" in out and "negative: no fault" not in out
              and "CUDA error" in out)
    print(f"[7] negative run, K5 with a vertex buffer one row short: rc {r['rc']}, "
          f"{r['seconds']:.1f} s, trapped: {caught}; the kernel's report: {r['trap']}", flush=True)
    if not caught:
        print(out[-4000:], flush=True)
        _fail("the checked build did not trap on an output one row short: the check is not live")


#: launches of each kernel form in phase 7b, on each grid it takes
REPEAT_LAUNCHES = 20


def run_repeat(smi: str) -> dict:
    """Phase 7b: kinfu_tpu_torch/tools/sanitize.py --repeat in a child
    process, in the normal build: every kernel form of phase 7 at the main
    path's shapes, REPEAT_LAUNCHES launches on the same inputs with every
    output and K1's partials filled with a sentinel before each, and as
    many on a second grid for K1 and K3 (the stand-in for racecheck,
    initcheck and synccheck, which refuse this card). Fails unless every
    launch gives its form's first bits (on the second grid K3 the same
    bits, K1 its tolerances, `sanitize.k1_close` and `k1_finish_close`), K1's ticket
    reads 0 after each, and every kernel launched. Returns {form: record}."""
    from kinfu_tpu_torch.tools import sanitize

    r = sanitize.run_child("main", repeat=REPEAT_LAUNCHES, timeout=SANITIZE_TIMEOUT)
    for line in r["output"].splitlines():
        if line.startswith("  "):
            print(f"   {line}", flush=True)
    records = r["repeat"] or {}
    bad = sorted(k for k, v in records.items() if not v["ok"])
    print(f"[7b] {REPEAT_LAUNCHES} sentinel-filled launches of each of {len(records)} kernel "
          f"forms (the normal build, 640x480 / 512^3; K1 also at {sanitize.K1_GRID2} blocks, "
          f"K3 on a {sanitize.K3_GRID2}-block grid): rc {r['rc']}, {r['seconds']:.1f} s, "
          f"{len(bad)} forms differ, launches {r['launches']}  [{smi}]", flush=True)
    if r["rc"] != 0 or r["launches"] is None or not records:
        print(r["output"][-4000:], flush=True)
        _fail("the repeat-launch run failed")
    if bad:
        _fail(f"kernel forms whose repeated launches differ: {bad}")
    for key, name, *_ in KERNELS + MARCH_KERNELS + (SHIFT_KERNEL,):
        if r["launches"].get(key, 0) <= 0:
            _fail(f"{name} was not launched in the repeat-launch run")
    return records


# ---- phase 5f: the session's step replayed from CUDA graphs ---------------

#: the benchmark's cells (kfbench/) of phase 5f: (cell, frames before the
#: blank depth frame, None: until the grid has shifted on GRAPH_SHIFTED
#: frames; frames after it; frames from the reset on)
GRAPH_LEGS = (("pcl512.orbit", 50, 10, 5), ("stream512.corridor", None, 10, 5))
GRAPH_SEED = 2**33 + 16
GRAPH_SHIFTED = 100
#: the state's tensors, in `pipeline/graphed.py::state_tensors` order
STATE_FIELDS = ("tsdf", "weight", "colour", "pose R", "pose t")


def _state_names(state) -> list:
    ks = getattr(state, "kinfu", state)
    n = len(ks.model_vmaps)
    return (list(STATE_FIELDS) + [f"vmap {i}" for i in range(n)]
            + [f"nmap {i}" for i in range(n)] + ["frame count"]
            + (["origin"] if ks is not state else []))


def run_graphs(device, smi: str) -> dict:
    """Phase 5f: a graphed session (pipeline/graphed.py) and an eager one
    side by side, each frame's arrays handed to both, on the benchmark's
    configurations and mixes: the orbit on kinfu-pcl-512, the corridor on
    kinfu-stream-512 until the grid has shifted on GRAPH_SHIFTED frames,
    then in each a blank depth frame (tracking fails, and the step resets
    the state on the device), the frames after it, `reset()` and a few
    frames more. At every frame the tracking flags, the poses, the model
    maps, the volume, the frame count, the grid's origin and the kernels'
    launch counts must be equal bit for bit; the graphs are captured once;
    one more frame traced under torch.profiler launches one graph a
    segment, and no device operation of the graphs copies from the host.
    Returns {cell: frames compared}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kfbench import gen, harness
    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.pipeline.graphed import GraphedStep, state_tensors

    print(f"[5f] the step replayed from CUDA graphs: a graphed and an eager session side by "
          f"side on {', '.join(c for c, *_ in GRAPH_LEGS)} (seed {GRAPH_SEED})", flush=True)
    out = {}
    for cell, before, after, after_reset in GRAPH_LEGS:
        t_leg = time.perf_counter()
        entry = harness.load_cell(cell)
        traffic = gen.Traffic(entry["mix"], GRAPH_SEED, harness._camera(entry["config"]),
                              device)
        graphed = harness.make_session(entry["config"], device)
        eager = harness.make_session(entry["config"], device)
        if not isinstance(graphed._step, GraphedStep):
            _fail(f"graphs: the {cell} session does not capture its step")
        # the eager session: the step as every other path runs it
        eager._graphed, eager._step = False, eager._step.step
        names = _state_names(graphed.state)
        log = {"ok": [], "ms": ([], []), "diffs": [], "shifts": 0, "segments": None}
        origin = [None]

        def one(k: int, kind: str) -> None:
            color, depth = traffic.frame(k)
            if kind == "blank":
                depth = np.zeros_like(depth)
            if kind == "reset":
                graphed.reset()
                eager.reset()
            res = []
            for j, sess in enumerate((eager, graphed)):
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                ok = sess.pipeline(color, depth)
                log["ms"][j].append((time.perf_counter() - t0) * 1e3)
                res.append((ok, dict(kernels.LAUNCHES)))
            i = len(log["ok"])
            log["ok"].append((kind, res[1][0]))
            differ = [nm for nm, a, b in zip(names, state_tensors(eager.state),
                                             state_tensors(graphed.state))
                      if not torch.equal(a, b)]
            if not np.array_equal(eager.get_cur_camera_pose(), graphed.get_cur_camera_pose()):
                differ.append("pose record")
            if res[0][0] != res[1][0]:
                differ.append("tracking flag")
            if res[0][1] != res[1][1]:
                differ.append(f"launches {res[0][1]} / {res[1][1]}")
            if differ:
                log["diffs"].append((i, k, kind, differ))
            segs = graphed._step.segments
            if segs is not None:
                if log["segments"] is None:
                    log["segments"] = (i, segs)
                elif segs is not log["segments"][1]:
                    _fail(f"graphs: {cell} captured its step again at frame {i}")
            if graphed.streaming:
                o = graphed.state.origin_vox.cpu()
                log["shifts"] += origin[0] is not None and bool((o != origin[0]).any())
                origin[0] = o

        k = 0
        while (log["shifts"] < GRAPH_SHIFTED) if before is None else (k < before):
            one(k, "frame")
            k += 1
        one(k, "blank")
        for _ in range(after):
            one(k, "frame")
            k += 1
        for j in range(after_reset):
            one(k, "reset" if j == 0 else "frame")
            k += 1
        n = len(log["ok"])
        if log["segments"] is None:
            _fail(f"graphs: {cell} never replayed its step")
        first, segs = log["segments"]
        print(f"    {cell}: {n} frames compared ({first} eager, {n - first} replayed; "
              f"grid shifted on {log['shifts']}); segments (span: nodes, launches): "
              + "; ".join(f"{s.name or 'glue'}: {s.nodes}, {sum(s.launches.values())}"
                          for s in segs), flush=True)
        print(f"    host ms a frame, median of the replayed frames: eager "
              f"{np.median(log['ms'][0][first:]):.3f}, graphed "
              f"{np.median(log['ms'][1][first:]):.3f} on {smi}", flush=True)
        for d in log["diffs"][:5]:
            print(f"    frame {d[0]} (traffic frame {d[1]}, {d[2]}): differs in {d[3]}",
                  flush=True)
        if log["diffs"]:
            _fail(f"graphs: {cell}: the graphed session differs from the eager one on "
                  f"{len(log['diffs'])} of {n} frames")
        failed = [i for i, (kind, ok) in enumerate(log["ok"]) if ok != (kind != "blank")]
        if failed:
            _fail(f"graphs: {cell}: frames {failed} tracked where they should have failed or "
                  f"failed where they should have tracked")
        if before is None and log["shifts"] < GRAPH_SHIFTED:
            _fail(f"graphs: {cell}: the grid shifted on {log['shifts']} frames only")

        # one more frame, traced: one graph launch a segment, no copy from
        # the host but the upload's two
        color, depth = traffic.frame(k)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graphed.pipeline(color, depth)
            torch.cuda.synchronize()
        eager.pipeline(color, depth)
        evs = list(prof.profiler.kineto_results.events())
        launches = {e.correlation_id() for e in evs
                    if e.name().startswith(("cudaGraphLaunch", "cuGraphLaunch"))}
        on_device = [e for e in evs if e.device_type() == DeviceType.CUDA]
        replayed = [e.name() for e in on_device if e.correlation_id() in launches]
        htod = [n for n in replayed if "HtoD" in n]
        same = all(torch.equal(a, b)
                   for a, b in zip(state_tensors(eager.state), state_tensors(graphed.state)))
        print(f"    a traced replayed frame: {len(launches)} graph launches, running "
              f"{len(replayed)} device operations (the graphs hold "
              f"{sum(s.nodes for s in segs)} nodes), of them copies from the host {htod}; "
              f"the frame's other copies from the host "
              f"{[e.name() for e in on_device if 'HtoD' in e.name() and e.name() not in htod]}; "
              f"the states equal after it: {same}; the leg took "
              f"{time.perf_counter() - t_leg:.1f} s", flush=True)
        if len(launches) != len(segs) or not replayed or htod or not same:
            _fail(f"graphs: {cell}: a replayed frame launched {len(launches)} graphs for "
                  f"{len(segs)} segments, running {len(replayed)} operations, {htod} copies "
                  f"from the host; states equal {same}")
        out[cell] = n + 1
        del graphed, eager, traffic
        torch.cuda.empty_cache()
    return out


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


#: the step configurations of --count-syncs (fused_mode, raycast_mode): the
#: main path, and the non-fused step with each march raycast
COUNT_SYNCS_MODES = (("auto", "auto"), ("off", "hier"), ("off", "step"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-table", metavar="PATH",
                    help=f"where to write the full profiler table (default: {PROFILE_TABLE}); "
                         "given, phase 4d also profiles rank 0 of the Z-sharded step")
    ap.add_argument("--graphs", action="store_true",
                    help="only run phase 5f (the step replayed from CUDA graphs against the "
                         "eager step, on the benchmark's cells) and exit, printing no result")
    ap.add_argument("--deep-slab", action="store_true",
                    help="only run phase 4d's K3 check on slabs of 6,144 planes (the shard "
                         "form past 48 KB of shared memory) and exit, printing its result")
    ap.add_argument("--shift", action="store_true",
                    help="only run phase 5e's check of S1, the in-place shift kernel, against "
                         "its plain twin on a seeded random 512^3 volume and its times, and "
                         "exit, printing its result")
    ap.add_argument("--count-syncs", action="store_true",
                    help="only count the host syncs of a step (frames 2-5 of the orbit, "
                         "under sync-debug mode \"warn\"), with its launches and ms a "
                         "frame, for each of COUNT_SYNCS_MODES, and exit, printing no result")
    args = ap.parse_args()
    table = args.profile_table or str(PROFILE_TABLE)

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
    print(f"[2] built the kernels of {kernels.CSRC.relative_to(REPO)} (the normal and the "
          f"checked build) and loaded the normal one in {t_build:.1f} s", flush=True)

    params, intr = configure()
    if args.graphs:
        run_graphs(device, smi)
        return
    if args.deep_slab:
        frames, gt = orbit_frames(5, intr)
        print("[4d] K3's shard form on slabs of 6,144 planes:", flush=True)
        print(json.dumps({"deep_slab": check_deep_slab(frames[3:5], gt[3:5], params, intr,
                                                       device), "card": smi}))
        return
    if args.shift:
        print("[5e] S1, the in-place shift kernel, against shift_volume:", flush=True)
        s1 = check_shift_kernel(random_volume(params.volume_dims, device), device)
        print_shift_kernel(s1, tuple(params.volume_dims), smi)
        print(json.dumps({"shift_volume": s1, "card": smi}))
        return
    if args.count_syncs:
        frames, _ = orbit_frames(6, intr)
        for fused_mode, raycast_mode in COUNT_SYNCS_MODES:
            p = params.replace(fused_mode=fused_mode, raycast_mode=raycast_mode)
            r = step_syncs(frames, p, intr, device)
            print(f"host syncs a step: {r['syncs']:g} (frames 2-5 of the orbit, fused_mode="
                  f"{fused_mode!r}, raycast_mode={raycast_mode!r}); {r['ms']:.3f} ms/frame "
                  f"(median, CUDA events, under \"warn\") on {smi}; launches a frame: "
                  f"{r['launches']}", flush=True)
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
    res.update(check_composite(state, [("orbit", gt[3])] + inside, params, intr, device,
                               timed="orbit"))
    del state
    torch.cuda.empty_cache()
    run_parity(params, intr, device, smi)
    torch.cuda.empty_cache()

    syncs = step_syncs(frames[:6], params, intr, device)["syncs"]
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
    final_tsdf = state.vol.tsdf  # phase 4e's volume
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
    from kinfu_tpu_torch.tools import accuracy_run

    acc_poses, acc_oks = accuracy_run.track(frames[:n], params, intr, device)
    acc = accuracy_run.metrics(acc_poses, gt[:n])
    print(f"    tools/accuracy_run.py on these frames: {json.dumps(acc)}", flush=True)
    if acc["ate_rmse_m"] != ate or not acc_oks[1:].all():
        _fail(f"accuracy_run's ATE {acc['ate_rmse_m']} is not the orbit's {ate}")
    torch.cuda.empty_cache()
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
    nf_launches, nf_ms, nf_poses = run_nonfused(frames[:n], gt, params, intr, device, poses,
                                                smi)
    m_res, m_paths, m_legs = run_marches(frames[:n], gt, params, intr, device, final_tsdf,
                                         poses[n - 1], poses, smi)
    del final_tsdf
    torch.cuda.empty_cache()
    run_bench(device, ms_frame, c_ms, smi)
    torch.cuda.empty_cache()

    print(f"[5] session: {n} frames through KinFuSession (default device)", flush=True)
    s_launches, s_host_ms = run_session(frames, gt, poses, params, intr, SESSION_OUT)
    if s_launches["icp_normal_eqs"] != k1_want:
        _fail(f"K1 launched {s_launches['icp_normal_eqs']} times in the session, not {k1_want}")
    check_counts(s_launches, {"build_face": n, "face_fields": n, "resample_face": n},
                 "the session")
    torch.cuda.empty_cache()
    print(f"[5b] CLI: the first {CLI_FRAMES} orbit frames as a bundled dataset under "
          f"{CLI_OUT.relative_to(REPO)}, through python -m kinfu_tpu_torch run and eval",
          flush=True)
    cli_launches, cli_session_poses = run_cli(frames, gt, poses, params, intr, CLI_OUT,
                                              CLI_FRAMES)
    torch.cuda.empty_cache()
    reloc_launches = run_relocalize(frames[:n], gt[:n], params, intr, smi)
    pg_launches = run_pose_graph(params, intr, smi)
    t0 = time.perf_counter()
    corridor, corridor_gt = corridor_frames(CORRIDOR_FRAMES + 1, intr)
    print(f"    rendered {CORRIDOR_FRAMES + 1} corridor frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    stream_launches, stream_ms, s1 = run_streaming(corridor, corridor_gt, params, intr, device,
                                                   smi, ms_frame)
    torch.cuda.empty_cache()
    run_graphs(device, smi)

    t_4d = time.perf_counter()
    print(f"[4d] the sharded step on the one card: shard forms against their plain versions "
          f"({SHARD_RANKS} Z slabs and {SHARD_RANKS} Y slabs of the 512^3 volume fused from "
          f"frames 0-2, frame 3)", flush=True)
    state = init_state(params, intr, device=device)
    for d, c in frames[:3]:
        state, _ = kinfu_step(state, torch.as_tensor(d, device=device),
                              torch.as_tensor(c, device=device), params, intr)
    torch.cuda.synchronize()
    shard_res = check_shard_kernels(
        state, frames[3], [("orbit", gt[3], names)] + [(tag, T, (tag.split()[1],))
                                                       for tag, T in inside],
        params, intr, device, res["face_integrate"][1])
    del state
    deep = check_deep_slab(frames[3:5], gt[3:5], params, intr, device)
    torch.cuda.empty_cache()
    print(f"  the shard forms' checks took {time.perf_counter() - t_4d:.1f} s", flush=True)
    SHARD_OUT.mkdir(parents=True, exist_ok=True)
    shard_launches, shard_ms = run_sharded(frames[:n], gt, params, intr, device, poses, inliers,
                                           nf_poses, g_gap, smi,
                                           profile=args.profile_table is not None)
    sweep_launches = run_sweep(CLI_OUT, cli_session_poses, CLI_FRAMES)
    torch.cuda.empty_cache()
    print(f"  phase 4d took {time.perf_counter() - t_4d:.1f} s", flush=True)

    for key, name, *_ in KERNELS:
        err, ms, plain_ms, bound_ms, bound_by = res[key][:5]
        print(f"    {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), max abs err {err:.3g}, {launches[key] / n:g} launches a frame  "
              f"[{smi}]", flush=True)
    for (key, name, *_), leg in zip(MARCH_KERNELS, ("march_step", "march_hier")):
        err, ms, plain_ms, bound_ms, bound_by = m_res[key]
        print(f"    {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), max abs err {err:.3g}, {m_paths[leg][key] / n:g} launches a frame "
              f"of the {leg} leg  [{smi}]", flush=True)
    profile_steps(frames[:n], params, intr, device, table, ms_frame)
    profile_steps(c_frames, params, intr, device, str(Path(table).with_suffix(
        ".corner.txt")), c_ms, n=28, first=20, label="corner orbit (two faces live)", icp=False)
    profile_steps(frames[:n], params.replace(fused_mode="off"), intr, device,
                  str(Path(table).with_suffix(".nonfused.txt")), nf_ms,
                  label="non-fused orbit", icp=False)
    profile_relocalize(frames, params, intr, device)
    profile_steps(corridor, params, intr, device, str(Path(table).with_suffix(".streaming.txt")),
                  stream_ms, n=STREAM_PROFILE[1], first=STREAM_PROFILE[0],
                  label="streaming corridor (the grid shifts)", icp=False, streaming=True)
    torch.cuda.empty_cache()
    run_sanitizer(smi)
    run_repeat(smi)

    paths = {"orbit": launches, "session": s_launches, "cli_session": cli_launches,
             "non_fused": nf_launches, "relocalize_step": reloc_launches,
             "pose_graph_session": pg_launches, **stream_launches, **shard_launches,
             "sweep": sweep_launches, **m_paths}
    for path in (*shard_launches, "sweep"):
        want = (("icp_normal_eqs", "build_face", "face_integrate", "march_rays")
                if path == "sharded_march" else tuple(key for key, *_ in KERNELS))
        for key, name, *_ in KERNELS + MARCH_KERNELS:
            if key in want and paths[path].get(key, 0) <= 0:
                _fail(f"{name} was not launched on the path {path}")
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": int(launches[key]), "max_abs_err": float(res[key][0]),
         "ms": res[key][1], "plain_ms": res[key][2], "bound_ms": res[key][3],
         "bound_by": res[key][4], "library_ms": None,
         "launches_by_path": {p: int(v.get(key, 0)) for p, v in paths.items()},
         **({"graph_ms": res[key][5], "plain_graph_ms": res[key][6]}
            if key == "face_fields" else {})}
        for key, name, src, rep in KERNELS
    ] + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": int(shard_launches["sharded_z"][key]),
         "max_abs_err": float(shard_res[key][0]), "ms": shard_res[key][1],
         "plain_ms": shard_res[key][2], "bound_ms": shard_res[key][3],
         "bound_by": shard_res[key][4], "library_ms": None,
         "launches_by_path": {p: int(v.get(key, 0)) for p, v in paths.items()
                              if p.startswith("sharded")},
         **({"deep_slab": deep} if key == "face_integrate" else {})}
        for key, name, src, rep in SHARD_KERNELS
    ] + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": int(m_paths[leg][key]), "max_abs_err": float(m_res[key][0]),
         "ms": m_res[key][1], "plain_ms": m_res[key][2], "bound_ms": m_res[key][3],
         "bound_by": m_res[key][4], "library_ms": None,
         "launches_by_path": {p: int(v.get(key, 0)) for p, v in paths.items()},
         **({"slab_form": dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"),
                                   m_res["march_slab"]))} if key == "march_rays" else {})}
        for (key, name, src, rep), leg in zip(MARCH_KERNELS, ("march_step", "march_hier"))
    ] + [
        {"name": SHIFT_KERNEL[1], "route": "cuda", "source": SHIFT_KERNEL[2],
         "replaces": SHIFT_KERNEL[3], "launches": int(stream_launches["streaming"][SHIFT_KERNEL[0]]),
         **s1, "library_ms": None,
         "launches_by_path": {p: int(v.get(SHIFT_KERNEL[0], 0)) for p, v in paths.items()}}
    ]}
    print(json.dumps(summary))
    print(f"{smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
