#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kinfu_tpu_torch) on one NVIDIA GPU.

Phases; any failure exits non-zero before the result line:
  1. report the card (torch and nvidia-smi);
  2. build the CUDA kernels of kinfu_tpu_torch/csrc from this checkout;
  3. hold every kernel on the fused step's path (K2 build_face, K3
     face_integrate, K4 sweep_rays, K5 resample_face) against its plain
     PyTorch version at the main path's shapes (a real frame of the
     synthetic orbit, a 512^3 volume fused from 3 frames; all six cube
     faces seen from the orbit pose, and each face seen from the volume's
     centre looking along it), and time both with CUDA events;
  4. run the 50-frame orbit of bench.py (640x480, fx=fy=525, 512^3 over 3 m,
     3-level pyramid, ICP (4,5,10), icp_mode="gather") through init_state +
     kinfu_step with the launch counts set to 0 just before; every frame
     after the first must track, the aligned ATE against exact ground truth
     must be <= 1 mm, and every kernel must have launched;
  5. profile 8 steps of a fresh run: kernel time per frame and the
     device's idle share (the full table goes to --profile-table);
  6. print one JSON line describing the kernels, then the card, then the
     result line.

Usage: python3 chip_smoke.py [--profile-table PATH]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "doc" / "golden_poses_r05_synthetic_640x480_512.txt"
PROFILE_TABLE = REPO / "build" / "profile_table.txt"
#: bench.py's orbit length
ORBIT_FRAMES = 50

KERNELS = (
    # (launch-count key, name, source, TPU kernel it replaces)
    ("build_face", "K2 build_face", "kinfu_tpu_torch/csrc/build_face.cu",
     "kinfu_tpu/ops/facewarp.py:285"),
    ("face_integrate", "K3 face_integrate", "kinfu_tpu_torch/csrc/face_integrate.cu",
     "kinfu_tpu/ops/pallas_integrate.py:204"),
    ("sweep_rays", "K4 sweep_rays", "kinfu_tpu_torch/csrc/sweep_rays.cu",
     "kinfu_tpu/ops/pallas_raycast.py:114"),
    ("resample_face", "K5 resample_face", "kinfu_tpu_torch/csrc/resample_face.cu",
     "kinfu_tpu/ops/pallas_raycast.py:579"),
)

#: K4 tolerances: hit-mask agreement and |t| gap where both hit (metres)
K4_MASK_AGREE = 0.999
K4_T_TOL = 1e-4
#: orbit acceptance: aligned ATE against exact ground truth (metres)
ATE_MAX = 1.0e-3


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
        icp_mode="gather",
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
    voxels, K4 must hit the surface and K5 must resample a hit. Returns {key: [max_abs_err, ms, plain_ms]}."""
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
    res = {k: [0.0, float("nan"), float("nan")] for k, *_ in KERNELS}
    k4_agree = []

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

        # K3 on copies of the fused volume
        prm3 = fi.sweep_params(c_p, fw.primed_voxel_size(frame_, vs), fspec, params,
                               rk.max().float(), on)
        dims_p = tuple(vol.tsdf.shape[a] for a in frame_.axes)
        table = fi.plane_table(fspec, prm3, dims_p)
        vk = TSDFVolume(*(a.clone() for a in vol))
        vp = TSDFVolume(*(a.clone() for a in vol))
        fi.sweep_face(vk, frame_, rk, ck, prm3, table)
        fi.sweep_face_plain(vp, frame_, rk, ck, prm3, table)
        sync()
        err3 = max(int((a.int() - b.int()).abs().max()) for a, b in zip(vk, vp))
        changed = int((vk.weight != vol.weight).sum())
        print(f"  K3 {tag}: {changed} voxels updated, max |kernel - plain| {err3}", flush=True)
        res["face_integrate"][0] = max(res["face_integrate"][0], float(err3))
        if err3:
            _fail(f"K3 {tag}: kernel and plain version differ")
        if must_work and not changed:
            _fail(f"K3 {tag}: no voxel updated, so the comparison tested nothing")
        if timed_here:
            res["face_integrate"][1] = ms(lambda: fi.sweep_face(vk, frame_, rk, ck, prm3, table))
            res["face_integrate"][2] = ms(
                lambda: fi.sweep_face_plain(vp, frame_, rk, ck, prm3, table), reps=10, warmup=1)
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
        k4_agree.append(agree)
        print(f"  K4 {tag}: {int(okk.sum())} hits, mask agreement {agree:.6f}, "
              f"max |dt| {dt4:.3g} m", flush=True)
        if agree < K4_MASK_AGREE or dt4 > K4_T_TOL:
            _fail(f"K4 {tag}: agreement {agree} < {K4_MASK_AGREE} or |dt| {dt4} > {K4_T_TOL}")
        if must_work and not bool(okk.any()):
            _fail(f"K4 {tag}: no ray hit the surface, so the comparison tested nothing")
        res["sweep_rays"][0] = max(res["sweep_rays"][0], dt4)
        if timed_here:
            res["sweep_rays"][1] = ms(lambda: fr.sweep_rays(vol.tsdf, frame_, prm4, rspec))
            res["sweep_rays"][2] = ms(lambda: fr.sweep_rays_plain(vol.tsdf, frame_, prm4, rspec),
                                      reps=10, warmup=1)

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
    print(f"  K2 and K5 bit-exact, K3 int16/int32 equal on {len(views)} views; "
          f"K4 min mask agreement {min(k4_agree):.6f}", flush=True)
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


def profile_steps(frames, params, intr, device, out_path: str, ms_frame: float,
                  n: int = 10) -> None:
    """Phase 5: torch.profiler over frames 2..n-1 of a fresh run. Prints the
    kernels by device time, their sum per frame and its share of `ms_frame`
    (the step's time without the profiler), and writes the full table to
    `out_path`."""
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
    print(f"[5] profile, frames 2-{n - 1} of a fresh run: kernels busy {busy:.3f} ms/frame in "
          f"{launches:.0f} launches/frame; {busy / ms_frame:.1%} of the "
          f"{ms_frame:.3f} ms/frame step (device idle {1 - busy / ms_frame:.1%}); "
          f"{wall:.1f} ms/frame wall under the profiler", flush=True)
    for e in ev[:12]:
        print(f"      {e.self_device_time_total / 1e3 / (n - 2):9.3f} ms/frame "
              f"{e.count // (n - 2):5d}x  {e.key[:90]}", flush=True)
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
    frames, gt = orbit_frames(n, intr)
    print(f"    rendered {n} frames {intr.width}x{intr.height} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # a 512^3 volume fused from 3 frames, then frame 3 as the kernels' input
    state = init_state(params, intr, device=device)
    for d, c in frames[:3]:
        state, _ = kinfu_step(state, torch.as_tensor(d, device=device),
                              torch.as_tensor(c, device=device), params, intr)
    torch.cuda.synchronize()
    print("[3] kernels against their plain versions (frame 3, volume fused from "
          "frames 0-2):", flush=True)
    res = check_kernels(state, frames[3], gt[3], params, intr, device)
    for key, name, *_ in KERNELS:
        err, ms, plain_ms = res[key]
        print(f"    {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, max abs err {err:.3g}"
              f"  [{smi}]", flush=True)
    del state
    torch.cuda.empty_cache()

    print(f"[4] orbit: {n} frames through init_state + kinfu_step", flush=True)
    poses, oks, inliers, frame_ms, state, launches = run_orbit(frames, params, intr, device)
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
    ate = ate_rmse(list(poses), gt)
    ate_raw = ate_rmse(list(poses), gt, align=False)
    golden = read_poses_reference_format(str(GOLDEN))[:n]
    gap = max(float(np.linalg.norm(p[:3, 3] - g[:3, 3])) for p, g in zip(poses, golden))
    ms_frame = float(np.median(frame_ms[2:]))
    print(f"    tracked {int(oks[1:].sum())}/{n - 1} frames after bootstrap; model hit "
          f"fraction {hit_frac:.3f}", flush=True)
    print(f"    ATE vs exact ground truth: aligned {ate * 1e3:.4f} mm, raw "
          f"{ate_raw * 1e3:.4f} mm; max translation gap to {GOLDEN.name} "
          f"{gap * 1e3:.4f} mm (recorded with warped ICP: printed, not gated)", flush=True)
    print(f"    {ms_frame:.3f} ms/frame (median of frames 2-{n - 1}, CUDA events) "
          f"on {smi}", flush=True)
    print(f"    launches in the orbit: {launches}", flush=True)
    if ate > ATE_MAX:
        _fail(f"aligned ATE {ate * 1e3:.4f} mm > {ATE_MAX * 1e3} mm")
    for key, name, *_ in KERNELS:
        if launches.get(key, 0) <= 0:
            _fail(f"{name} was not launched on the main path")

    profile_steps(frames, params, intr, device, args.profile_table, ms_frame)

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": int(launches[key]), "max_abs_err": float(res[key][0]),
         "ms": res[key][1], "plain_ms": res[key][2]}
        for key, name, src, rep in KERNELS
    ]}
    print(json.dumps(summary))
    print(f"{smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
