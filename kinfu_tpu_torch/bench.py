"""End-to-end benchmark of the port: ms/frame of the full per-frame step
(port of bench.py, run as `python -m kinfu_tpu_torch bench`).

The workload is bench.py's: 640x480 RGB-D frames, a 512^3 TSDF volume
over a 3 m cube, a 3-level pyramid and (4, 5, 10) ICP iterations, the
reference's published configuration (~18 ms/frame on a GTX 1650 Ti,
BASELINE.md). The frames are rendered on the host from the synthetic orbit
(0.3 degrees a frame) and put on the device once, before any timing.

The method is bench.py's too. A run starts from a fresh `init_state`,
steps the eager step (`make_step_fn`) over its frames, keeps each frame's
pose, tracking flag and ICP inliers on the device, and fetches them once
at the end: the fetch is the run's only host sync, and the wall time is
taken around the loop and the fetch. After one untimed short run and one
untimed long run (they build the CUDA kernels at first use), three short
and three long runs are timed in turns, and

    ms = (min(long) - min(short)) / (long frames - short frames) * 1e3,

which cancels what a run costs whatever its length. The step updates the
volume in place, so every run has its own fresh state, and the previous
run's state is dropped before the next is allocated. The eager step is
host-bound, so this measures the host's enqueue as much as the card; the
six wall times and the per-frame CUDA-event times of the long runs'
frames after the bootstrap (median, min, max) go to stderr beside the
result, which is one JSON line on stdout with bench.py's keys.

`--corner` is bench.py's corner orbit: the orbit yawed 50 degrees about y
in front of `corner_test_scene`. bench.py's help says that every frame
then straddles the +z/+x cube edge; it does not: the tracker anchors the
volume at the first camera, so the step gates +z alone on frames 0-18
and +z and +x from frame 19 (with the defaults' 22 frames, on frames
19-21). The definition is kept as it is.

    python -m kinfu_tpu_torch bench [--dim 512] [--frames 20] [--warmup 2]
        [--width 640 --height 480] [--levels 3] [--fused auto|on|off]
        [--integrate auto|warped|gather] [--raycast auto|warped|hier|step]
        [--icp auto|warped|gather] [--corner] [--device cuda|cpu]

It runs on the card; `--device cpu` (the plain versions of the kernels)
serves the tests, at a small size such as `--dim 128 --width 160
--height 120 --levels 2 --frames 3 --warmup 1`.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import (
    corner_test_scene,
    default_test_scene,
    make_orbit_trajectory,
    yaw_trajectory,
)
from kinfu_tpu_torch.device import resolve_device
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.pipeline.kinfu import init_state, make_step_fn

#: the reference's ms/frame on a GTX 1650 Ti (bench.py:5-6)
BASELINE_MS = 18.0
#: timed (short, long) pairs
REPEATS = 3


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="kinfu_tpu_torch bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--fused", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--integrate", default="auto", choices=["auto", "warped", "gather"])
    ap.add_argument("--raycast", default="auto", choices=["auto", "warped", "hier", "step"])
    ap.add_argument("--icp", default="auto", choices=["auto", "warped", "gather"])
    ap.add_argument("--corner", action="store_true",
                    help="bench.py's corner orbit: the orbit yawed 50 deg in front of "
                         "corner_test_scene (+z alone on frames 0-18, +z and +x after)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: %(default)s; raises without CUDA; "
                         "\"cpu\" is for the tests)")
    return ap.parse_args(argv)


def workload(args: argparse.Namespace):
    """(params, intr, depths [N, H, W] f32, colors [N, H, W, 3] u8) of
    bench.py's workload (bench.py:94-118), N = warmup + frames, the frames
    on `args.device`."""
    params = KinFuParams(
        pyramid_height=args.levels,
        icp_iters=(4, 5, 10)[: args.levels],
        volume_dims=(args.dim, args.dim, args.dim),
        fused_mode=args.fused,
        integrate_mode=args.integrate,
        raycast_mode=args.raycast,
        icp_mode=args.icp,
    )
    intr = Intrinsics(
        width=args.width,
        height=args.height,
        fx=525.0 * args.width / 640,
        fy=525.0 * args.width / 640,
        cx=args.width / 2 - 0.5,
        cy=args.height / 2 - 0.5,
    )
    device = resolve_device(args.device)
    traj = make_orbit_trajectory(args.warmup + args.frames, angle_step_deg=0.3)
    if args.corner:
        scene, traj = corner_test_scene(), yaw_trajectory(traj)
    else:
        scene = default_test_scene()
    rendered = [scene.render_frame(T, intr) for T in traj]
    depths = torch.as_tensor(np.stack([d for d, _ in rendered]), device=device)
    colors = torch.as_tensor(np.stack([c for _, c in rendered]), device=device)
    return params, intr, depths, colors


def run(step, init, depths, colors, events=None, sync_debug: str = "default"):
    """One run from the fresh state `init()` over the frames: (poses f32
    [N, 4, 4], oks bool [N], inliers int32 [N], seconds), numpy arrays and
    the wall time of the loop and the fetch (bench.py's `_run_scan`).

    On a CUDA device, `events`, a list, receives a (start, end) pair of
    CUDA events a frame, recorded around its step and read by the caller
    after this returns; `sync_debug` is the torch.cuda sync-debug mode of
    the loop ("error" fails on any host sync in it), and the fetch runs in
    the default mode."""
    cuda = depths.device.type == "cuda"
    state = init()
    if cuda:
        torch.cuda.synchronize()  # the fresh state is made outside the timed window
    t0 = time.perf_counter()
    debug = cuda and sync_debug != "default"
    if debug:
        torch.cuda.set_sync_debug_mode(sync_debug)
    outs = []
    try:
        for k in range(depths.shape[0]):
            if cuda and events is not None:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            state, out = step(state, depths[k], colors[k])
            if cuda and events is not None:
                end.record()
                events.append((start, end))
            outs.append((out.pose_matrix, out.tracking_ok, out.icp_inliers))
    finally:
        if debug:
            torch.cuda.set_sync_debug_mode("default")
    del state
    if not outs:
        return (np.zeros((0, 4, 4), np.float32), np.zeros(0, bool), np.zeros(0, np.int32),
                time.perf_counter() - t0)
    # the run's one host sync
    poses, oks, inliers = (torch.stack(a).cpu().numpy() for a in zip(*outs))
    return poses, oks, inliers, time.perf_counter() - t0


def main(argv=None) -> int:
    args = parse_args(argv)
    import kinfu_tpu_torch  # noqa: F401  (full-f32 matmuls)

    params, intr, depths, colors = workload(args)
    device = depths.device
    step = make_step_fn(params, intr)
    init = functools.partial(init_state, params, intr, device)

    n_small, n_big = args.warmup, args.warmup + args.frames
    sm_d, sm_c = depths[:n_small], colors[:n_small]
    # untimed: both lengths once, which builds the kernels at first use
    run(step, init, sm_d, sm_c)
    run(step, init, depths, colors)

    # timed: both lengths from a fresh state, in turns
    t_small, t_big, frame_ms = [], [], []
    for _ in range(REPEATS):
        t_small.append(run(step, init, sm_d, sm_c)[3])
        events = []
        poses, oks, inl, dt = run(step, init, depths, colors, events=events)
        t_big.append(dt)
        frame_ms += [a.elapsed_time(b) for a, b in events[1:]]  # after the bootstrap
    if not oks[1:].all():  # frame 0 bootstraps; all others must track
        for i in range(n_big):
            print(f"frame {i:3d}  ok={bool(oks[i])}  inliers={int(inl[i])}", file=sys.stderr)
        raise AssertionError("tracking failed during benchmark")

    ms = (min(t_big) - min(t_small)) / (n_big - n_small) * 1e3
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"bench: device {name}; params fused={params.fused_mode} integrate="
          f"{params.integrate_mode} raycast={params.raycast_mode} icp={params.icp_mode}",
          file=sys.stderr)
    print(f"bench: wall s of the timed runs, short ({n_small} frames) "
          f"{json.dumps(t_small)}, long ({n_big} frames) {json.dumps(t_big)}", file=sys.stderr)
    if frame_ms:
        print(f"bench: CUDA-event ms a frame of the long runs' frames 1-{n_big - 1}: "
              f"median {float(np.median(frame_ms))} min {min(frame_ms)} max {max(frame_ms)} "
              f"({len(frame_ms)} frames)", file=sys.stderr)
    else:
        print("bench: CUDA-event ms a frame: not measured (no CUDA device)", file=sys.stderr)
    print(json.dumps({
        "metric": f"ms_per_frame_{args.width}x{args.height}_{args.dim}^3"
        + ("_corner" if args.corner else ""),
        "value": round(ms, 3),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / ms, 3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
