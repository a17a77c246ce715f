"""Command-line interface of the port: `python -m kinfu_tpu_torch <cmd>`
(port of kinfu_tpu/cli.py, with the same commands and flags and one more,
`run --device`, default "cuda").

Commands:
  run    fuse an RGB-D sequence from disk: tracking + TSDF fusion + exports
  eval   ATE/RPE of an estimated trajectory against ground truth
  sweep  replica-parallel eval sweep: sequences x configs over `--devices`
         ranks (parallel/sweep.py), one JSON line per (sequence, config)
  bench  end-to-end per-frame latency benchmark (bench.py's workload, method
         and JSON line; kinfu_tpu_torch/bench.py, which takes its flags)

`run` drives `KinFuSession` on `--device`: on the card the fused step on
the CUDA kernels, on the CPU the same step on the kernels' plain versions
(the parameters ask for the fused step, `fused_mode="on"`, which "auto"
also picks on the card). `--relocalize` keeps the map through a tracking
loss and re-acquires it from a keyframe; `--pose-graph` closes loops and
rebuilds the map at the corrected poses; both go through the integrate
and raycast dispatchers, which on the card launch the same kernels.
`--streaming` runs the camera-following volume (pipeline/streaming.py),
whose grid shifts by whole voxels to keep the view ahead of the camera
inside it: the fused step on the same kernels, for corridor-scale
sequences.

`sweep` starts `--devices` rank processes on `--device` in a gloo process
group (several ranks may share one card) and tracks synthetic orbits and
datasets from disk over them; `--save-poses DIR` writes each sequence's
poses.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _add_params_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dim", type=int, default=512, help="voxels per axis")
    p.add_argument("--volume-size", type=float, default=3.0, help="metres per axis")
    p.add_argument("--levels", type=int, default=3, help="pyramid height")
    p.add_argument("--icp-iters", type=str, default="4,5,10")
    p.add_argument("--dist-threshold", type=float, default=0.015)
    p.add_argument("--angle-threshold", type=float, default=30.0)
    p.add_argument("--depth-scale", type=float, default=None,
                   help="metres per depth unit (default: dataset-provided)")
    p.add_argument("--max-weight", type=int, default=64)


def _params_from_args(args, dataset_depth_scale: float):
    """The KinFuParams of the params flags (kinfu_tpu/cli.py::_params_from_args),
    on the port's fused step."""
    from kinfu_tpu_torch.config import KinFuParams

    iters = tuple(int(x) for x in args.icp_iters.split(","))[: args.levels]
    return KinFuParams(
        pyramid_height=args.levels,
        icp_iters=iters,
        icp_dist_threshold=args.dist_threshold,
        icp_angle_threshold=args.angle_threshold,
        volume_dims=(args.dim,) * 3,
        volume_range=(args.volume_size,) * 3,
        depth_scale=(
            args.depth_scale if args.depth_scale is not None else dataset_depth_scale
        ),
        tsdf_max_weight=args.max_weight,
        fused_mode="on",
    )


def _open_dataset(path: str, kind: str):
    """(dataset, kind) of a dataset root; "auto" picks TUM where rgb.txt exists."""
    if kind == "auto":
        kind = "tum" if os.path.exists(os.path.join(path, "rgb.txt")) else "bundled"
    if kind == "icl":
        from kinfu_tpu_torch.data.icl_nuim import ICLNuimDataset

        return ICLNuimDataset(path), "icl"
    if kind == "tum":
        from kinfu_tpu_torch.data.tum import TUMDataset

        return TUMDataset(path), "tum"
    from kinfu_tpu_torch.data.bundled import BundledDataset

    return BundledDataset(path), "bundled"


def cmd_run(args) -> int:
    from kinfu_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from kinfu_tpu_torch.io.images import write_color_png, write_depth_png
    from kinfu_tpu_torch.pipeline.session import KinFuSession
    from kinfu_tpu_torch.utils.metrics import FrameMetrics, MetricsRecorder

    ds, _ = _open_dataset(args.data, args.dataset)
    intr = ds.intrinsics
    scale = intr.depth_scale if intr.depth_scale != 1.0 else 0.001
    params = _params_from_args(args, scale)

    if args.resume:
        sess = load_checkpoint(args.resume, device=args.device)
        start = sess.frame_count - 1
        print(f"resumed from {args.resume} at frame {start}")
    else:
        sess = KinFuSession(intr, params, device=args.device, relocalize=args.relocalize,
                            streaming=args.streaming, pose_graph=args.pose_graph)
        start = 0

    if args.dump_renders:
        os.makedirs(args.dump_renders, exist_ok=True)
    if args.dump_3d:
        os.makedirs(args.dump_3d, exist_ok=True)

    rec = MetricsRecorder(jsonl_path=args.metrics, echo=not args.quiet)
    n = len(ds) if args.frames is None else min(args.frames, len(ds))
    for i in range(start, n):
        color, depth = ds[i]
        t0 = time.perf_counter()
        ok = sess.pipeline(color, depth)
        rec.record(FrameMetrics(frame=i, tracking_ok=ok,
                                total_ms=(time.perf_counter() - t0) * 1e3,
                                icp_inliers=sess.last_icp_inliers))
        if args.dump_renders and i % max(1, args.dump_every) == 0:
            # the reference shows Scene (Phong of the fused model), Depth and
            # Color every frame (main.cpp:77-86)
            d = args.dump_renders
            write_color_png(os.path.join(d, f"{i:06d}_phong.png"),
                            sess.get_render_map(sess.PHONG))
            write_color_png(os.path.join(d, f"{i:06d}_normal.png"),
                            sess.get_render_map(sess.NORMAL))
            write_color_png(os.path.join(d, f"{i:06d}_color.png"), color)
            write_depth_png(os.path.join(d, f"{i:06d}_depth.png"),
                            np.asarray(depth).astype(np.uint16))
        if args.dump_3d and args.dump_3d_every and (i + 1) % args.dump_3d_every == 0:
            sess.save_3d(os.path.join(args.dump_3d, f"{i:06d}_3d.png"))
        if args.checkpoint and args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint, sess)

    if args.relocalize and sess.keyframes is not None:
        print(f"relocalize: {len(sess.keyframes)} keyframes")
    if args.pose_graph and sess.pose_graph:
        print(f"pose graph: {len(sess.pg_keyframes)} keyframes, "
              f"{len(sess.loop_closures)} loop closures")
    s = rec.summary()
    if s:
        print(f"done: {s['frames']} frames, {s['tracking_failures']} tracking "
              f"failures, median {s['median_ms']:.1f} ms/frame")
    else:
        print(f"nothing to do (resumed at frame {start}, sequence has {n})")
    if args.save_poses:
        if args.poses_format == "tum":
            from kinfu_tpu_torch.io.poses import write_poses_tum

            stamps = [ds.timestamp(i) if hasattr(ds, "timestamp") else float(i)
                      for i in range(len(sess.pose_record))]
            write_poses_tum(args.save_poses, sess.pose_record, stamps)
        else:
            sess.save_poses(args.save_poses)
        print(f"poses -> {args.save_poses}")
    if args.save_ply:
        sess.save_pointcloud(args.save_ply)
        print(f"pointcloud -> {args.save_ply}")
    if args.dump_3d:
        out3d = os.path.join(args.dump_3d, "3d_final.png")
        sess.save_3d(out3d)
        print(f"3d view -> {out3d}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, sess)
        print(f"checkpoint -> {args.checkpoint}")
    rec.close()
    return 0


def cmd_eval(args) -> int:
    from kinfu_tpu_torch.eval.ate import ate_rmse, rpe_rmse
    from kinfu_tpu_torch.io.poses import read_poses_reference_format, read_poses_tum

    def load(path, fmt):
        if fmt == "auto":
            with open(path) as f:
                first = f.readline()
            fmt = "ref" if first.lstrip().startswith("[") else "tum"
        if fmt == "tum":
            _, poses = read_poses_tum(path)
            return poses
        return read_poses_reference_format(path)

    est = load(args.est, args.est_format)
    gt = load(args.gt, args.gt_format)
    ate = ate_rmse(est, gt, align=not args.no_align)
    rpe_t, rpe_r = rpe_rmse(est, gt, delta=args.rpe_delta)
    print(json.dumps({
        "ate_rmse_m": round(ate, 6),
        "rpe_trans_rmse_m": round(rpe_t, 6),
        "rpe_rot_rmse_deg": round(np.degrees(rpe_r), 6),
        "n_est": len(est),
        "n_gt": len(gt),
    }))
    return 0


def _sweep_rank(mesh, sequences, dims, args, intr, scale):
    """One rank of `sweep`: every config's sweep over the mesh; returns per
    config (wall seconds, per-sequence (poses, oks)), and the rank's kernel
    launches."""
    from kinfu_tpu_torch.ops import kernels
    from kinfu_tpu_torch.parallel.sweep import sweep_sequences

    kernels.reset_launch_counts()
    out = []
    for dim in dims:
        params = _params_from_args(args, scale).replace(volume_dims=(dim,) * 3)
        t0 = time.perf_counter()
        results = sweep_sequences(sequences, params, intr, mesh)
        out.append((time.perf_counter() - t0, results))
    return out, dict(kernels.LAUNCHES)


def cmd_sweep(args) -> int:
    """Replica-parallel eval sweep (kinfu_tpu/cli.py::cmd_sweep): sequences
    x configs over `--devices` ranks. Prints one JSON line per (sequence,
    config) with its tracking failures, the wall ms a frame and, for the
    synthetic orbits, the ATE; then a summary line."""
    from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
    from kinfu_tpu_torch.device import resolve_device
    from kinfu_tpu_torch.eval.ate import ate_rmse
    from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
    from kinfu_tpu_torch.parallel.mesh import spawn

    resolve_device(args.device)
    sequences, gts, names = [], [], []
    datasets = [_open_dataset(root, "auto")[0] for root in args.data or []]
    if datasets:
        # every sequence of one sweep shares the frame size: the datasets'
        intr = datasets[0].intrinsics
        scale = intr.depth_scale if intr.depth_scale != 1.0 else 0.001
    else:
        intr = Intrinsics(width=args.width, height=args.height, fx=525.0 * args.width / 640,
                          fy=525.0 * args.width / 640, cx=args.width / 2 - 0.5,
                          cy=args.height / 2 - 0.5)
        scale = 0.001
    scene = default_test_scene()
    for k in range(args.synthetic):
        step = 0.2 + 0.15 * k  # distinct trajectories per replica
        traj = make_orbit_trajectory(args.frames, angle_step_deg=step)
        frames = [scene.render_frame(T, intr) for T in traj]
        sequences.append((np.stack([d for d, _ in frames]), np.stack([c for _, c in frames])))
        gts.append([np.linalg.inv(traj[0]) @ T for T in traj])
        names.append(f"orbit_{step:.2f}deg")
    for root, ds in zip(args.data or [], datasets):
        frames = [ds[i] for i in range(min(args.frames, len(ds)))]
        sequences.append((np.stack([np.asarray(d, np.float32) for _, d in frames]),
                          np.stack([c for c, _ in frames])))
        gts.append(None)
        names.append(os.path.basename(os.path.normpath(root)))
    if not sequences:
        raise SystemExit("sweep: no sequences (--synthetic 0 and no --data)")

    world = args.devices or 1
    dims = [int(d) for d in args.dims.split(",")]
    # ranks on the CPU share its cores
    threads = (max(1, (os.cpu_count() or 1) // world)
               if resolve_device(args.device).type == "cpu" else None)
    ranks = spawn(_sweep_rank, world, sequences, dims, args, intr, scale,
                  device=args.device, threads=threads)
    per_config = ranks[0][0]
    launches = {}
    for _, counts in ranks:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    if args.save_poses:
        os.makedirs(args.save_poses, exist_ok=True)
    n_waves = -(-len(sequences) // world)
    for dim, (wall, results) in zip(dims, per_config):
        ms_frame = wall / (n_waves * args.frames) * 1e3
        for name, gt, (poses, oks) in zip(names, gts, results):
            row = {"sequence": name, "dim": dim, "frames": int(oks.shape[0]),
                   "tracking_failures": int((~oks).sum()),
                   "ms_per_frame_wall": round(ms_frame, 2)}
            if gt is not None:
                row["ate_rmse_m"] = round(float(ate_rmse(list(poses), gt[:len(poses)])), 6)
            if args.save_poses:
                from kinfu_tpu_torch.io.poses import write_poses_reference_format

                write_poses_reference_format(
                    os.path.join(args.save_poses, f"{name}_{dim}.txt"), list(poses))
            print(json.dumps(row))
    print(f"# sweep: {len(sequences)} sequences x {len(dims)} configs on {world} ranks "
          f"(gloo, {args.device})")
    print(f"# launches, summed over the ranks: {json.dumps(launches, sort_keys=True)}")
    return 0


def cmd_bench(args) -> int:
    from kinfu_tpu_torch import bench

    return bench.main(args.rest)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kinfu_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="fuse an RGB-D sequence")
    rp.add_argument("--data", required=True, help="dataset root")
    rp.add_argument("--dataset", choices=("auto", "bundled", "tum", "icl"), default="auto")
    rp.add_argument("--frames", type=int, default=None)
    rp.add_argument("--streaming", action="store_true",
                    help="camera-following moving volume (corridor-scale sequences)")
    rp.add_argument("--relocalize", action="store_true",
                    help="keep the map on tracking loss and relocalize")
    rp.add_argument("--pose-graph", action="store_true",
                    help="keyframe pose graph with loop closure")
    rp.add_argument("--dump-renders", default=None, metavar="DIR",
                    help="write phong/normal/color/depth PNGs per frame (main.cpp:77-86)")
    rp.add_argument("--dump-every", type=int, default=5, metavar="N",
                    help="dump renders every N frames (default 5)")
    rp.add_argument("--dump-3d", default=None, metavar="DIR",
                    help="write an offline 3D overview PNG (cloud + cube + trajectory "
                         "+ frustum, main.cpp:82-86 / doc/3D.png)")
    rp.add_argument("--dump-3d-every", type=int, default=0, metavar="N",
                    help="also dump the 3D view every N frames (0 = final only)")
    rp.add_argument("--save-poses", default=None)
    rp.add_argument("--poses-format", choices=("ref", "tum"), default="ref")
    rp.add_argument("--save-ply", default=None)
    rp.add_argument("--checkpoint", default=None, help="checkpoint file (.npz)")
    rp.add_argument("--checkpoint-every", type=int, default=0)
    rp.add_argument("--resume", default=None, help="resume from checkpoint")
    rp.add_argument("--metrics", default=None, help="per-frame metrics JSONL")
    rp.add_argument("--quiet", action="store_true")
    rp.add_argument("--device", default="cuda",
                    help="torch device to run on (default: %(default)s; raises without CUDA)")
    _add_params_flags(rp)
    rp.set_defaults(fn=cmd_run)

    ep = sub.add_parser("eval", help="trajectory accuracy (ATE / RPE)")
    ep.add_argument("--est", required=True)
    ep.add_argument("--gt", required=True)
    ep.add_argument("--est-format", choices=("auto", "ref", "tum"), default="auto")
    ep.add_argument("--gt-format", choices=("auto", "ref", "tum"), default="auto")
    ep.add_argument("--rpe-delta", type=int, default=1)
    ep.add_argument("--no-align", action="store_true")
    ep.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("sweep", help="replica-parallel eval sweep (sequences x configs)")
    sp.add_argument("--synthetic", type=int, default=8,
                    help="number of synthetic orbit sequences")
    sp.add_argument("--data", action="append", default=None,
                    help="dataset root (repeatable); its intrinsics replace --width/--height")
    sp.add_argument("--frames", type=int, default=12)
    sp.add_argument("--width", type=int, default=160)
    sp.add_argument("--height", type=int, default=120)
    sp.add_argument("--dims", type=str, default="128",
                    help="comma-separated volume dims (one config each)")
    sp.add_argument("--devices", type=int, default=None,
                    help="rank processes (default 1); several may share one card")
    sp.add_argument("--device", default="cuda",
                    help="torch device type of the ranks (default: %(default)s, cuda:{rank %% "
                         "cards}; raises without CUDA)")
    sp.add_argument("--save-poses", default=None, metavar="DIR",
                    help="write each (sequence, config)'s poses to DIR/NAME_DIM.txt")
    _add_params_flags(sp)
    sp.set_defaults(fn=cmd_sweep)

    # bench's flags are kinfu_tpu_torch/bench.py's, passed through whole
    bp = sub.add_parser("bench", help="per-frame latency benchmark (kinfu_tpu_torch/bench.py)",
                        add_help=False)
    bp.set_defaults(fn=cmd_bench)

    args, rest = ap.parse_known_args(argv)
    if args.cmd == "bench":
        args.rest = rest
    elif rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
