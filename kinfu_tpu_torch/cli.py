"""Command-line interface of the port: `python -m kinfu_tpu_torch <cmd>`
(port of kinfu_tpu/cli.py, with the same commands and flags and one more,
`run --device`, default "cuda").

Commands:
  run    fuse an RGB-D sequence from disk: tracking + TSDF fusion + exports
  eval   ATE/RPE of an estimated trajectory against ground truth
  sweep  replica-parallel eval sweep (not ported yet: ROADMAP queue 1, item 12)
  bench  per-frame latency benchmark (not ported yet: ROADMAP queue 1, item 7)

`run` drives `KinFuSession` on `--device`: on the card the fused step on
the CUDA kernels, on the CPU the same step on the kernels' plain versions.
The port has only the fused step, so the parameters ask for it
(`fused_mode="on"`, which "auto" also picks on the card). The flags of the
modes the port lacks (`--streaming`, `--relocalize`, `--pose-graph`) raise,
naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from kinfu_tpu_torch.pipeline.session import _not_ported


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

    if args.streaming:
        raise _not_ported("--streaming (the streaming volume)", "item 11")
    if args.relocalize:
        raise _not_ported("--relocalize (keyframes and the relocalizer)", "item 10")
    if args.pose_graph:
        raise _not_ported("--pose-graph (loop closure and the pose graph)", "item 10")
    ds, _ = _open_dataset(args.data, args.dataset)
    intr = ds.intrinsics
    scale = intr.depth_scale if intr.depth_scale != 1.0 else 0.001
    params = _params_from_args(args, scale)

    if args.resume:
        sess = load_checkpoint(args.resume, device=args.device)
        start = sess.frame_count - 1
        print(f"resumed from {args.resume} at frame {start}")
    else:
        sess = KinFuSession(intr, params, device=args.device)
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


def cmd_sweep(args) -> int:
    raise _not_ported("the sweep command (replica-parallel sweeps over a mesh)", "item 12")


def cmd_bench(args) -> int:
    raise _not_ported("the bench command (the port's benchmark)", "item 7")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kinfu_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="fuse an RGB-D sequence")
    rp.add_argument("--data", required=True, help="dataset root")
    rp.add_argument("--dataset", choices=("auto", "bundled", "tum", "icl"), default="auto")
    rp.add_argument("--frames", type=int, default=None)
    rp.add_argument("--streaming", action="store_true",
                    help="camera-following moving volume (not ported yet: item 11)")
    rp.add_argument("--relocalize", action="store_true",
                    help="keep the map on tracking loss and relocalize (not ported yet: "
                         "item 10)")
    rp.add_argument("--pose-graph", action="store_true",
                    help="keyframe pose graph with loop closure (not ported yet: item 10)")
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

    sp = sub.add_parser("sweep", help="replica-parallel eval sweep (not ported yet: item 12)")
    sp.add_argument("--synthetic", type=int, default=8)
    sp.add_argument("--data", action="append", default=None)
    sp.add_argument("--frames", type=int, default=12)
    sp.add_argument("--width", type=int, default=160)
    sp.add_argument("--height", type=int, default=120)
    sp.add_argument("--dims", type=str, default="128")
    sp.add_argument("--devices", type=int, default=None)
    _add_params_flags(sp)
    sp.set_defaults(fn=cmd_sweep)

    bp = sub.add_parser("bench", help="per-frame latency benchmark (not ported yet: item 7)")
    bp.add_argument("rest", nargs=argparse.REMAINDER)
    bp.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
