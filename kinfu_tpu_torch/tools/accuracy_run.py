"""Accuracy run of the port's step over the synthetic orbit with exact
ground truth, the counterpart of tools/accuracy_run.py.

Runs the step (`kinfu_step`, fused on the card) over the 50-frame orbit of
bench.py, or the corner orbit with `--corner`, writes the estimated poses
in the reference's poses.txt format to `--out`, and prints one JSON line
with the ATE (aligned and not) and the RPE over consecutive frames.

    python -m kinfu_tpu_torch.tools.accuracy_run --out POSES.txt [--dim 512]
        [--frames 50] [--levels 3] [--icp-iters 4,5,10] [--width 640 --height 480]
        [--fused auto|on|off] [--corner] [--device cuda|cpu]

Every frame after the first must track, or the run fails naming the
frames. On the CPU, `--device cpu --dim 128 --levels 2 --icp-iters 3,4
--width 160 --height 120` tracks the orbit.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def configure(dim: int, width: int, height: int, levels: int, icp_iters, fused: str):
    """(params, intr) of the run: fx = fy = 525 scaled to the width."""
    from kinfu_tpu_torch.config import KinFuParams
    from kinfu_tpu_torch.geometry.intrinsics import Intrinsics

    f = 525.0 * width / 640
    params = KinFuParams(pyramid_height=levels, icp_iters=tuple(icp_iters),
                         volume_dims=(dim,) * 3, fused_mode=fused)
    return params, Intrinsics(width=width, height=height, fx=f, fy=f, cx=width / 2 - 0.5,
                              cy=height / 2 - 0.5)


def track(frames, params, intr, device):
    """(poses f32 [N, 4, 4], ok [N]) of the step over `frames` from a
    fresh state."""
    from kinfu_tpu_torch.pipeline.kinfu import init_state, make_step_fn

    step = make_step_fn(params, intr)
    state = init_state(params, intr, device=device)
    poses, oks = [], []
    for d, c in frames:
        state, out = step(state, torch.as_tensor(d, device=device),
                          torch.as_tensor(c, device=device))
        poses.append(out.pose_matrix)
        oks.append(out.tracking_ok)
    return torch.stack(poses).cpu().numpy(), torch.stack(oks).cpu().numpy()


def metrics(poses, gt) -> dict:
    """The JSON line's numbers: ATE aligned and not, RPE over one frame."""
    from kinfu_tpu_torch.eval.ate import ate_rmse, rpe_rmse

    est = list(poses)
    rpe_t, rpe_r = rpe_rmse(est, gt, delta=1)
    return {"ate_rmse_m": float(ate_rmse(est, gt)),
            "ate_rmse_noalign_m": float(ate_rmse(est, gt, align=False)),
            "rpe_trans_rmse_m": float(rpe_t), "rpe_rot_rmse_deg": float(np.degrees(rpe_r))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="the poses file (reference format)")
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--icp-iters", default="4,5,10",
                    help="iterations per level, finest first (default 4,5,10)")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--fused", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--corner", action="store_true", help="the corner orbit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    iters = [int(k) for k in args.icp_iters.split(",")][:args.levels]
    if len(iters) != args.levels:
        ap.error(f"--icp-iters needs {args.levels} values")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("accuracy_run: CUDA is not available (pass --device cpu)")
    import kinfu_tpu_torch  # noqa: F401  (full-f32 matmuls)
    from kinfu_tpu_torch.io.poses import write_poses_reference_format
    from kinfu_tpu_torch.tools.trace_step import orbit

    params, intr = configure(args.dim, args.width, args.height, args.levels, iters, args.fused)
    frames, gt = orbit(args.frames, intr, args.corner)
    t0 = time.perf_counter()
    poses, oks = track(frames, params, intr, device)
    wall = time.perf_counter() - t0
    if not oks[1:].all():
        raise SystemExit(f"accuracy_run: tracking failed at frames {np.nonzero(~oks[1:])[0] + 1}")
    write_poses_reference_format(args.out, list(poses))
    print(json.dumps({"config": f"{args.width}x{args.height}/{args.dim}^3/{args.levels}lvl"
                                f"{'/corner' if args.corner else ''}",
                      "device": str(device), "frames": len(poses), **metrics(poses, gt),
                      "seconds": wall, "poses": args.out}))


if __name__ == "__main__":
    main()
