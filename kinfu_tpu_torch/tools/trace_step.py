"""Per-kernel device profile of the port's per-frame step, the counterpart
of tools/trace_step.py: where the ms/frame goes.

Times N frames of the step from a fresh state with CUDA events (the
median ms/frame of frames 2..N-1), then runs a fresh state again with
frames 2..N-1 under torch.profiler, and prints the device kernels by total
time with their launches, the busy ms/frame and the device's idle share
(1 - busy / ms/frame), each port kernel's time and launches a frame, and
the ICP of the last frame alone (one `rigid_icp` host call against the
same ICP as one-iteration launches with the eager finish). The profiler
runs last: once it has run in a process every later launch costs more
host time.

    python -m kinfu_tpu_torch.tools.trace_step [--dim 512] [--frames 10] [--top 40]
        [--fused auto|on|off] [--corner] [--streaming] [--width 640 --height 480]
        [--device cuda|cpu]

The step is bench.py's (a 3-level pyramid, ICP (4, 5, 10), the orbit at
0.3 degrees a frame; `--corner` the corner orbit, `--streaming` the
streaming step, pipeline/streaming.py). On the CPU (`--device cpu`) the
rows are PyTorch's CPU operators by self time, no device numbers: the
lines say "cpu".
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

#: the port's kernels: (launch-count key, name); a kernel's device events
#: are named "<key>_kernel"
PORT_KERNELS = (("icp_normal_eqs", "K1 icp_normal_eqs"), ("build_face", "K2 build_face"),
                ("face_integrate", "K3 face_integrate"), ("sweep_rays", "K4 sweep_rays"),
                ("resample_face", "K5 resample_face"), ("face_fields", "R1 face_fields"))


@dataclasses.dataclass
class Profile:
    """What torch.profiler saw over `calls` calls of a function."""

    #: (name, total ms, count), longest first: device kernels on CUDA, CPU
    #: operators by self time on the CPU
    rows: List[Tuple[str, float, int]]
    #: the device kernels' launches, (name, start us, ms), in start order
    #: (empty on the CPU)
    launches: List[Tuple[str, float, float]]
    calls: int
    #: host milliseconds a call under the profiler
    wall_ms: float
    #: the profiler's table, for a file
    table: str

    @property
    def busy_ms(self) -> float:
        """Summed row time a call."""
        return sum(ms for _, ms, _ in self.rows) / self.calls

    @property
    def count(self) -> float:
        """Rows' events a call (kernel launches on CUDA)."""
        return sum(n for _, _, n in self.rows) / self.calls

    def kernel(self, key: str) -> List[float]:
        """Milliseconds of each launch of port kernel `key`, in start order."""
        return [ms for name, _, ms in self.launches if f"{key}_kernel" in name]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def profile(fn: Callable[[], object], calls: int, device) -> Profile:
    """`fn()` `calls` times under torch.profiler, ending in a synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = time.perf_counter()
    with torch_profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        _sync(device)
    wall = (time.perf_counter() - t0) * 1e3 / calls
    avg = prof.key_averages()
    # kernel events only on CUDA: an operator's self device time repeats
    # its kernels'
    if cuda:
        rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in avg
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        launches = sorted(((e.name, e.time_range.start, e.time_range.elapsed_us() / 1e3)
                           for e in prof.events() if e.device_type == DeviceType.CUDA),
                          key=lambda x: x[1])
        sort_by = "self_device_time_total"
    else:
        rows = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in avg
                if e.self_cpu_time_total > 0]
        launches, sort_by = [], "self_cpu_time_total"
    rows.sort(key=lambda r: -r[1])
    return Profile(rows, launches, calls, wall, avg.table(
        sort_by=sort_by, row_limit=80, max_name_column_width=90))


def make_step(params, intr, streaming: bool = False):
    """(init_state, step) of the fused step or, with `streaming`, of the
    streaming step."""
    if streaming:
        from kinfu_tpu_torch.pipeline.streaming import init_streaming_state, make_streaming_step_fn

        return init_streaming_state, make_streaming_step_fn(params, intr)
    from kinfu_tpu_torch.pipeline.kinfu import init_state, make_step_fn

    return init_state, make_step_fn(params, intr)


def time_steps(frames, params, intr, device, streaming: bool = False) -> np.ndarray:
    """Milliseconds of each frame of a fresh run (CUDA events on the card,
    the host clock on the CPU)."""
    init, step = make_step(params, intr, streaming)
    state = init(params, intr, device=device)
    out = []
    for d, c in frames:
        d, c = torch.as_tensor(d, device=device), torch.as_tensor(c, device=device)
        _sync(device)
        if torch.device(device).type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            state, _ = step(state, d, c)
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            state, _ = step(state, d, c)
            out.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(out)


def trace_steps(frames, params, intr, device, first: int = 2, streaming: bool = False):
    """Frames first..N-1 of a fresh run under the profiler, after frames
    0..first-1 outside it. Returns (Profile, the state after the run)."""
    init, step = make_step(params, intr, streaming)
    state = init(params, intr, device=device)
    dev = [(torch.as_tensor(d, device=device), torch.as_tensor(c, device=device))
           for d, c in frames]
    for d, c in dev[:first]:
        state, _ = step(state, d, c)
    _sync(device)
    rest = iter(dev[first:])
    box = [state]

    def one():
        d, c = next(rest)
        box[0], _ = step(box[0], d, c)

    return profile(one, len(dev) - first, device), box[0]


def per_frame(prof: Profile, key: str) -> Tuple[float, float, Tuple[float, float] | None]:
    """(ms a frame, launches a frame, (the longest launch of a frame, the
    others) as medians over the frames, or None) of port kernel `key`."""
    each, m = prof.kernel(key), prof.calls
    per = len(each) // m
    split = None
    if per > 1 and per * m == len(each):
        frames = [sorted(each[i * per:(i + 1) * per]) for i in range(m)]
        split = (float(np.median([f[-1] for f in frames])),
                 float(np.median([t for f in frames for t in f[:-1]])))
    return sum(each) / m, len(each) / m, split


def kernel_lines(prof: Profile, kernels: Sequence[Tuple[str, str]] = PORT_KERNELS) -> List[str]:
    """A line a port kernel: its device time and launches a frame, and,
    where it launches several times a frame, its longest launch of a frame
    and the others (where one face is live: the active face and the gated-
    off ones)."""
    lines = []
    for key, name in kernels:
        ms, n, split = per_frame(prof, key)
        line = f"{name}: device {ms:.4f} ms/frame in {n:.0f} launches/frame"
        if split:
            line += (f"; a launch: {split[0]:.4f} ms the longest of a frame, {split[1]:.4f} ms "
                     f"the others (medians)")
        lines.append(line)
    return lines


def icp_profile(state, depth, params, intr, n: int = 8) -> List[Tuple[str, float, float]]:
    """The ICP of a frame alone: [(form, busy ms a call, launches a call)]
    of `rigid_icp` (K1's finishing form, one host call) and of the same ICP
    as one-iteration K1 launches with the eager finish, each over `n` calls
    on the measurement pyramid of `depth` against `state`'s model maps."""
    from kinfu_tpu_torch.frontend.maps import build_measurement_pyramid
    from kinfu_tpu_torch.ops import icp_warped as iw
    from kinfu_tpu_torch.tracking import icp as ticp

    p, device = params, depth.device
    _, cvs, cns = build_measurement_pyramid(
        depth, intr, pyramid_height=p.pyramid_height,
        bfilter_kernel_size=p.bfilter_kernel_size, bfilter_color_sigma=p.bfilter_color_sigma,
        bfilter_spatial_sigma=p.bfilter_spatial_sigma, depth_scale=p.depth_scale,
        max_dist=p.dfilter_dist, normal_disc_threshold=p.normal_disc_threshold)
    args = (cvs, cns, state.model_vmaps, state.model_nmaps, intr, params)
    out = []
    for name, fn in (("rigid_icp, one host call", lambda: ticp.rigid_icp(*args)),
                     ("one-iteration K1 launches with the eager finish",
                      lambda: ticp.icp_loop(*args, iw.icp_normal_eqs_warped))):
        fn()
        _sync(device)
        prof = profile(fn, n, device)
        out.append((name, prof.busy_ms, prof.count))
    return out


def workload(dim: int, width: int, height: int, fused: str = "auto"):
    """bench.py's step (3-level pyramid, ICP (4, 5, 10)) at `dim`^3 and a
    camera of `width` x `height` (fx = fy = 525 scaled to the width):
    (params, intr)."""
    from kinfu_tpu_torch.config import KinFuParams
    from kinfu_tpu_torch.geometry.intrinsics import Intrinsics

    f = 525.0 * width / 640
    params = KinFuParams(pyramid_height=3, icp_iters=(4, 5, 10), volume_dims=(dim,) * 3,
                         fused_mode=fused)
    return params, Intrinsics(width=width, height=height, fx=f, fy=f, cx=width / 2 - 0.5,
                              cy=height / 2 - 0.5)


def orbit(n: int, intr, corner: bool = False):
    """(frames [(depth, colour)], ground truth relative to the first
    camera) of the orbit at 0.3 degrees a frame, or of the corner orbit."""
    from kinfu_tpu_torch.data.synthetic import (
        corner_test_scene, default_test_scene, make_orbit_trajectory, yaw_trajectory)

    traj = make_orbit_trajectory(n, angle_step_deg=0.3)
    scene = default_test_scene()
    if corner:
        traj, scene = yaw_trajectory(traj), corner_test_scene()
    gt = [np.linalg.inv(traj[0]) @ T for T in traj]
    return [scene.render_frame(T, intr) for T in traj], gt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--fused", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--corner", action="store_true", help="the corner orbit")
    ap.add_argument("--streaming", action="store_true", help="the streaming step")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.frames < 3:
        ap.error("--frames must be at least 3 (frames 0-1 warm up)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("trace_step: CUDA is not available (pass --device cpu to run on the CPU)")
    import kinfu_tpu_torch  # noqa: F401  (full-f32 matmuls)

    params, intr = workload(args.dim, args.width, args.height, args.fused)
    frames, _ = orbit(args.frames, intr, args.corner)
    ms = time_steps(frames, params, intr, device, args.streaming)
    ms_frame = float(np.median(ms[2:]))
    prof, state = trace_steps(frames, params, intr, device, streaming=args.streaming)
    cuda = device.type == "cuda"
    kind = "device" if cuda else "cpu"
    busy = (f"kernels busy {prof.busy_ms:.3f} ms/frame in {prof.count:.0f} launches/frame"
            if cuda else f"cpu operators' self time {prof.busy_ms:.3f} ms/frame")
    idle = f", device idle {1 - prof.busy_ms / ms_frame:.1%}" if cuda else ""
    print(f"{kind}: {busy} over frames 2-{args.frames - 1}; the step {ms_frame:.3f} ms/frame "
          f"without the profiler (median){idle}; {prof.wall_ms:.1f} ms/frame under the profiler")
    print(f"{'ms/frame':>10} {'count':>6}  {kind} op")
    for name, total, n in prof.rows[:args.top]:
        print(f"{total / prof.calls:>10.4f} {n // prof.calls:>6d}  {name[:140]}")
    if cuda:
        for line in kernel_lines(prof):
            print(line)
        depth = torch.as_tensor(frames[-1][0], device=device)
        for name, busy, n in icp_profile(state, depth, params, intr):
            print(f"ICP of a frame, {name}: device {busy:.4f} ms in {n:.0f} launches")


if __name__ == "__main__":
    main()
