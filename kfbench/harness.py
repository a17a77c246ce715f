"""One run of one cell: set-up, the measured window, the traced window,
and the check against the plain reference.

The system under test is `kinfu_tpu_torch.KinFuSession`, driven the way
its users drive it: one `pipeline(colour, depth_mm)` call a frame with the
frame's host arrays, each call returning once the frame's pose is on the
host, the next frame handed in after it (a closed loop, one frame in
flight).

  set-up   import, the kernel library (built on a checkout's first run),
           the traffic's frames, the session and its warm-up frames; the
           bootstrap frame's state is kept for the check;
  window   back-to-back `pipeline()` calls for `seconds`; the span of each
           call on the host clock; the state before, between and after two
           frames drawn from the seed copied aside on the device;
  traced   with `trace`, TRACE_FRAMES more frames under torch.profiler,
           each call inside a `kfbench.frame` range;
  check    once the window has closed, the memory peak read and the
           session freed: the reference judges the bootstrap frame and the
           two drawn frames (`reference/compare.py`).

Nothing here knows a configuration, a mix or a per-layer metric by name:
they come from `configs/`, `traffic/` and `metrics/` through
BENCHMARK.json.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from kfbench import gen, work
from kfbench.reference import compare
from kfbench.reference.kinfu import Camera

HERE = Path(__file__).resolve().parent
#: frames profiled in a traced run, after the measured window
TRACE_FRAMES = 24
#: the drawn frames lie among the window's first frames
CHECK_SPAN = 120
#: warm-up frames at most while a mix waits for the grid to shift
MAX_WARMUP = 600
#: modules that no run may load, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "kinfu_tpu", "chip_smoke")


def load_cell(workload: str, root: Path = HERE.parent) -> dict:
    """The cell's entries: its BENCHMARK.json entry, configuration file,
    traffic mix, limits and metric entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"kfbench: no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return {"cell": cell, "config": config, "mix": mix, "limits": limits,
            "end_to_end": bench["end_to_end"], "per_layer": bench["per_layer"],
            "run_seconds": bench["run_seconds"]}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _kinfu_state(sess):
    return sess.state.kinfu if sess.streaming else sess.state


class Snapshots:
    """Copies of the session's state, into buffers allocated at set-up (a
    copy in the window allocates nothing)."""

    def __init__(self, sess, n: int):
        st = _kinfu_state(sess)
        self.bufs = [{"vol": tuple(torch.empty_like(a) for a in st.vol),
                      "vmaps": [torch.empty_like(m) for m in st.model_vmaps],
                      "nmaps": [torch.empty_like(m) for m in st.model_nmaps],
                      "pose": torch.eye(4, dtype=torch.float32, device=st.vol.tsdf.device),
                      "origin": None} for _ in range(n)]
        self.taken: Dict[int, dict] = {}

    def take(self, sess, key: int) -> None:
        buf = self.bufs[len(self.taken)]
        st = _kinfu_state(sess)
        for b, a in zip(buf["vol"], st.vol):
            b.copy_(a)
        for b, a in zip(buf["vmaps"] + buf["nmaps"], st.model_vmaps + st.model_nmaps):
            b.copy_(a)
        buf["pose"][:3, :3].copy_(st.pose.R)
        buf["pose"][:3, 3].copy_(st.pose.t)
        if sess.streaming:
            buf["origin"] = sess.state.origin_vox.clone()
        self.taken[key] = buf


def host_state(sess) -> dict:
    """The session's state copied to the host."""
    st = _kinfu_state(sess)
    pose = torch.eye(4)
    pose[:3, :3], pose[:3, 3] = st.pose.R.cpu(), st.pose.t.cpu()
    return {"vol": tuple(a.cpu().clone() for a in st.vol),
            "vmaps": [m.cpu().clone() for m in st.model_vmaps],
            "nmaps": [m.cpu().clone() for m in st.model_nmaps], "pose": pose,
            "origin": sess.state.origin_vox.cpu().clone() if sess.streaming else None}


def to_device(state: dict, device) -> dict:
    return {"vol": tuple(a.to(device) for a in state["vol"]),
            "vmaps": [m.to(device) for m in state["vmaps"]],
            "nmaps": [m.to(device) for m in state["nmaps"]],
            "pose": state["pose"].to(device),
            "origin": None if state["origin"] is None else state["origin"].cpu()}


def program_args(config: dict):
    """The port's (KinFuParams, Intrinsics) of the configuration file."""
    from kinfu_tpu_torch.config import KinFuParams
    from kinfu_tpu_torch.geometry.intrinsics import Intrinsics

    p = dict(config["params"])
    for k in ("icp_iters", "volume_dims", "volume_range", "volume_origin"):
        if k in p and p[k] is not None:
            p[k] = tuple(p[k])
    s = config["sensor"]
    intr = Intrinsics(width=s["width"], height=s["height"], fx=s["fx"], fy=s["fy"], cx=s["cx"],
                      cy=s["cy"])
    return KinFuParams(**p), intr


def make_session(config: dict, device):
    """The system under test, configured from the configuration file: its
    "params", its "sensor" and the session's modes under "session"
    (`streaming`, `relocalize`, `pose_graph`, each off by default)."""
    from kinfu_tpu_torch.pipeline.session import KinFuSession

    params, intr = program_args(config)
    sess_cfg = config.get("session", {})
    sess = KinFuSession(intr, params, device=device,
                        streaming=bool(sess_cfg.get("streaming", False)),
                        relocalize=bool(sess_cfg.get("relocalize", False)),
                        pose_graph=bool(sess_cfg.get("pose_graph", False)))
    return sess


def _camera(config: dict) -> Camera:
    s = config["sensor"]
    return Camera(int(s["width"]), int(s["height"]), float(s["fx"]), float(s["fy"]),
                  float(s["cx"]), float(s["cy"]))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _ate_mm(est: List[np.ndarray], gt: List[np.ndarray]) -> float:
    """Aligned absolute trajectory error (Umeyama, rigid), RMSE in mm."""
    e = np.stack([T[:3, 3] for T in est]).astype(np.float64)
    g = np.stack([T[:3, 3] for T in gt]).astype(np.float64)
    if len(e) >= 3:
        me, mg = e.mean(0), g.mean(0)
        U, _, Vt = np.linalg.svd((g - mg).T @ (e - me) / len(e))
        S = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        e = (R @ e.T).T + (mg - R @ me)
    return float(np.sqrt(np.mean(np.sum((e - g) ** 2, axis=1)))) * 1e3


def _log(msg: str) -> None:
    print(f"kfbench: {msg}", file=sys.stderr, flush=True)


def run(entry: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        session_factory: Callable = make_session, check_span: int = CHECK_SPAN,
        control_dt=None, max_warmup: int = MAX_WARMUP) -> dict:
    """One run. Returns the result dict (the keys of the printed line) and,
    under "log", what the earlier lines print. A configuration whose
    session asks for "shards" runs the sharded step, a rank a card
    (`ranks.run`)."""
    if entry["config"].get("session", {}).get("shards"):
        from kfbench import ranks

        return ranks.run(entry, seed, seconds, trace, device, t_start, check_span=check_span,
                         control_dt=control_dt)
    config, mix, cell = entry["config"], entry["mix"], entry["cell"]
    device = torch.device(device)
    cam = _camera(config)
    seed %= 1 << 64
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])

    t0 = time.perf_counter()
    traffic = gen.Traffic(mix, seed, cam, device)
    t_render = time.perf_counter() - t0
    sess = session_factory(config, device)

    # ---- warm-up: the bootstrap frame (kept for the check), then the
    # mix's frames, and on a moving grid until it has shifted
    k = 0
    boot = None
    warm = int(mix["warmup_frames"])
    log = []
    while True:
        color, depth = traffic.frame(k)
        sess.pipeline(color, depth)
        k += 1
        if k == 1:
            boot = host_state(sess)
        if k >= warm and (not mix.get("until_shift") or not sess.streaming
                          or bool((sess.state.origin_vox != 0).any())):
            break
        if k >= max_warmup:
            log.append(f"the grid did not shift in {k} warm-up frames")
            break
    n_warm = k
    kc = int(rng.integers(1, check_span))
    snaps = Snapshots(sess, 3)
    _sync(device)

    # ---- the measured window
    spans, oks, poses = [], [], []
    t_begin = time.perf_counter()
    deadline = t_begin + seconds
    i = 0
    while True:
        if i == kc:
            snaps.take(sess, kc)
        color, depth = traffic.frame(n_warm + i)
        t0 = time.perf_counter()
        ok = sess.pipeline(color, depth)
        t1 = time.perf_counter()
        spans.append(t1 - t0)
        oks.append(bool(ok))
        poses.append(sess.get_cur_camera_pose())
        i += 1
        if i in (kc + 1, kc + 2):
            snaps.take(sess, i)
        if t1 >= deadline and i >= kc + 2:
            break
    t_end = t1
    n = i
    setup_s = t_begin - t_start

    # ---- the traced window
    prof_ctx = None
    if trace:
        t0 = time.perf_counter()
        prof_ctx = _traced(sess, traffic, n_warm + n, device)
        log.append(f"traced {TRACE_FRAMES} frames and read the trace in "
                   f"{time.perf_counter() - t0:.3f} s")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"kfbench: the run loaded {found}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    record = [p.copy() for p in sess.pose_record]
    del sess
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check
    t_check = time.perf_counter()
    st = compare.Setup(config)
    readings, diag = [], []
    c0, d0 = traffic.frame(0)
    d0 = d0.astype(np.float32)
    readings.append(compare.judge_start(st, d0, c0, to_device(boot, device), diag))
    for j in (kc, kc + 1):
        c, d = traffic.frame(n_warm + j)
        readings.append(compare.judge_step(st, d.astype(np.float32), c, snaps.taken[j],
                                           snaps.taken[j + 1], diag))
        diag.append(f"frame {j}: " + json.dumps(readings[-1]))
    numbers = compare.worst(readings)
    log.append(f"set-up {setup_s:.3f} s (frames rendered in {t_render:.3f} s); the check took "
               f"{time.perf_counter() - t_check:.3f} s")
    control = None
    if control_dt is not None:
        cd = []
        cr = [compare.judge_start(st, d0, c0, compare.start_outputs(st, d0, c0, device,
                                                                    control_dt), cd)]
        for j in (kc, kc + 1):
            c, d = traffic.frame(n_warm + j)
            d = d.astype(np.float32)
            out = compare.step_outputs(st, d, c, snaps.taken[j], control_dt)
            cr.append(compare.judge_step(st, d, c, snaps.taken[j], out, cd))
            del out
        control = compare.worst(cr)
        diag += ["control " + x for x in cd]
    limits = entry["limits"]
    correct = compare.verdict(numbers, limits)
    gt = [traffic.gt_pose(n_warm + j) for j in range(n)]
    log += [f"window {n} frames in {t_end - t_begin:.6f} s after {n_warm} warm-up frames; "
            f"checked window frames {kc} and {kc + 1}",
            f"ATE over the window (aligned, vs ground truth): {_ate_mm(poses, gt):.6f} mm"]
    if not all(oks):
        log.append(f"window frames that lost tracking: {[j for j, o in enumerate(oks) if not o]}")
    del snaps
    if st.margin is not None:
        ors = work.origins(st, record)
        if len(ors) >= n_warm + n:
            moved = sum(bool((ors[n_warm + j] != ors[n_warm + j - 1]).any()) for j in range(n))
            log.append(f"window frames whose grid shifted (the reference's rule on the session's "
                       f"poses): {moved} of {n}")
    if prof_ctx is not None:
        t0 = time.perf_counter()
        prof_ctx["work"] = _work(st, traffic, prof_ctx, record)
        w = prof_ctx["work"]
        if w:
            log.append(f"the traced frames' work counted in {time.perf_counter() - t0:.3f} s: "
                       f"a frame updates {np.mean([x['voxels_updated'] for x in w]):.0f} voxels, "
                       f"its rays sample {np.mean([x['ray_voxels'] for x in w]):.0f} voxels, "
                       f"{np.mean([x['bytes'] for x in w]):.0f} B and "
                       f"{np.mean([x['ops'] for x in w]):.0f} operations, least time "
                       f"{np.mean([x['least_s'] for x in w]) * 1e3:.6f} ms")

    e2e = {"frame_ms": (t_end - t_begin) / n * 1e3,
           "frame_p95_ms": float(np.percentile(np.asarray(spans) * 1e3, 95)),
           "setup_s": setup_s}
    ctx = {"spans_ms": [s * 1e3 for s in spans], "trace": prof_ctx, "config": config,
           "cell": cell, "seconds": seconds}
    return result(entry, trace, correct, n, n - sum(oks), e2e, ctx,
                  _device(device, peak, prof_ctx), numbers, log + diag, control)


def result(entry: dict, trace: bool, correct: bool, n: int, failed: int, e2e: dict, ctx: dict,
           device: dict, numbers: dict, log: list, control) -> dict:
    """The result dict of a run: the end-to-end metrics `e2e`, or with
    `trace` the per-layer metrics that the readers find in `ctx`, the
    device, the numbers checked beside their limits, and under "log" the
    run's lines and those of its trace."""
    prof_ctx = ctx["trace"]
    res = {"correct": bool(correct), "attempted": n, "failed": failed}
    if trace:
        metrics = {}
        for m in entry["per_layer"]:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in entry["end_to_end"] if m["name"] in e2e}
    res["metrics"] = metrics
    res["device"] = device
    if trace and prof_ctx is not None:
        res["breakdown"] = prof_ctx["breakdown"]
    res["checks"] = {k: {"value": numbers.get(k, math.nan), "limit": v}
                     for k, v in entry["limits"].items()}
    res["log"] = log + (prof_ctx.get("log", []) if prof_ctx else [])
    if control is not None:
        res["system"], res["control"] = numbers, control
    return res


def _work(st, traffic, prof_ctx: dict, record) -> list:
    """Each traced frame's least device time (`work.frame_work`), at the
    pose the session reported for it and, on a moving grid, the origin the
    reference's rule gives from the session's pose record (the first
    origin where a lost frame restarted the record)."""
    idx = prof_ctx["frames_idx"]
    ors = work.origins(st, record)
    out = []
    for j, k in enumerate(idx):
        _, depth = traffic.frame(k)
        o = ors[k] if len(record) == idx[-1] + 1 else ors[0]
        out.append(work.frame_work(st, depth, prof_ctx["poses"][j], o))
    return out


def _device(device, peak: int, prof_ctx) -> dict:
    if device.type == "cuda":
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
             "memory_peak_bytes": int(peak)}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if prof_ctx is not None:
        d["busy_s"] = prof_ctx["busy_s"]
        d["window_s"] = prof_ctx["window_s"]
    return d


def _traced(sess, traffic, first: int, device) -> dict:
    """TRACE_FRAMES frames under torch.profiler; the trace reduced to what
    the per-layer readers take (`trace.reduce`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from kfbench import trace as tr

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    poses = []
    with profile(activities=acts) as prof:
        for j in range(TRACE_FRAMES):
            color, depth = traffic.frame(first + j)
            with record_function(tr.FRAME):
                sess.pipeline(color, depth)
            poses.append(sess.get_cur_camera_pose())
        _sync(device)
    ctx = tr.reduce(prof)
    ctx["frames_idx"] = list(range(first, first + TRACE_FRAMES))
    ctx["poses"] = poses
    return ctx


def read_metric(name: str, ctx: dict) -> Optional[float]:
    """The per-layer metric `name`, from its reader `metrics/<name>.py`
    (its `read(ctx)`), or None where the reader finds nothing."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"kfbench_metric_{len(name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    v = mod.read(ctx)
    return None if v is None else float(v)
