"""The sharded run of a cell: the port's sharded step, one rank a card.

A configuration whose "session" holds "shards": N runs here instead of
through one `KinFuSession` (`harness.run` dispatches on it), with
"shard_dim" (0 = Z slabs, the default; 1 = Y slabs) and "backend"
("nccl", the default, or "gloo", which may put every rank on one card or
on the CPU: for tests). N equals the cell's chips. Neither package has a
sharded streaming step, a sharded relocalizer or pose graph, so those
session modes are refused.

Rank 0 is the harness's own process: its clock gives `setup_s`, the
window and the frames' spans, and it prints the result. Ranks 1..N-1 are
started with the "spawn" method; rank r runs on cuda:r. Each rank renders
the traffic from the seed, joins the mesh (`parallel/mesh.py::init_mesh`)
and drives the port's sharded step as the port's tests do
(`init_state_local`, `make_sharded_step_fn`). A frame is a session's
frame: the host arrays uploaded to the rank's card, the rank's step, the
pose read back to the host.

  set-up   as a session run's, the mix's warm-up frames on every rank;
           each rank's state after the bootstrap frame copied to the host;
  window   back-to-back frames on every rank. Rank 0 ends it: after the
           frame at which its clock passes the deadline it publishes, in a
           shared value, the count of frames every rank runs, one more
           than it has run. No other rank can have passed that frame: the
           step's collectives hold each rank within one frame of rank 0,
           so each rank reads the count before it starts a frame after
           it, and every rank ends at the same frame with no rank left
           waiting in a collective. The harness adds no collective of its
           own to the frames. Before the two drawn frames and after them
           each rank copies its state to host memory and waits for the
           others (a barrier of the processes, not of the step); rank 0's
           clock is paused meanwhile, and the paused seconds are logged;
  traced   with `trace`, every rank runs the same TRACE_FRAMES frames
           under torch.profiler; rank 0's reduced trace is the readers'
           `ctx["trace"]`, the others' `ctx["rank_traces"]`;
  check    the state freed on every rank: `reference/shards.py` judges
           each rank's slab and rank 0 the pose and the maps, and rank 0
           gathers the parts through a gloo group of the harness's own.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from kfbench import gen, harness, work
from kfbench.reference import compare, shards
from kfbench.reference import kinfu as K

#: the shared count of frames before rank 0 has decided it
NEVER = 1 << 62
#: seconds the ranks wait for each other outside the step
WAIT_S = 900
#: seconds rank 0 waits after another rank has failed before it ends the
#: process itself (a collective waiting for the failed rank may not raise)
GRACE_S = 60
#: device memory (bytes) the reference's raycast needs beside the box
RAYCAST_ROOM = 4 << 30


def run(entry: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        check_span: int = harness.CHECK_SPAN, control_dt=None,
        step_factory: Optional[Callable] = None) -> dict:
    """One sharded run, this process being rank 0; returns what
    `harness.run` returns. `step_factory(params, intr, mesh)`, a function
    that pickles, gives each rank's step (tests plant faults with it)."""
    config = entry["config"]
    sess = config.get("session", {})
    world, chips = int(sess["shards"]), int(entry["cell"]["chips"])
    if world != chips:
        raise SystemExit(f"kfbench: the configuration asks for {world} shards and the cell for "
                         f"{chips} chips; a rank runs on each chip, so they must be equal")
    for mode in ("streaming", "relocalize", "pose_graph"):
        if sess.get(mode):
            raise SystemExit(f"kfbench: a sharded configuration cannot ask for {mode!r}: the "
                             f"port has no sharded form of it (nor has the JAX package)")
    device = torch.device(device)
    if device.type == "cuda":
        from kinfu_tpu_torch.ops import kernels

        kernels.library()  # built here once; the other ranks load it
    mp = multiprocessing.get_context("spawn")
    sync = (mp.Value("q", NEVER), mp.Barrier(world))
    workdir = tempfile.mkdtemp(prefix="kfbench-ranks-")
    job = dict(entry=entry, seed=seed, seconds=seconds, trace=trace, device=device.type,
               check_span=check_span, control_dt=control_dt, step_factory=step_factory,
               init=f"file://{workdir}/store", trace_frames=harness.TRACE_FRAMES,
               threads=max(1, (os.cpu_count() or 1) // world))
    procs = [mp.Process(target=_child, args=(r, job, sync, os.getpid()), daemon=True)
             for r in range(1, world)]
    done = threading.Event()
    try:
        for p in procs:
            p.start()
        threading.Thread(target=_watch, args=(procs, done), daemon=True).start()
        res = _rank(0, job, sync, t_start)
    finally:
        done.set()
        started = [p for p in procs if p.pid is not None]
        for p in started:
            p.join(timeout=GRACE_S)
        for p in started:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"kfbench: ranks 1..{world - 1} ended with codes {codes}")
    return res


def _watch(procs, done: threading.Event) -> None:
    """Rank 0's guard: once another rank has failed, give rank 0 GRACE_S
    seconds to see it, then end every rank and this process."""
    while not done.wait(1.0):
        if any(p.exitcode not in (None, 0) for p in procs):
            if done.wait(GRACE_S):
                return
            harness._log(f"a rank failed (exit codes {[p.exitcode for p in procs]}) and rank 0 "
                         f"is still waiting for it after {GRACE_S} s: every rank is ended")
            for p in procs:
                p.kill()
            os._exit(3)


def _orphaned(parent: int) -> None:
    """A rank's guard: end the rank once rank 0's process has gone."""
    while True:
        time.sleep(1.0)
        if os.getppid() != parent:
            os._exit(3)


def _child(rank: int, job: dict, sync, parent: int) -> None:
    threading.Thread(target=_orphaned, args=(parent,), daemon=True).start()
    try:
        torch.set_num_threads(job["threads"])
        import kinfu_tpu_torch  # noqa: F401  (full-float32 matmuls, as in run.py)

        if job["device"] == "cuda":
            from kinfu_tpu_torch.ops import kernels

            kernels.library(load_only=True)
        _rank(rank, job, sync)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def host_copy(state, device) -> dict:
    """A rank's state on the host, as `compare.py` takes a state: its slab
    (`shards.SlabCopy`), the model maps and the pose."""
    pose = torch.eye(4)
    pose[:3, :3], pose[:3, 3] = state.pose.R.cpu(), state.pose.t.cpu()
    return {"vol": shards.SlabCopy.of(state.vol, device),
            "vmaps": [m.cpu() for m in state.model_vmaps],
            "nmaps": [m.cpu() for m in state.model_nmaps], "pose": pose, "origin": None}


def _on(state: dict, device) -> dict:
    """A host copy's maps and pose on `device` (the slab stays on the
    host)."""
    return {"vol": state["vol"], "vmaps": [m.to(device) for m in state["vmaps"]],
            "nmaps": [m.to(device) for m in state["nmaps"]], "pose": state["pose"].to(device),
            "origin": None}


def _rank(rank: int, job: dict, sync, t_start: Optional[float] = None):
    """One rank's run; on rank 0 the result, on the others None."""
    import torch.distributed as dist

    from kinfu_tpu_torch.parallel.mesh import close_mesh, init_mesh
    from kinfu_tpu_torch.parallel.sharded import init_state_local, make_sharded_step_fn

    entry = job["entry"]
    config, mix = entry["config"], entry["mix"]
    sess = config["session"]
    world = int(sess["shards"])
    mesh = init_mesh(sess.get("backend", "nccl"), rank, world, job["init"], device=job["device"])
    mesh = dataclasses.replace(mesh, shard_dim=int(sess.get("shard_dim", 0)))
    try:
        group = dist.new_group(backend="gloo")
        return _Rank(job, mesh, group, sync, t_start).run(
            init_state_local, job["step_factory"] or make_sharded_step_fn)
    finally:
        close_mesh()


class _Rank:
    def __init__(self, job, mesh, group, sync, t_start):
        self.job, self.mesh, self.group = job, mesh, group
        self.stop, self.barrier = sync
        self.t_start = t_start
        self.dev = mesh.device
        self.rank, self.world = mesh.rank, mesh.world

    # ---- exchanges of the harness's own, outside the frames
    def wait(self) -> None:
        self.barrier.wait(WAIT_S)

    def gather(self, obj) -> Optional[list]:
        import torch.distributed as dist

        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def everyone(self, obj) -> list:
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def from_rank0(self, obj):
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    # ---- the run
    def run(self, init_state_local, step_factory):
        job, dev = self.job, self.dev
        entry = job["entry"]
        config, mix = entry["config"], entry["mix"]
        cam = harness._camera(config)
        seed = job["seed"] % (1 << 64)
        rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])

        t0 = time.perf_counter()
        traffic = gen.Traffic(mix, seed, cam, dev)
        t_render = time.perf_counter() - t0
        params, intr = harness.program_args(config)
        step = step_factory(params, intr, self.mesh)
        self.state = init_state_local(params, intr, self.mesh)
        self.record = [np.eye(4, dtype=np.float32)]
        self.count = 1

        def frame(k: int) -> bool:
            color, depth = traffic.frame(k)
            d = torch.as_tensor(np.asarray(depth, dtype=np.float32), device=dev)
            c = torch.as_tensor(np.asarray(color, dtype=np.uint8), device=dev)
            self.state, out = step(self.state, d, c)
            pose = out.pose_matrix.cpu().numpy()
            ok = bool(out.tracking_ok)
            if ok:  # the session's pose record (`pipeline/session.py`)
                if self.count >= 2:
                    self.record.append(pose)
                self.count += 1
            else:
                self.record = [np.eye(4, dtype=np.float32)]
                self.count = 1
            return ok

        # ---- warm-up: the bootstrap frame (kept for the check), then the mix's
        warm = max(1, int(mix["warmup_frames"]))
        for k in range(warm):
            frame(k)
            if k == 0:
                boot = host_copy(self.state, dev)
        n_warm = warm
        kc = int(rng.integers(1, job["check_span"]))
        taken = {}
        harness._sync(dev)
        self.wait()

        # ---- the measured window
        spans, oks, poses = [], [], []
        paused = 0.0

        def take(key: int) -> float:
            a = time.perf_counter()
            taken[key] = host_copy(self.state, dev)
            self.wait()
            return time.perf_counter() - a

        t_begin = time.perf_counter()
        deadline = t_begin + job["seconds"]
        i = 0
        t1 = t_begin
        while i < self.stop.value:
            if i == kc:
                paused += take(kc)
            t0 = time.perf_counter()
            ok = frame(n_warm + i)
            t1 = time.perf_counter()
            spans.append(t1 - t0)
            oks.append(ok)
            poses.append(self.record[-1])
            i += 1
            if i in (kc + 1, kc + 2):
                paused += take(i)
                t1 = time.perf_counter()
            if (self.rank == 0 and t1 - paused >= deadline and i >= kc + 2
                    and self.stop.value == NEVER):
                self.stop.value = i + 1
        t_end = t1
        n = i
        setup_s = None if self.t_start is None else t_begin - self.t_start

        # ---- the traced window
        prof_ctx = None
        log = []
        if job["trace"]:
            t0 = time.perf_counter()
            prof_ctx = self.traced(frame, n_warm + n)
            log.append(f"traced {job['trace_frames']} frames and read the trace in "
                       f"{time.perf_counter() - t0:.3f} s")
        found = harness.forbidden_modules()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        self.state = None
        del step
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # ---- the check
        t_check = time.perf_counter()
        st = compare.Setup(config)
        diag = []
        numbers, box_ok = self.check(st, traffic, boot, taken, n_warm, kc, diag)
        control = None
        if job["control_dt"] is not None:
            control = self.check(st, traffic, boot, taken, n_warm, kc, [], job["control_dt"])[0]
        t_check = time.perf_counter() - t_check
        del taken, boot
        if prof_ctx is not None:
            part = (self.rank, self.world, self.mesh.shard_dim)
            prof_ctx["work"] = [work.frame_work(st, traffic.frame(k)[1], p, None, part, dev)
                                for k, p in zip(prof_ctx["frames_idx"], prof_ctx["poses"])]
        parts = self.gather({"frames": n, "warm": n_warm, "peak": int(peak), "found": found,
                             "trace": prof_ctx, "paused": paused})
        if self.rank != 0:
            return None

        # ---- the result, on rank 0
        found = sorted({m for p in parts for m in p["found"]})
        if found:
            raise SystemExit(f"kfbench: the run loaded {found}")
        same = len({(p["frames"], p["warm"]) for p in parts}) == 1
        limits = entry["limits"]
        correct = compare.verdict(numbers, limits) and same and box_ok
        gt = [traffic.gt_pose(n_warm + j) for j in range(n)]
        window = t_end - t_begin - paused
        log += [f"set-up {setup_s:.3f} s (frames rendered in {t_render:.3f} s); the check took "
                f"{t_check:.3f} s on rank 0",
                f"{self.world} ranks ({self.mesh.backend}, slabs along array dim "
                f"{self.mesh.shard_dim}): frames run {[p['frames'] for p in parts]}, warm-up "
                f"{[p['warm'] for p in parts]}; the same on every rank: {same}",
                f"window {n} frames in {window:.6f} s after {n_warm} warm-up frames, the clock "
                f"paused {paused:.6f} s for the check's copies (ranks' pauses "
                f"{[round(p['paused'], 6) for p in parts]} s); checked window frames {kc} and "
                f"{kc + 1}",
                f"ATE over the window (aligned, vs ground truth): "
                f"{harness._ate_mm(poses, gt):.6f} mm"]
        if not all(oks):
            log.append(f"window frames that lost tracking: "
                       f"{[j for j, o in enumerate(oks) if not o]}")
        if prof_ctx is not None:
            w = [x for p in parts for x in (p["trace"]["work"] or [])]
            log.append(f"the traced frames' work, all ranks: a rank-frame updates "
                       f"{np.mean([x['voxels_updated'] for x in w]):.0f} voxels, its rays "
                       f"sample {np.mean([x['ray_voxels'] for x in w]):.0f}, least time "
                       f"{np.mean([x['least_s'] for x in w]) * 1e3:.6f} ms")
        e2e = {"frame_ms": window / n * 1e3,
               "frame_p95_ms": float(np.percentile(np.asarray(spans) * 1e3, 95)),
               "setup_s": setup_s}
        ctx = {"spans_ms": [s * 1e3 for s in spans], "trace": prof_ctx,
               "rank_traces": [p["trace"] for p in parts[1:]] if prof_ctx else None,
               "config": config, "cell": entry["cell"], "seconds": job["seconds"]}
        return harness.result(entry, job["trace"], correct, n, n - sum(oks), e2e, ctx,
                              self.device_dict(parts), numbers, log + diag, control)

    def traced(self, frame, first: int) -> dict:
        """The job's `trace_frames` frames under torch.profiler on this rank;
        its trace reduced (`trace.reduce`), the chrome trace written by rank
        0 alone."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from kfbench import trace as tr

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.dev.type == "cuda"
                                         else [])
        n = self.job["trace_frames"]
        poses = []
        with profile(activities=acts) as prof:
            for j in range(n):
                with record_function(tr.FRAME):
                    frame(first + j)
                poses.append(self.record[-1])
            harness._sync(self.dev)
        ctx = tr.reduce(prof, "trace.json.gz" if self.rank == 0 else None)
        ctx["frames_idx"] = list(range(first, first + n))
        ctx["poses"] = poses
        return ctx

    def device_dict(self, parts) -> dict:
        peaks = [p["peak"] for p in parts]
        if self.dev.type == "cuda":
            d = {"platform": "gpu", "kind": torch.cuda.get_device_name(self.dev),
                 "count": self.world, "memory_peak_bytes": max(peaks)}
        else:
            d = {"platform": "cpu", "kind": "cpu", "count": self.world, "memory_peak_bytes": 0}
        d["memory_peak_bytes_ranks"] = peaks
        traces = [p["trace"] for p in parts]
        if traces[0] is not None:
            busy = [t["busy_s"] for t in traces]
            d["busy_s"] = sum(busy) / len(busy)
            d["window_s"] = traces[0]["window_s"]
            d["busy_s_ranks"] = busy
            d["window_s_ranks"] = [t["window_s"] for t in traces]
        return d

    # ---- the check
    def check(self, st, traffic, boot, taken, n_warm: int, kc: int, diag: list, dt=None):
        """The five numbers (on rank 0; {} elsewhere) and whether rank 0
        could hold the maps' box: of the program's states, or with `dt` of
        the reference put in its place in dt (the control)."""
        dev, f32 = self.dev, torch.float32
        slab = work.slab_of(st, self.rank, self.world, self.mesh.shard_dim)
        readings, box_ok = [], True
        keep = (torch.empty(shards.slab_shape(st, slab), dtype=torch.int16)
                if dt is not None else None)

        def measure(k, t):
            color, depth = traffic.frame(k)
            d = torch.as_tensor(depth.astype(np.float32), device=dev)
            return color, K.measurement(d, st.cam, st.cfg, t)

        # the bootstrap frame, fused at the identity pose into an empty grid
        color, (ds, vs, ns) = measure(0, f32)
        vp = st.vol_pose(None, dev)
        empty = shards.empty(st, slab)
        if dt is None:
            counts = shards.fuse_counts(st, slab, ds[0], color, empty, boot["vol"], vp, dev)
            maps = _on(boot, dev)
        else:
            dsc, vsc, nsc = measure(0, dt)[1]
            counts = shards.fuse_counts(st, slab, ds[0], color, empty, None, vp, dev,
                                        control=(dt, dsc[0], vp.to(dt)), keep=keep)
            maps = {"vmaps": [v.float() for v in vsc], "nmaps": [n.float() for n in nsc]}
        out = {"fuse_miss_pct": self.fuse_pct(diag, "bootstrap", counts)}
        if self.rank == 0:
            out["pyramid_miss_pct"] = compare._pyr_miss_pct(
                maps["vmaps"], maps["nmaps"], [v.float() for v in vs], [n.float() for n in ns])
        readings.append(out)

        for j in (kc, kc + 1):
            before = _on(taken[j], dev)
            color, (ds, vs, ns) = measure(n_warm + j, f32)
            if dt is None:
                prog = _on(taken[j + 1], dev)
                pose = prog["pose"]
                control = None
            else:
                dsc, vsc, nsc = measure(n_warm + j, dt)[1]
                pose = None
                if self.rank == 0:
                    inc, _, _ = K.icp(vsc, nsc, before["vmaps"], before["nmaps"], st.cam,
                                      st.cfg, dt)
                    pose = (before["pose"].to(dt) @ inc).float().cpu()
                pose = self.from_rank0(pose).to(dev)
                control = (dt, dsc[0], torch.linalg.inv(pose.float()).to(dt) @ vp.to(dt))
            out = {}
            if self.rank == 0:
                out["pose_gap_mm"] = compare.pose_gap_mm(st, vs, ns, before, pose)
            counts = shards.fuse_counts(st, slab, ds[0], color, before["vol"],
                                        None if dt else prog["vol"],
                                        torch.linalg.inv(pose.float()) @ vp, dev,
                                        control=control, keep=keep)
            out["fuse_miss_pct"] = self.fuse_pct(diag, f"frame {j}", counts)
            copy = taken[j + 1]["vol"] if dt is None else shards.SlabCopy.of([keep], dev)
            box = self.gather_box(st, copy, diag)
            if box is None:
                box_ok = False
                out["map_miss_pct"] = float("nan")
            elif self.rank == 0:
                cam2vol = torch.linalg.inv(vp) @ pose.float()
                if dt is None:
                    pv, pn = prog["vmaps"][0], prog["nmaps"][0]
                else:
                    cv, cn = shards.raycast_box(st, box[0], box[1], cam2vol.to(dt), dt)
                    pv, pn = cv.float(), cn.float()
                vm, nm = shards.raycast_box(st, box[0], box[1], cam2vol, f32)
                out["map_miss_pct"] = compare._map_miss_pct(pv, pn, vm, nm, st.grid.voxel[0],
                                                            diag)
                del box
            readings.append(out)
            if self.rank == 0:
                diag.append(f"frame {j}: {out}")
        return (compare.worst(readings) if self.rank == 0 else {}), box_ok

    def fuse_pct(self, diag: list, what: str, counts: dict) -> float:
        """`fuse_miss_pct` of the ranks' summed counts."""
        per = self.everyone(counts)
        if self.rank == 0:
            diag.append(f"fuse, {what}: per rank {[c['n'] for c in per]} voxels updated or "
                        f"changed, {[c['bad'] for c in per]} mismatched, weight differs on "
                        f"{[c['wbad'] for c in per]}")
        return shards.miss_pct(per)

    def gather_box(self, st, copy, diag: list):
        """The box of every rank's nonzero voxels (`shards.union_box` of
        their copies), its TSDF gathered from the copies onto rank 0's card:
        (box, lo) on rank 0, () elsewhere; None on every rank where it does
        not fit there."""
        import torch.distributed as dist

        dim = self.mesh.shard_dim
        lo, hi = shards.union_box(st, self.everyone(
            shards.grid_box(copy, work.slab_of(st, self.rank, self.world, dim))))
        shape = tuple(b - a for a, b in zip(lo, hi))
        need = 2 * int(np.prod(shape))
        fits = True
        if self.rank == 0 and self.dev.type == "cuda":
            free = torch.cuda.mem_get_info(self.dev)[0]
            fits = need + RAYCAST_ROOM <= free
            if not fits:
                diag.append(f"map: the box of fused voxels {lo}..{hi} ({need} B) does not fit on "
                            f"rank 0's card ({free} B free, {RAYCAST_ROOM} B kept for the "
                            f"raycast): not judged")
        if not self.from_rank0(fits):
            return None
        if self.rank == 0:
            diag.append(f"map: the box of fused voxels {lo}..{hi}, {need} B gathered on rank 0")
            box = torch.zeros(shape, dtype=torch.int16, device=self.dev)
        for r in range(self.world):
            if r != self.rank and self.rank != 0:
                continue
            org = shards.slab_origin(work.slab_of(st, r, self.world, dim))
            sshape = shards.slab_shape(st, work.slab_of(st, r, self.world, dim))
            # the box within rank r's slab, in the slab's indices
            a0 = [max(lo[d], org[d]) - org[d] for d in range(3)]
            a1 = [min(hi[d], org[d] + sshape[d]) - org[d] for d in range(3)]
            if any(x >= y for x, y in zip(a0, a1)):
                continue
            for sl in shards.blocks([y - x for x, y in zip(a0, a1)]):
                za, zb = a0[0] + sl.start, a0[0] + sl.stop
                if r == self.rank:
                    part = copy.region((za, a0[1], a0[2]), (zb, a1[1], a1[2]), "cpu", 0)
                    if r != 0:
                        dist.send(part.view(torch.uint8), dst=0, group=self.group)
                        continue
                else:
                    part = torch.empty((zb - za, a1[1] - a0[1], a1[2] - a0[2]),
                                       dtype=torch.int16)
                    dist.recv(part.view(torch.uint8), src=r, group=self.group)
                b0 = [za + org[0] - lo[0], a0[1] + org[1] - lo[1], a0[2] + org[2] - lo[2]]
                box[b0[0]:b0[0] + part.shape[0], b0[1]:b0[1] + part.shape[1],
                    b0[2]:b0[2] + part.shape[2]].copy_(part)
        return (box, lo) if self.rank == 0 else ()
