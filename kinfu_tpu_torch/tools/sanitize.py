"""The port's sanitizer pass, the counterpart of tests/test_sanitizers.py.

Two parts:

(a) On the card: every form of the five CUDA kernels (K1-K5) and of the
    march kernels (M1, M2) runs in the bounds-checked build of csrc/
    (`-DKINFU_CHECKED -lineinfo`, csrc/checked.cuh), in which every global
    load and store of a kernel traps on an index outside the array that
    the wrapper passed, and the launch then fails at the next
    synchronisation. The array lengths are
    the tensors' numel, so an overrun is caught even where it would land
    inside another tensor of PyTorch's caching allocator.
    compute-sanitizer exists on the card's machine but refuses the device
    ("Device not supported"), so racecheck (shared-memory races), initcheck
    (reads of uninitialised memory) and synccheck are not run.

        python -m kinfu_tpu_torch.tools.sanitize --scale main|test
        python -m kinfu_tpu_torch.tools.sanitize --negative

    `--scale main` uses the main path's shapes (640x480, 512^3, a 3-level
    pyramid), `--scale test` 160x120 and 128^3 (2 levels). The run launches,
    each followed by a synchronisation: K1's one-iteration form at every
    level, its finishing form through one `rigid_icp` host call and its
    row-shard form on the 4 row shards of level 0 (120 rows at main); K2's
    six-face launch with every gate on and with the step's gates; K3 on
    each face, on a gated-off face whose stack K2 left unwritten, and on an
    interior Z slab and Y slab (the Y slab's +-x faces in the (2, 1, 0)
    frame); K4 on each face and on the halo-padded Z and Y slabs; K5's
    six-face composite; M1 on the volume and in its Z-slab form, and M2;
    all on the volume and model maps of 3 frames of the fused orbit and on
    frame 3; then the corner orbit up to its first frame with two live
    faces. It prints each kernel's launches
    (`ops/kernels.py`'s counts) on its last line as `launches {json}`. `--negative` calls K5's C entry directly with a
    vertex buffer one row short, which must trap; a run that ends without
    a fault prints "negative: no fault" and exits 0.
    `run_child` runs either as a subprocess and parses its output; it needs
    the checked build made (`ops/kernels.py::timed_build` makes both).

(b) On the CPU: `IndexChecks`, a TorchDispatchMode that does what
    `checkify`'s index and division checks do for the JAX step: every
    index of an indexing, gather or scatter op must lie in [0, size), and
    an integer division must not divide by zero. PyTorch wraps a negative
    index silently (as `jnp` clamps), which is the fault class it catches.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ---- (b) IndexChecks ---------------------------------------------------------

_aten = torch.ops.aten


class IndexCheckError(RuntimeError):
    """An index outside [0, size) or an integer division by zero."""


#: ops whose `index` argument (position 2) indexes dimension `dim`
#: (position 1) of their first argument
_DIM_INDEX = {_aten.index_select, _aten.gather, _aten.scatter, _aten.scatter_,
              _aten.scatter_add, _aten.scatter_add_, _aten.scatter_reduce,
              _aten.scatter_reduce_, _aten.index_add, _aten.index_add_, _aten.index_copy,
              _aten.index_copy_, _aten.index_fill, _aten.index_fill_}
#: ops whose `indices` list (position 1) indexes their first argument's
#: dimensions in order, as advanced indexing does
_LIST_INDEX = {_aten.index, _aten.index_put, _aten.index_put_, _aten._index_put_impl_}
#: ops whose `index` (position 1) indexes their first argument flattened
_FLAT_INDEX = {_aten.take, _aten.put, _aten.put_}
_DIVISION = {_aten.div, _aten.div_, _aten.floor_divide, _aten.floor_divide_,
             _aten.remainder, _aten.remainder_, _aten.fmod, _aten.fmod_}


def _integral(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool)
    return isinstance(x, int) and not isinstance(x, bool)


class IndexChecks(TorchDispatchMode):
    """Raise `IndexCheckError`, naming the op, before an op runs with an
    index outside [0, size) (advanced indexing and index_put, index_select,
    gather, scatter*, index_add/copy/fill, take, put) or an integer
    division (div, floor_divide, remainder, fmod with integer operands) by
    zero. Reads every index on the host: a CPU tool."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = func.overloadpacket
        if op in _DIM_INDEX:
            src, dim, index = args[0], args[1], args[2]
            size = src.shape[dim] if src.dim() else 1
            self._bounds(func, index, size)
        elif op in _LIST_INDEX:
            src, d = args[0], 0
            for idx in args[1]:
                if idx is None:
                    d += 1
                elif idx.dtype in (torch.bool, torch.uint8):
                    d += idx.dim()
                else:
                    self._bounds(func, idx, src.shape[d])
                    d += 1
        elif op in _FLAT_INDEX:
            self._bounds(func, args[1], args[0].numel())
        elif op in _DIVISION and len(args) > 1 and _integral(args[0]) and _integral(args[1]):
            divisor = args[1]
            zero = bool((divisor == 0).any()) if isinstance(divisor, torch.Tensor) else divisor == 0
            if zero:
                raise IndexCheckError(f"{func}: integer division by zero")
        return func(*args, **kwargs)

    @staticmethod
    def _bounds(func, index: torch.Tensor, size: int) -> None:
        if index.numel() == 0:
            return
        lo, hi = int(index.min()), int(index.max())
        if lo < 0 or hi >= size:
            raise IndexCheckError(f"{func}: index range [{lo}, {hi}] outside [0, {size})")


# ---- (a) the kernel forms in the checked build ---------------------------------

#: (width, height, volume side, pyramid levels, ICP iterations, raycast face)
SCALES = {"main": (640, 480, 512, 3, (4, 5, 10), (640, 261.0)),
          "test": (160, 120, 128, 2, (3, 4), (256, 104.0))}
#: ranks whose slabs and row shards the forms take
RANKS = 4
#: the most corner-orbit frames to reach a frame with two live faces
CORNER_FRAMES = 30
#: the last line of a child run
LAUNCHES_TAG = "launches "


def configure(scale: str):
    """(params, intr) of a scale: the bench workload's at "main"."""
    from kinfu_tpu_torch.config import KinFuParams
    from kinfu_tpu_torch.geometry.intrinsics import Intrinsics

    w, h, dim, levels, iters, face = SCALES[scale]
    f = 525.0 * w / 640
    params = KinFuParams(pyramid_height=levels, icp_iters=iters, volume_dims=(dim,) * 3,
                         raycast_face=face)
    return params, Intrinsics(width=w, height=h, fx=f, fy=f, cx=w / 2 - 0.5, cy=h / 2 - 0.5)


def _log(msg: str) -> None:
    print(msg, flush=True)


def _dev_frames(frames, device):
    return [(torch.as_tensor(d, device=device), torch.as_tensor(c, device=device))
            for d, c in frames]


def _sync(what: str) -> None:
    torch.cuda.synchronize()
    _log(f"  {what}: done")


def padded_slab(tsdf, sd: int, rank: int, ranks: int, halo: int):
    """Rank `rank` of `ranks`' slab of `tsdf` along `sd` with `halo` rows of
    its neighbours a side and zero rows past the volume: what
    `parallel/mesh.py::halo_exchange` gives the rank."""
    L = tsdf.shape[sd]
    Ll = L // ranks
    lo, hi = rank * Ll - halo, (rank + 1) * Ll + halo
    parts = []
    if lo < 0:
        parts.append(tsdf.new_zeros([-lo if i == sd else s for i, s in enumerate(tsdf.shape)]))
    parts.append(tsdf.narrow(sd, max(lo, 0), min(hi, L) - max(lo, 0)))
    if hi > L:
        parts.append(tsdf.new_zeros([hi - L if i == sd else s for i, s in enumerate(tsdf.shape)]))
    return torch.cat(parts, dim=sd).contiguous()


def launch_icp(state, depth, params, intr) -> None:
    """K1: the one-iteration form at every level, the finishing form (one
    rigid_icp host call) and the row-shard form on the level-0 row shards."""
    from kinfu_tpu_torch.frontend.maps import build_measurement_pyramid
    from kinfu_tpu_torch.geometry.se3 import Pose, rodrigues
    from kinfu_tpu_torch.ops import icp_warped as iw
    from kinfu_tpu_torch.parallel.mesh import Mesh
    from kinfu_tpu_torch.parallel.sharded import row_shard
    from kinfu_tpu_torch.tracking import icp as ticp

    p, dev = params, depth.device
    _, cvs, cns = build_measurement_pyramid(
        depth, intr, pyramid_height=p.pyramid_height,
        bfilter_kernel_size=p.bfilter_kernel_size, bfilter_color_sigma=p.bfilter_color_sigma,
        bfilter_spatial_sigma=p.bfilter_spatial_sigma, depth_scale=p.depth_scale,
        max_dist=p.dfilter_dist, normal_disc_threshold=p.normal_disc_threshold)
    sin_t = math.sin(math.radians(p.icp_angle_threshold))
    inc = Pose(rodrigues(torch.tensor([0.002, -0.004, 0.001], device=dev)),
               torch.tensor([0.004, -0.002, 0.003], device=dev))
    mv, mn = state.model_vmaps, state.model_nmaps
    for level in range(p.pyramid_height):
        iw.icp_normal_eqs_warped(inc, cvs[level], cns[level], mv[level], mn[level],
                                 intr.level(level), p.icp_dist_threshold, sin_t)
        _sync(f"K1 one-iteration form, level {level} ({cvs[level].shape[0]} rows)")
    ticp.rigid_icp(cvs, cns, mv, mn, intr, p)
    _sync(f"K1 finishing form, one rigid_icp call ({sum(p.icp_iters)} launches)")
    for r in range(RANKS):
        mesh = Mesh(world=RANKS, rank=r, device=dev, backend="gloo")
        cv, cn = row_shard(cvs[0], mesh), row_shard(cns[0], mesh)
        iw.icp_normal_eqs_warped(inc, cv, cn, mv[0], mn[0], intr, p.icp_dist_threshold, sin_t)
        _sync(f"K1 row-shard form, shard {r} of level 0 ({cv.shape[0]} rows)")


def launch_faces(vol, frame, T, params, intr) -> None:
    """K2 with every gate on and with the step's gates; K3 on each face
    (every gate on), on a gated-off face of the step's gates, and on an
    interior Z and Y slab; K4 on each face and on the halo-padded Z and Y
    slabs; K5's six-face composite. `vol` is updated in place."""
    from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
    from kinfu_tpu_torch.ops import face_integrate as fi
    from kinfu_tpu_torch.ops import face_raycast as fr
    from kinfu_tpu_torch.ops import facewarp as fw
    from kinfu_tpu_torch.parallel.sharded import HALO8, ray_shard
    from kinfu_tpu_torch.volume.integrate import fold_shard_origin
    from kinfu_tpu_torch.volume.tsdf import TSDFVolume, pack_rgb

    dev = vol.tsdf.device
    depth, color = frame
    depth_m = depth.to(torch.float32) * np.float32(params.depth_scale)
    col_packed = pack_rgb(color)
    volp = pose_from_matrix(torch.as_tensor(params.volume_pose, device=dev))
    cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32, device=dev))
    vol2cam, cam2vol = compose(inverse(cam), volp), compose(inverse(volp), cam)
    fspec = fw.default_face_spec()
    size, focal = params.raycast_face
    rspec = fr.RaySpec(int(size), float(focal))
    vs = params.voxel_size
    on = torch.ones((), dtype=torch.bool, device=dev)

    def stacks(v2c, dims_xyz, frames, gates):
        geo = [fw.face_geometry(v2c, f, dims_xyz, vs) for f in frames]
        prm6 = torch.stack([fw.face_params(A, intr, gates[k], fspec)
                            for k, (A, _) in enumerate(geo)])
        return geo, prm6, fw.build_faces(depth_m, col_packed, prm6, fspec)

    def sweep(v, f, frm, geo, prm6, built, gate):
        rk, ck, mk = built
        prm3 = fi.sweep_params(geo[f][1], fw.primed_voxel_size(frm, vs), fspec, params,
                               mk[f].float(), gate, prm6[f], intr)
        dims_p = tuple(v.tsdf.shape[a] for a in frm.axes)
        fi.sweep_face(v, frm, rk[f], ck[f], prm3, fi.plane_table(fspec, prm3, dims_p))

    frames = fw.face_frames()
    dims_xyz = tuple(reversed(vol.tsdf.shape))
    all_on = torch.ones(fw.FACES, dtype=torch.bool, device=dev)
    geo, prm6, built = stacks(vol2cam, dims_xyz, frames, all_on)
    _sync("K2 six-face launch, every gate on")
    step_gates = fi.faces_needed(vol2cam, intr)
    geo_g, prm6_g, built_g = stacks(vol2cam, dims_xyz, frames, step_gates)
    _sync(f"K2 six-face launch, the step's gates {step_gates.int().tolist()}")
    for f, frm in enumerate(frames):
        sweep(vol, f, frm, geo, prm6, built, on)
        _sync(f"K3 face {frm.name}")
    off = [f for f in range(fw.FACES) if not bool(step_gates[f])]
    if not off:
        raise RuntimeError("no face is gated off by the step's gates")
    sweep(vol, off[0], frames[off[0]], geo_g, prm6_g, built_g, step_gates[off[0]])
    _sync(f"K3 gated-off face {frames[off[0]].name}, its stack unwritten by K2")

    for f, frm in enumerate(frames):
        D, offs, vs_p = fr.prime_geometry(frm, params, dev)
        fr.sweep_rays(vol.tsdf, frm, fr.ray_params(D @ cam2vol.t + offs, vs_p, rspec, on), rspec)
        _sync(f"K4 face {frm.name}")

    for sd in (0, 1):
        frames_sd = fw.face_frames(sd)
        L = vol.tsdf.shape[sd]
        Ll, r = L // RANKS, 1
        off0 = r * Ll
        slab = TSDFVolume(*(a.narrow(sd, off0, Ll).contiguous() for a in vol))
        v2c = fold_shard_origin(vol2cam, off0, sd, vs)
        geo_s, prm6_s, built_s = stacks(v2c, tuple(reversed(slab.tsdf.shape)), frames_sd,
                                        all_on)
        prm5 = fr.composite_params(cam2vol, params, sd)
        padded = padded_slab(vol.tsdf, sd, r, RANKS, HALO8)
        for f, frm in enumerate(frames_sd):
            sweep(slab, f, frm, geo_s, prm6_s, built_s, on)
            _sync(f"K3 {'ZY'[sd]} slab {r} face {frm.name} {frm.axes}")
            sh = ray_shard(frm, padded.shape, L, Ll, off0, sd)
            prm4 = fr.ray_params(prm5[f, 9:12], fw.primed_voxel_size(frm, vs), rspec, on)
            fr.sweep_rays(padded, frm, prm4, rspec, sh)
            _sync(f"K4 {'ZY'[sd]} slab {r} padded by {HALO8} face {frm.name} {tuple(sh)}")

    prm = fr.composite_params(cam2vol, params)
    gates = fi.faces_needed(vol2cam, intr)
    fields = [fr.sweep_and_shade(vol.tsdf, frm, prm[k, 9:12], params, rspec, gates[k])
              for k, frm in enumerate(frames)]
    fr.resample_composite([t for t, _ in fields], [n for _, n in fields], prm, gates, intr,
                          rspec)
    _sync(f"K5 six-face composite, gates {gates.int().tolist()}")


def launch_marches(tsdf, T, params, intr) -> None:
    """M1 on the whole volume and in its Z-slab form (the interior slab 1
    of RANKS, padded with the march's HALO rows, its per-ray k_start and
    t_end), and M2, from the camera pose T (world from camera)."""
    from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
    from kinfu_tpu_torch.parallel.sharded import HALO, _local_t_interval
    from kinfu_tpu_torch.volume import raycast as rc

    dev = tsdf.device
    volp = pose_from_matrix(torch.as_tensor(params.volume_pose, device=dev))
    cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32, device=dev))
    org, dirs, ts, tfar, step, inv_vs = rc.march_inputs(compose(inverse(volp), cam), intr,
                                                        params)
    vs = params.voxel_size
    dims = tuple(tsdf.shape)
    bound = rc.march_steps_bound(dims, vs, step)
    rc.march_rays(tsdf, dims, 0, org, dirs, ts, tfar, step, inv_vs, max_steps=bound)
    _sync("M1 march_rays, the whole volume")
    rc.march_hier_rays(tsdf, rc.build_occupancy(tsdf), org, dirs, ts, tfar, step, inv_vs)
    _sync("M2 march_hier")
    Zl, r = dims[0] // RANKS, 1
    padded = padded_slab(tsdf, 0, r, RANKS, HALO)
    z_lo = float(np.float32(r * Zl) * np.float32(vs[2]))
    z_hi = float(np.float32((r + 1) * Zl) * np.float32(vs[2]))
    k_lo, t_hi = _local_t_interval(org[2], dirs[..., 2], z_lo, z_hi, ts, tfar, step)
    rc.march_rays(padded, dims, r * Zl - HALO, org, dirs, ts, t_hi, step, inv_vs, k_start=k_lo,
                  max_steps=bound)
    _sync(f"M1 march_rays, Z slab {r} padded by {HALO}")


def launch_corner(params, intr, device) -> None:
    """The corner orbit through the fused step up to its first frame whose
    tracked pose gates two faces."""
    from kinfu_tpu_torch.data.synthetic import (
        corner_test_scene, make_orbit_trajectory, yaw_trajectory)
    from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
    from kinfu_tpu_torch.ops.face_integrate import faces_needed
    from kinfu_tpu_torch.pipeline.kinfu import init_state, kinfu_step

    corner = corner_test_scene()
    traj = yaw_trajectory(make_orbit_trajectory(CORNER_FRAMES, angle_step_deg=0.3))
    volp = pose_from_matrix(torch.as_tensor(params.volume_pose, device=device))
    state = init_state(params, intr, device=device)
    for k, T in enumerate(traj):
        d, c = _dev_frames([corner.render_frame(T, intr)], device)[0]
        state, out = kinfu_step(state, d, c, params, intr)
        cam = pose_from_matrix(out.pose_matrix)
        live = int((faces_needed(compose(inverse(cam), volp), intr) & out.tracking_ok).sum())
        if live >= 2:
            _sync(f"the corner orbit through frame {k}, whose step gated {live} faces")
            return
    raise RuntimeError(f"no frame of {CORNER_FRAMES} of the corner orbit gated two faces")


def launch_all(scale: str, device) -> None:
    """Every kernel form of (a) at `scale`."""
    from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
    from kinfu_tpu_torch.pipeline.kinfu import init_state, kinfu_step

    params, intr = configure(scale)
    _log(f"scale {scale}: {intr.width}x{intr.height}, {params.volume_dims[0]}^3, "
         f"{params.pyramid_height} levels")
    traj = make_orbit_trajectory(4, angle_step_deg=0.3)
    frames = _dev_frames([default_test_scene().render_frame(T, intr) for T in traj], device)
    # 3 frames of the fused orbit: their volume and model maps, and frame
    # 3, are the forms' input
    state = init_state(params, intr, device=device)
    for d, c in frames[:3]:
        state, _ = kinfu_step(state, d, c, params, intr)
    _sync("3 frames of the fused orbit")
    launch_icp(state, frames[3][0], params, intr)
    T3 = np.linalg.inv(traj[0]) @ traj[3]
    launch_faces(state.vol, frames[3], T3, params, intr)
    launch_marches(state.vol.tsdf, T3, params, intr)
    del state
    launch_corner(params, intr, device)


def launch_negative(device) -> None:
    """K5's C entry with a vertex buffer one row short of the camera grid:
    its last row of threads writes past it."""
    from kinfu_tpu_torch.ops import kernels

    F, h, w = 128, 64, 96
    t_f = [torch.full((F, F), 1.0, device=device) for _ in range(6)]
    n_f = [torch.zeros((F, F, 3), device=device) for _ in range(6)]
    prm = torch.zeros((6, 24), device=device)
    prm[0, [0, 4, 8]] = 1.0  # face 0: A = I, so it owns the view's centre rays
    gates = torch.zeros(6, dtype=torch.bool, device=device)
    gates[0] = True
    vertex = torch.empty(((h - 1) * w * 3,), device=device)  # one row short
    normal = torch.empty((h * w * 3,), device=device)
    valid = torch.empty((h * w,), dtype=torch.bool, device=device)
    kernels.launch(
        "kinfu_resample_face", kernels.ptr_array(t_f), kernels.ptr_array(n_f),
        kernels.ptr(prm), kernels.ptr(gates), kernels.ptr(vertex), kernels.ptr(normal),
        kernels.ptr(valid), 80.0, 80.0, w / 2 - 0.5, h / 2 - 0.5, float(F // 2),
        F / 2 - 0.5, h, w, F, kernels.lengths(*t_f, *n_f, prm, gates, vertex, normal, valid),
        key="resample_face")
    _log("negative: launched K5 with a vertex buffer one row short")
    torch.cuda.synchronize()
    _log("negative: no fault")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", choices=sorted(SCALES), default="main")
    ap.add_argument("--negative", action="store_true",
                    help="only the negative run: K5 with an output one row short")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sanitize: the checked kernels run on the card; CUDA is not available")
    import kinfu_tpu_torch  # noqa: F401  (full-f32 matmuls)
    from kinfu_tpu_torch.ops import kernels

    device = torch.device("cuda")
    kernels.library(checked=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if args.negative:
        launch_negative(device)
    else:
        launch_all(args.scale, device)
    _log(f"{time.perf_counter() - t0:.1f} s")
    print(LAUNCHES_TAG + json.dumps(dict(sorted(kernels.LAUNCHES.items()))), flush=True)


def run_child(scale: str = "main", negative: bool = False, timeout: float = 600.0) -> dict:
    """Run this module as a child process on the card (the checked build
    must exist: `kernels.timed_build`). Returns {rc, seconds, launches
    (None unless the run reached its end), trap (the checked build's report
    line, or None), output (stdout and stderr)}."""
    root = Path(__file__).resolve().parents[2]
    cmd = [sys.executable, "-m", "kinfu_tpu_torch.tools.sanitize"]
    cmd += ["--negative"] if negative else ["--scale", scale]
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=timeout)
    lines = res.stdout.splitlines()
    launches = next((json.loads(ln[len(LAUNCHES_TAG):]) for ln in reversed(lines)
                     if ln.startswith(LAUNCHES_TAG)), None)
    trap = next((ln for ln in lines if "kinfu checked build:" in ln), None)
    return {"rc": res.returncode, "seconds": time.perf_counter() - t0, "launches": launches,
            "trap": trap, "output": res.stdout}


if __name__ == "__main__":
    main()
