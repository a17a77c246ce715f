"""The port's sanitizer pass, the counterpart of tests/test_sanitizers.py.

Three parts:

(a) On the card: every form of the five CUDA kernels (K1-K5), of the
    raycast's shading (R1), of the march kernels (M1, M2) and of the shift
    (S1) runs in the bounds-checked
    build of csrc/ (`-DKINFU_CHECKED -lineinfo`, csrc/checked.cuh), in
    which every global load and store of a kernel traps on an index
    outside the array that the wrapper passed, and the launch then fails
    at the next synchronisation. The array lengths are the tensors' numel,
    so an overrun is caught even where it would land inside another tensor
    of PyTorch's caching allocator.

        python -m kinfu_tpu_torch.tools.sanitize --scale main|test
        python -m kinfu_tpu_torch.tools.sanitize --negative

    `--scale main` uses the main path's shapes (640x480, 512^3, a 3-level
    pyramid), `--scale test` 160x120 and 128^3 (2 levels). The forms
    (`all_forms`), each launch followed by a synchronisation: K1's
    one-iteration form at every level, its finishing form (one
    `icp_solve_warped` call) and its row-shard form on the 4 row shards of
    level 0 (120 rows at main); K2's six-face launch with every gate on and
    with the step's gates; K3 on each face, on a gated-off face whose stack
    K2 left unwritten, and on an interior Z slab and Y slab (the Y slab's
    +-x faces in the (2, 1, 0) frame); K4 on each face and on the
    halo-padded Z and Y slabs; R1 on the six faces' events with the step's
    gates (the gated-off faces all misses), and on the ranks' reduced Z-slab
    events [6, 2, F, F] as a rank passes them; K5's six-face composite; M1
    on the volume
    and in its Z-slab form, and M2; S1 in place by one axis each way, by
    three axes, by none and past the far side; all on the volume and model
    maps of 3 frames of the fused orbit and on frame 3. Then the corner
    orbit up to its first frame with two live faces. It prints each kernel's launches
    (`ops/kernels.py`'s counts) on its last line as `launches {json}`.
    `--negative` calls K5's C entry directly with a vertex buffer one row
    short, which must trap; a run that ends without a fault prints
    "negative: no fault" and exits 0.

(a') On the card, in the normal build: the stand-in for compute-sanitizer's
    racecheck (shared-memory races), initcheck (reads of uninitialised
    memory) and synccheck, which refuse the device ("Device not
    supported").

        python -m kinfu_tpu_torch.tools.sanitize --repeat 20 [--scale main]

    Each form of (a) launches N times on the same inputs; before each
    launch every output it allocates (`sentinel_outputs`) and K1's partial
    sums and counts are filled with the next of four sentinel bytes, and
    every launch must give the first launch's bits. K1's ticket cannot
    take a sentinel (each launch's last block resets it to 0 for the
    next), so it must read 0 after each launch. K3 updates its volume in
    place, and so does S1: each launch starts from the same volume. K1
    (every form) and K3 launch N times more on a second grid (K1_GRID2
    blocks at most, a K3_GRID2-block persistent grid): K3 must give the
    same bits; K1, whose block partition orders its sums, one iteration's
    counts and floats within K1_TOL of their largest entry (`k1_close`),
    and the finishing form, whose 19 iterations carry the order's rounding
    into the pose and the later counts, the rule of K1's row shards
    (`k1_finish_close`). A race that a launch's timing decides, a read of
    an output before it is written, or an output element left unwritten
    shows as other bits. The second-to-last line is
    `repeat {json}`, a record per form.

    `run_child` runs any of these as a subprocess and parses its output;
    it needs the builds made (`ops/kernels.py::timed_build` makes both).

(b) On the CPU: `IndexChecks`, a TorchDispatchMode that does what
    `checkify`'s index and division checks do for the JAX step: every
    index of an indexing, gather or scatter op must lie in [0, size), and
    an integer division must not divide by zero. PyTorch wraps a negative
    index silently (as `jnp` clamps), which is the fault class it catches.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

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


@dataclasses.dataclass
class Form:
    """One launch form of a kernel. `launch(grid)` launches it once and
    returns the tensors it writes; `grid` None is the wrapper's own grid,
    else `grid2`, the second grid size the entry point takes (K1: the most
    blocks of a launch; K3: its persistent grid)."""

    name: str
    launch: Callable
    grid2: Optional[int] = None
    #: cached buffers the launch writes besides its outputs (K1's partial
    #: sums and counts), filled with the sentinel before each launch
    scratch: tuple = ()
    #: cached buffers that must read 0 after each launch (K1's ticket,
    #: which a sentinel would corrupt: each launch's last block resets it)
    zero: tuple = ()
    #: on the second grid, `tol(first, second)` -> (ok, what it found)
    #: holds the outputs to K1's tolerance (its block partition orders its
    #: sums); None: the same bits
    tol: Optional[Callable] = None


def icp_forms(state, depth, params, intr):
    """K1: the one-iteration form at every level, the finishing form (one
    `icp_solve_warped` call; on the CPU, rigid_icp's plain loop) and the
    row-shard form on the level-0 row shards. K1's ticket must read 0
    after each launch: its last block resets it."""
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
    # the plain versions on the CPU have no grid, scratch or ticket
    grid2, scratch, zero = None, (), ()
    if dev.type == "cuda":
        partial_g, partial_n, ticket = iw._get_scratch(dev)[:3]
        grid2, scratch, zero = K1_GRID2, (partial_g, partial_n), (ticket,)

    def one(cv, cn, li, level):
        def launch(grid):
            kw = {} if grid is None else {"max_blocks": grid}
            return iw.icp_normal_eqs_warped(inc, cv, cn, mv[level], mn[level], li,
                                            p.icp_dist_threshold, sin_t, **kw)
        return launch

    for level in range(p.pyramid_height):
        yield Form(f"K1 one-iteration form, level {level} ({cvs[level].shape[0]} rows)",
                   one(cvs[level], cns[level], intr.level(level), level), grid2, scratch,
                   zero, tol=k1_close)
    levels = [(cvs[lv], cns[lv], mv[lv], mn[lv], intr.level(lv), n)
              for lv, n in p.level_iters_coarse_to_fine() if n > 0]

    def finish(grid):
        if dev.type == "cpu":
            res = ticp.rigid_icp(cvs, cns, mv, mn, intr, p)
            return (*res.pose, res.ok, res.num_inliers)
        system = (torch.empty((6, 6), dtype=torch.float32, device=dev),
                  torch.empty((6,), dtype=torch.float32, device=dev),
                  torch.empty((), dtype=torch.int32, device=dev))
        kw = {} if grid is None else {"max_blocks": grid}
        st = iw.icp_solve_warped(levels, p.icp_dist_threshold, sin_t, system=system, **kw)
        # the pose and ok, and the count; the block's 2 spare words are
        # never written
        return (st[:13], st[13:14].view(torch.int32), *system)

    yield Form(f"K1 finishing form, one icp_solve_warped call ({sum(p.icp_iters)} launches)",
               finish, grid2, scratch, zero, tol=k1_finish_close)
    for r in range(RANKS):
        mesh = Mesh(world=RANKS, rank=r, device=dev, backend="gloo")
        cv, cn = row_shard(cvs[0], mesh), row_shard(cns[0], mesh)
        yield Form(f"K1 row-shard form, shard {r} of level 0 ({cv.shape[0]} rows)",
                   one(cv, cn, intr, 0), grid2, scratch, zero, tol=k1_close)


def face_forms(vol, frame, T, params, intr):
    """K2 with every gate on and with the step's gates (the outputs of the
    gated faces); K3 on each face (every gate on), on a gated-off face of
    the step's gates, and on an interior Z and Y slab; K4 on each face and
    on the halo-padded Z and Y slabs; R1 on the six faces' events of the
    step's gates, and on the Z slabs' reduced events [6, 2, F, F] (the
    minimum of the ranks' K4 events, passed as views); K5's six-face
    composite. K3 updates its volume in place: each of its launches starts
    from the volume it was given."""
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
    grid2 = K3_GRID2 if dev.type == "cuda" else None

    def face_prm(v2c, dims_xyz, frames, gates):
        geo = [fw.face_geometry(v2c, f, dims_xyz, vs) for f in frames]
        return geo, torch.stack([fw.face_params(A, intr, gates[k], fspec)
                                 for k, (A, _) in enumerate(geo)])

    def k2(prm6, faces):
        def launch(grid):
            rk, ck, r_max = fw.build_faces(depth_m, col_packed, prm6, fspec)
            return rk[faces], ck[faces], r_max
        return launch

    def k3(v, f, frm, geo, prm6, built, gate):
        rk, ck, mk = built
        prm3 = fi.sweep_params(geo[f][1], fw.primed_voxel_size(frm, vs), fspec, params,
                               mk[f].float(), gate, prm6[f], intr)
        table = fi.plane_table(fspec, prm3, tuple(v.tsdf.shape[a] for a in frm.axes))
        start = tuple(a.clone() for a in v)

        def launch(grid):
            for a, s in zip(v, start):
                a.copy_(s)
            fi.sweep_face(v, frm, rk[f], ck[f], prm3, table, blocks=grid or 0)
            return tuple(v)
        return launch

    frames = fw.face_frames()
    dims_xyz = tuple(reversed(vol.tsdf.shape))
    every = list(range(fw.FACES))
    all_on = torch.ones(fw.FACES, dtype=torch.bool, device=dev)
    geo, prm6 = face_prm(vol2cam, dims_xyz, frames, all_on)
    yield Form("K2 six-face launch, every gate on", k2(prm6, every))
    built = fw.build_faces(depth_m, col_packed, prm6, fspec)
    step_gates = fi.faces_needed(vol2cam, intr)
    gated = [f for f, g in enumerate(step_gates.tolist()) if g]
    off = [f for f in every if f not in gated]
    if not off:
        raise RuntimeError("no face is gated off by the step's gates")
    geo_g, prm6_g = face_prm(vol2cam, dims_xyz, frames, step_gates)
    yield Form(f"K2 six-face launch, the step's gates {step_gates.int().tolist()}",
               k2(prm6_g, gated))
    built_g = fw.build_faces(depth_m, col_packed, prm6_g, fspec)
    for f, frm in enumerate(frames):
        yield Form(f"K3 face {frm.name}", k3(vol, f, frm, geo, prm6, built, on), grid2)
    yield Form(f"K3 gated-off face {frames[off[0]].name}, its stack unwritten by K2",
               k3(vol, off[0], frames[off[0]], geo_g, prm6_g, built_g, step_gates[off[0]]),
               grid2)

    for f, frm in enumerate(frames):
        D, offs, vs_p = fr.prime_geometry(frm, params, dev)
        prm4 = fr.ray_params(D @ cam2vol.t + offs, vs_p, rspec, on)
        yield Form(f"K4 face {frm.name}",
                   lambda grid, frm=frm, prm4=prm4: fr.sweep_rays(vol.tsdf, frm, prm4, rspec))

    for sd in (0, 1):
        frames_sd = fw.face_frames(sd)
        L = vol.tsdf.shape[sd]
        Ll, r = L // RANKS, 1
        off0 = r * Ll
        slab = TSDFVolume(*(a.narrow(sd, off0, Ll).contiguous() for a in vol))
        v2c = fold_shard_origin(vol2cam, off0, sd, vs)
        geo_s, prm6_s = face_prm(v2c, tuple(reversed(slab.tsdf.shape)), frames_sd, all_on)
        built_s = fw.build_faces(depth_m, col_packed, prm6_s, fspec)
        prm5 = fr.composite_params(cam2vol, params, sd)
        padded = padded_slab(vol.tsdf, sd, r, RANKS, HALO8)
        for f, frm in enumerate(frames_sd):
            yield Form(f"K3 {'ZY'[sd]} slab {r} face {frm.name} {frm.axes}",
                       k3(slab, f, frm, geo_s, prm6_s, built_s, on), grid2)
            sh = ray_shard(frm, padded.shape, L, Ll, off0, sd)
            prm4 = fr.ray_params(prm5[f, 9:12], fw.primed_voxel_size(frm, vs), rspec, on)
            yield Form(f"K4 {'ZY'[sd]} slab {r} padded by {HALO8} face {frm.name} {tuple(sh)}",
                       lambda grid, frm=frm, prm4=prm4, sh=sh:
                       fr.sweep_rays(padded, frm, prm4, rspec, sh))

    # the minimum of the Z slabs' K4 events [6, 2, F, F], as `pmin` gives a rank
    prm5, L = fr.composite_params(cam2vol, params, 0), vol.tsdf.shape[0]
    reduced = None
    for r in range(RANKS):
        pad = padded_slab(vol.tsdf, 0, r, RANKS, HALO8)
        ev = torch.stack([torch.stack(fr.sweep_rays(
            pad, frm, fr.ray_params(prm5[f, 9:12], fw.primed_voxel_size(frm, vs), rspec, on),
            rspec, ray_shard(frm, pad.shape, L, L // RANKS, r * (L // RANKS), 0)))
            for f, frm in enumerate(fw.face_frames(0))])
        reduced = ev if reduced is None else torch.minimum(reduced, ev)
    del pad, ev

    prm = fr.composite_params(cam2vol, params)
    hits, backs = fr.sweep_faces(vol.tsdf, prm, params, rspec, step_gates)
    yield Form(f"R1 six-face shading, gates {step_gates.int().tolist()}",
               lambda grid: fr.face_fields(hits, backs, prm, rspec))
    yield Form(f"R1 six-face shading of the Z slabs' reduced events {list(reduced.shape)}",
               lambda grid: fr.face_fields([e[0] for e in reduced], [e[1] for e in reduced],
                                           prm5, rspec))
    t_f, n_f, _ = fr.face_fields(hits, backs, prm, rspec)
    yield Form(f"K5 six-face composite, gates {step_gates.int().tolist()}",
               lambda grid: fr.resample_composite(t_f.unbind(0), n_f.unbind(0), prm, step_gates,
                                                  intr, rspec))


def march_forms(tsdf, T, params, intr):
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
    yield Form("M1 march_rays, the whole volume",
               lambda grid: rc.march_rays(tsdf, dims, 0, org, dirs, ts, tfar, step, inv_vs,
                                          max_steps=bound))
    occ = rc.build_occupancy(tsdf)
    yield Form("M2 march_hier", lambda grid: rc.march_hier_rays(tsdf, occ, org, dirs, ts, tfar,
                                                                step, inv_vs))
    Zl, r = dims[0] // RANKS, 1
    padded = padded_slab(tsdf, 0, r, RANKS, HALO)
    z_lo = float(np.float32(r * Zl) * np.float32(vs[2]))
    z_hi = float(np.float32((r + 1) * Zl) * np.float32(vs[2]))
    k_lo, t_hi = _local_t_interval(org[2], dirs[..., 2], z_lo, z_hi, ts, tfar, step)
    yield Form(f"M1 march_rays, Z slab {r} padded by {HALO}",
               lambda grid: rc.march_rays(padded, dims, r * Zl - HALO, org, dirs, ts, t_hi,
                                          step, inv_vs, k_start=k_lo, max_steps=bound))


#: (sx, sy, sz) of S1's forms: each axis one way, all three, none, a wipe
SHIFT_FORMS = ((0, 0, 2), (0, -3, 0), (1, 0, 0), (2, -3, 1), (0, 0, 0), (0, 600, 0))


def shift_forms(vol):
    """S1 (`volume/stream.py::shift_volume_`) by each of SHIFT_FORMS, in
    place: each launch starts from the volume it was given."""
    from kinfu_tpu_torch.volume.stream import shift_volume_

    start = tuple(a.clone() for a in vol)
    for s in SHIFT_FORMS:
        shift = torch.tensor(s, dtype=torch.int32, device=vol.tsdf.device)

        def launch(grid, shift=shift):
            for a, b in zip(vol, start):
                a.copy_(b)
            return tuple(shift_volume_(vol, shift))
        yield Form(f"S1 shift_volume_ by {s}", launch)


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


def orbit_state(scale: str, device):
    """(params, intr, state, frame 3, T3) of `scale`: the state after 3
    frames of the fused orbit, whose volume and model maps, with frame 3
    and its pose T3, are the forms' input."""
    from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
    from kinfu_tpu_torch.pipeline.kinfu import init_state, kinfu_step

    params, intr = configure(scale)
    _log(f"scale {scale}: {intr.width}x{intr.height}, {params.volume_dims[0]}^3, "
         f"{params.pyramid_height} levels")
    traj = make_orbit_trajectory(4, angle_step_deg=0.3)
    frames = _dev_frames([default_test_scene().render_frame(T, intr) for T in traj], device)
    state = init_state(params, intr, device=device)
    for d, c in frames[:3]:
        state, _ = kinfu_step(state, d, c, params, intr)
    _sync("3 frames of the fused orbit")
    return params, intr, state, frames[3], np.linalg.inv(traj[0]) @ traj[3]


def all_forms(state, frame, T, params, intr):
    """Every launch form of K1-K5, R1, M1, M2 and S1 on the state's volume and
    model maps and on `frame` at pose T."""
    yield from icp_forms(state, frame[0], params, intr)
    yield from face_forms(state.vol, frame, T, params, intr)
    yield from march_forms(state.vol.tsdf, T, params, intr)
    yield from shift_forms(state.vol)


def launch_all(scale: str, device) -> None:
    """Every kernel form of (a) at `scale`, each launch followed by a
    synchronisation; then the corner orbit."""
    params, intr, state, frame, T3 = orbit_state(scale, device)
    for form in all_forms(state, frame, T3, params, intr):
        form.launch(None)
        _sync(form.name)
    del state, form
    launch_corner(params, intr, device)


# ---- (a') repeated launches with sentinel-filled outputs ----------------------

#: the bytes that fill every output and scratch buffer before a launch, in
#: turn: float NaN and int -1; two mixed patterns; a float near its maximum
SENTINELS = (0xFF, 0xA5, 0x5A, 0x7F)
#: the second grid sizes: K1's most blocks a launch (of 528) and K3's
#: persistent grid (the card's SMs hold 132 x its blocks a SM)
K1_GRID2 = 131
K3_GRID2 = 61
#: K1 on another grid, one iteration: the same counts, floats within this
#: share of their largest entry (chip_smoke.py phase 3's rule for K1)
K1_TOL = 1e-4
#: K1's finishing form on another grid: each of its iterations sums in
#: another order, and the pose carries the gap into the next iteration's
#: gates and counts, so it takes the rule of K1's row shards, whose sums
#: are ordered otherwise too (chip_smoke.py phase 4d: SHARD_POSE_TOL and
#: SHARD_INLIER_SHARE): the pose within this, the ok flag equal and
K1_FINISH_POSE_TOL = 1e-6
#: the inlier counts within this share
K1_FINISH_INLIER_SHARE = 1e-4
#: the last line of a repeat run
REPEAT_TAG = "repeat "


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bytes of `t`: a view of them where `t` is contiguous."""
    return t.contiguous().reshape(-1).view(torch.uint8)


@contextlib.contextmanager
def sentinel_outputs(byte: int):
    """Within it, `torch.empty` and `torch.empty_like`, with which the
    kernels' wrappers allocate their outputs, fill what they allocate with
    `byte`: an output element a launch leaves unwritten, or reads before
    it writes it, then shows in its bits."""
    empty, empty_like = torch.empty, torch.empty_like

    def fill(t):
        _bits(t).fill_(byte)
        return t

    torch.empty = lambda *a, **k: fill(empty(*a, **k))
    torch.empty_like = lambda *a, **k: fill(empty_like(*a, **k))
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| as a share of a's largest entry."""
    return float((a - b).abs().max()) / (float(a.abs().max()) or 1.0)


def k1_close(first, second):
    """K1's one-iteration outputs (A, b, inliers) on two grids: the same
    count, A and b within K1_TOL of their largest entry."""
    A0, b0, n0 = first
    A1, b1, n1 = second
    gap = max(_rel_gap(A0, A1), _rel_gap(b0, b1))
    return (torch.equal(n0, n1) and gap <= K1_TOL,
            f"inliers {int(n0)} and {int(n1)}, A and b within {gap:.3g} of their largest entry")


def k1_finish_close(first, second):
    """K1's finishing outputs (the state block's pose and ok, its count,
    and the last iteration's A, b and inliers) on two grids: the pose
    within K1_FINISH_POSE_TOL, the same ok, the counts within
    K1_FINISH_INLIER_SHARE (the last system's A and b are printed)."""
    s0, c0, A0, b0, n0 = first
    s1, c1, A1, b1, n1 = second
    pose = float((s0[:12] - s1[:12]).abs().max())
    share = max(abs(int(c0) - int(c1)) / max(int(c0), 1), abs(int(n0) - int(n1)) / max(int(n0), 1))
    ab = max(_rel_gap(A0, A1), _rel_gap(b0, b1))
    ok = pose <= K1_FINISH_POSE_TOL and torch.equal(s0[12], s1[12]) and share <= \
        K1_FINISH_INLIER_SHARE
    return ok, (f"pose within {pose:.3g}, ok {float(s0[12])} and {float(s1[12])}, inliers "
                f"{int(c0)} and {int(c1)} (share {share:.3g}), the last A and b within "
                f"{ab:.3g} of their largest entry")


def repeat(form: Form, n: int) -> dict:
    """Launch `form` n times on the same inputs, each time after filling
    its outputs and scratch with the next sentinel, and count the launches
    whose output bits differ from the first's; then as many on its second
    grid, whose first launch must give the same bits (K1: `form.tol`).
    Also counts the launches after which a buffer of `form.zero` is not
    0."""
    res = {"launches": 0, "differ": 0, "not_zero": 0}
    first = None
    for grid in (None,) if form.grid2 is None else (None, form.grid2):
        ref, differ = None, 0
        for i in range(n):
            byte = SENTINELS[i % len(SENTINELS)]
            for t in form.scratch:
                _bits(t).fill_(byte)
            with sentinel_outputs(byte):
                outs = form.launch(grid)
            res["launches"] += 1
            res["not_zero"] += sum(bool(t.any()) for t in form.zero)
            if ref is None:
                ref = [o.clone() for o in outs]
            elif not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(ref, outs)):
                differ += 1
        if grid is None:
            res["differ"], first = differ, ref
            continue
        res["grid2"], res["differ_grid2"] = grid, differ
        if form.tol is None:
            same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(first, ref))
            res["grid2_ok"], res["grid2_gap"] = same, "the same bits" if same else "other bits"
        else:
            res["grid2_ok"], res["grid2_gap"] = form.tol(first, ref)
    res["ok"] = (res["differ"] == 0 and res["not_zero"] == 0 and res.get("differ_grid2", 0) == 0
                 and res.get("grid2_ok", True))
    return res


def repeat_all(scale: str, device, n: int) -> dict:
    """`repeat` over every kernel form of (a) at `scale`; returns
    {form: its record}."""
    params, intr, state, frame, T3 = orbit_state(scale, device)
    out = {}
    for form in all_forms(state, frame, T3, params, intr):
        r = out[form.name] = repeat(form, n)
        grid2 = ""
        if "grid2" in r:
            grid2 = (f"; grid {r['grid2']}: {r['differ_grid2']} differ, against the "
                     f"wrapper's grid {r['grid2_gap']}")
        ticket = f"; the ticket not 0 after {r['not_zero']}" if form.zero else ""
        _log(f"  {form.name}: {r['launches']} launches; {r['differ']} of the {n - 1} after the "
             f"first differ{grid2}{ticket}: {'ok' if r['ok'] else 'FAULT'}")
    return out


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
    ap.add_argument("--repeat", type=int, default=0, metavar="N",
                    help="instead, launch every form N times with sentinel-filled outputs "
                         "in the normal build, and on a second grid where it takes one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sanitize: the checked kernels run on the card; CUDA is not available")
    import kinfu_tpu_torch  # noqa: F401  (full-f32 matmuls)
    from kinfu_tpu_torch.ops import kernels

    device = torch.device("cuda")
    kernels.library(checked=not args.repeat)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if args.negative:
        launch_negative(device)
    elif args.repeat:
        records = repeat_all(args.scale, device, args.repeat)
    else:
        launch_all(args.scale, device)
    _log(f"{time.perf_counter() - t0:.1f} s")
    if args.repeat:
        print(REPEAT_TAG + json.dumps(records), flush=True)
    print(LAUNCHES_TAG + json.dumps(dict(sorted(kernels.LAUNCHES.items()))), flush=True)


def run_child(scale: str = "main", negative: bool = False, timeout: float = 600.0,
              repeat: int = 0) -> dict:
    """Run this module as a child process on the card (the checked build
    must exist: `kernels.timed_build`; with `repeat`, the normal one).
    Returns {rc, seconds, launches (None unless the run reached its end),
    repeat (with `repeat`: {form: record}, else None), trap (the checked
    build's report line, or None), output (stdout and stderr)}."""
    root = Path(__file__).resolve().parents[2]
    cmd = [sys.executable, "-m", "kinfu_tpu_torch.tools.sanitize"]
    cmd += ["--negative"] if negative else ["--scale", scale]
    cmd += ["--repeat", str(repeat)] if repeat else []
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=timeout)
    lines = res.stdout.splitlines()

    def tagged(tag):
        return next((json.loads(ln[len(tag):]) for ln in reversed(lines)
                     if ln.startswith(tag)), None)

    trap = next((ln for ln in lines if "kinfu checked build:" in ln), None)
    return {"rc": res.returncode, "seconds": time.perf_counter() - t0,
            "launches": tagged(LAUNCHES_TAG), "repeat": tagged(REPEAT_TAG), "trap": trap,
            "output": res.stdout}


if __name__ == "__main__":
    main()
