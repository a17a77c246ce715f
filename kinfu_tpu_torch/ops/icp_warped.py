"""K1: one ICP Gauss-Newton iteration fused into one kernel (port of
kinfu_tpu/ops/pallas_icp.py).

Per current pixel: transform the vertex and normal by the running
increment, project into the model view (rint), gather the model vertex d
and normal q there, gate, and accumulate the normal equations of the row
e = [s x q, q, -(q . (s - d)), 1] * mask. Returns (A [6,6], b [6],
inliers int32 scalar), all on the tensors' device, as the JAX wrapper does
(pallas_icp.py:219-229).

What it computes differs from the gather path (tracking/icp.py) in three
places that the plain version keeps: s and m = R n are written term by
term (`r0*vx + r1*vy + r2*vz + t0`); the distance and angle gates compare
squares (|s-d|^2 <= dist^2, |m x q|^2 <= sin^2); and dist^2, sin^2 are
formed in Python double and rounded to float32, as the JAX wrapper forms
its parameter block (L185-186).

The current maps may be a row shard of the image (fewer rows than the
model maps, pallas_icp.py:163-165): bounds and the gather use the model
maps' size, so two row halves give sums that add up to the whole.

`icp_normal_eqs_warped` takes the plain version for CPU tensors and
launches csrc/icp_normal_eqs.cu for CUDA tensors (one launch per
iteration: the last block to finish reduces the per-block partial sums in
a fixed order and writes A, b and the count).

`icp_solve_warped` runs a whole coarse-to-fine ICP on the card in one host
call: the same kernel in its finishing form, which also solves the
iteration's system and updates the pose in a device state block
(`tracking/icp.py::finish_iteration` is its plain version), launched once
per iteration from C.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose
from kinfu_tpu_torch.numerics import rint_index
from kinfu_tpu_torch.ops import kernels

#: threads per block and the most blocks of one launch (4 per SM of an
#: H100); each thread strides over the pixels
_THREADS = 256
_MAX_BLOCKS = 528
#: A's upper triangle (21) and b (6): the Gram terms that reach an output
_N_TERMS = 27

#: per (device, stream): the launch's scratch, (per-block partial sums
#: [_MAX_BLOCKS, 27] f32, per-block counts [_MAX_BLOCKS] i32, the int32
#: ticket of the last-block reduction). Launches on one stream run one after
#: another, so they can share it; launches on two streams cannot. The ticket
#: is zeroed once here and reset to 0 by each launch's last block.
_scratch: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, ...]] = {}

#: the finishing form's state block, f32[16]: R row-major (9), t (3), ok
#: (1.0 / 0.0), the inlier count's int32 bits, 2 spare
STATE_SIZE = 16


def _get_scratch(dev: torch.device) -> Tuple[torch.Tensor, ...]:
    """This (device, stream)'s (partial sums, partial counts, ticket, A, b,
    count); the last three receive the systems no caller asked for."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    scratch = _scratch.get(key)
    if scratch is None:
        scratch = _scratch[key] = (
            torch.empty((_MAX_BLOCKS, _N_TERMS), dtype=torch.float32, device=dev),
            torch.empty((_MAX_BLOCKS,), dtype=torch.int32, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.empty((6, 6), dtype=torch.float32, device=dev),
            torch.empty((6,), dtype=torch.float32, device=dev),
            torch.empty((), dtype=torch.int32, device=dev))
    return scratch


def _blocks(rows: int, w: int) -> int:
    return max(1, min(_MAX_BLOCKS, (rows * w + _THREADS - 1) // _THREADS))


def gates(dist_thres: float, sin_angle_thres: float) -> Tuple[float, float]:
    """(dist^2, sin^2) as float32 values, formed as pallas_icp.py:185-186
    forms them: the product in Python double, then the cast."""
    return float(np.float32(dist_thres * dist_thres)), float(
        np.float32(sin_angle_thres * sin_angle_thres))


def _project(inc: Pose, cur_vmap: torch.Tensor, cur_nmap: torch.Tensor, h: int, w: int,
             intr: Intrinsics):
    """((sx, sy, sz), lin, inb): the transformed current vertices, the
    linear index of the model pixel each projects to (clamped into the
    h x w model map) and whether that pixel is in bounds with a non-zero
    current normal, the condition for the gather."""
    R, t = inc
    r = R.reshape(9)
    vx, vy, vz = cur_vmap.unbind(-1)
    nx, ny, nz = cur_nmap.unbind(-1)
    ncur_ok = (nx != 0) | (ny != 0) | (nz != 0)

    sx = r[0] * vx + r[1] * vy + r[2] * vz + t[0]
    sy = r[3] * vx + r[4] * vy + r[5] * vz + t[1]
    sz = r[6] * vx + r[7] * vy + r[8] * vz + t[2]

    zok = sz > 0
    zs = torch.where(zok, sz, torch.ones_like(sz))
    u = rint_index(sx / zs * intr.fx + intr.cx)
    v = rint_index(sy / zs * intr.fy + intr.cy)
    inb = zok & (u >= 0) & (u < w) & (v >= 0) & (v < h) & ncur_ok
    return (sx, sy, sz), v.clamp(0, h - 1) * w + u.clamp(0, w - 1), inb


def icp_normal_eqs_warped_work(inc: Pose, cur_vmap: torch.Tensor, cur_nmap: torch.Tensor,
                               pre_vmap: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """What K1 must read of the model maps on these inputs, as a device
    count: the distinct model pixels that in-bounds current pixels gather
    (each 24 bytes of vertex and normal). chip_smoke.py turns it into K1's
    bound."""
    h, w, _ = pre_vmap.shape
    _, lin, inb = _project(inc, cur_vmap, cur_nmap, h, w, intr)
    read = torch.zeros(h * w, dtype=torch.bool, device=pre_vmap.device)
    read[lin[inb]] = True
    return read.sum()


def icp_normal_eqs_warped_plain(
    inc: Pose,
    cur_vmap: torch.Tensor,
    cur_nmap: torch.Tensor,
    pre_vmap: torch.Tensor,
    pre_nmap: torch.Tensor,
    intr: Intrinsics,
    dist_thres: float,
    sin_angle_thres: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: the kernel's per-pixel arithmetic in
    its order (pallas_icp.py:75-136); the Gram sum is one matmul."""
    h, w, _ = pre_vmap.shape
    dist2, sin2 = gates(dist_thres, sin_angle_thres)
    (sx, sy, sz), lin, inb = _project(inc, cur_vmap, cur_nmap, h, w, intr)
    r = inc[0].reshape(9)
    nx, ny, nz = cur_nmap.unbind(-1)
    mx = r[0] * nx + r[1] * ny + r[2] * nz
    my = r[3] * nx + r[4] * ny + r[5] * nz
    mz = r[6] * nx + r[7] * ny + r[8] * nz

    dx, dy, dz = pre_vmap.reshape(-1, 3)[lin].unbind(-1)
    qx, qy, qz = pre_nmap.reshape(-1, 3)[lin].unbind(-1)
    npre_ok = (qx != 0) | (qy != 0) | (qz != 0)

    ex, ey, ez = sx - dx, sy - dy, sz - dz
    d2 = ex * ex + ey * ey + ez * ez
    crx = my * qz - mz * qy
    cry = mz * qx - mx * qz
    crz = mx * qy - my * qx
    s2 = crx * crx + cry * cry + crz * crz
    mask = inb & npre_ok & (d2 <= dist2) & (s2 <= sin2)
    mf = mask.to(torch.float32)

    e = torch.stack([
        (sy * qz - sz * qy) * mf,
        (sz * qx - sx * qz) * mf,
        (sx * qy - sy * qx) * mf,
        qx * mf,
        qy * mf,
        qz * mf,
        -(qx * ex + qy * ey + qz * ez) * mf,
    ], dim=-1).reshape(-1, 7)
    G = e.T @ e
    # A symmetric from G's upper triangle, as pallas_icp.py:226 builds it
    A = torch.triu(G[:6, :6])
    return A + torch.triu(A, 1).T, G[:6, 6], mask.sum().to(torch.int32)


def icp_normal_eqs_warped(
    inc: Pose,
    cur_vmap: torch.Tensor,
    cur_nmap: torch.Tensor,
    pre_vmap: torch.Tensor,
    pre_nmap: torch.Tensor,
    intr: Intrinsics,
    dist_thres: float,
    sin_angle_thres: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: (A [6,6], b [6], inliers) of one iteration. CPU tensors take the
    plain version; CUDA tensors launch csrc/icp_normal_eqs.cu."""
    if cur_vmap.device.type == "cpu":
        return icp_normal_eqs_warped_plain(inc, cur_vmap, cur_nmap, pre_vmap, pre_nmap,
                                           intr, dist_thres, sin_angle_thres)
    kernels.library()
    R, t = inc[0].contiguous(), inc[1].contiguous()
    h, w, _ = pre_vmap.shape
    hc = cur_vmap.shape[0]
    kernels.check_cuda("icp_normal_eqs", cur_vmap, cur_nmap, pre_vmap, pre_nmap, R, t)
    for m, rows in ((cur_vmap, hc), (cur_nmap, hc), (pre_vmap, h), (pre_nmap, h)):
        kernels.check("icp_normal_eqs", m, torch.float32, (rows, w, 3))
    kernels.check("icp_normal_eqs", R, torch.float32, (3, 3))
    kernels.check("icp_normal_eqs", t, torch.float32, (3,))
    dev = cur_vmap.device
    dist2, sin2 = gates(dist_thres, sin_angle_thres)
    partial_g, partial_n, ticket = _get_scratch(dev)[:3]
    A = torch.empty((6, 6), dtype=torch.float32, device=dev)
    b = torch.empty((6,), dtype=torch.float32, device=dev)
    ninl = torch.empty((), dtype=torch.int32, device=dev)
    kernels.launch(
        "kinfu_icp_normal_eqs",
        kernels.ptr(R), kernels.ptr(t), kernels.ptr(cur_vmap), kernels.ptr(cur_nmap),
        kernels.ptr(pre_vmap), kernels.ptr(pre_nmap), kernels.ptr(partial_g),
        kernels.ptr(partial_n), kernels.ptr(ticket), kernels.ptr(A), kernels.ptr(b),
        kernels.ptr(ninl),
        float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy), dist2, sin2,
        hc, h, w, _blocks(hc, w), _THREADS,
    )
    return A, b, ninl


def state_block(pose: Pose, ok: torch.Tensor) -> torch.Tensor:
    """The finishing form's state block of a pose and a device ok flag
    (inlier count 0)."""
    dev = pose.R.device
    count = torch.zeros((1,), dtype=torch.int32, device=dev).view(torch.float32)
    return torch.cat([pose.R.reshape(9).float(), pose.t.reshape(3).float(),
                      ok.reshape(1).float(), count,
                      torch.zeros((2,), dtype=torch.float32, device=dev)])


def unpack_state(state: torch.Tensor) -> Tuple[Pose, torch.Tensor, torch.Tensor]:
    """(pose, ok, inliers) of a state block; the pose and the count are
    views of it."""
    return (Pose(state[:9].view(3, 3), state[9:12]), state[12] != 0,
            state[13:14].view(torch.int32)[0])


def icp_solve_warped(
    levels: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                           Intrinsics, int]],
    dist_thres: float,
    sin_angle_thres: float,
    start: Optional[torch.Tensor] = None,
    system: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """K1's finishing form over a whole coarse-to-fine ICP, one host call:
    `levels` lists (cur vertex, cur normal, model vertex, model normal,
    intrinsics, iterations) in the order they run (coarsest first). The
    first iteration starts from the state block `start` (default: the
    identity and ok); the result is the state block after the last
    iteration (`unpack_state`). `system`, when given, receives the last
    iteration's (A, b, inliers). CUDA tensors only: the plain version is
    `tracking/icp.py::rigid_icp_plain`."""
    kernels.library()
    dev = levels[0][0].device
    maps, intr, dims, iters = [], [], [], []
    for cv, cn, pv, pn, lintr, n in levels:
        h, w, _ = pv.shape
        kernels.check_cuda("icp_normal_eqs", cv, cn, pv, pn)
        for m, rows in ((cv, cv.shape[0]), (cn, cv.shape[0]), (pv, h), (pn, h)):
            kernels.check("icp_normal_eqs", m, torch.float32, (rows, w, 3))
        maps += [cv, cn, pv, pn]
        intr += [lintr.fx, lintr.fy, lintr.cx, lintr.cy]
        dims += [cv.shape[0], h, w]
        iters.append(int(n))
    partial_g, partial_n, ticket, A, b, ninl = _get_scratch(dev)
    if system is not None:
        A, b, ninl = system
        kernels.check_cuda("icp_normal_eqs", A, b, ninl, maps[0])
        kernels.check("icp_normal_eqs", A, torch.float32, (6, 6))
        kernels.check("icp_normal_eqs", b, torch.float32, (6,))
        kernels.check("icp_normal_eqs", ninl, torch.int32, ())
    state = torch.empty((STATE_SIZE,), dtype=torch.float32, device=dev)
    if start is not None:
        kernels.check_cuda("icp_normal_eqs", start, state)
        kernels.check("icp_normal_eqs", start, torch.float32, (STATE_SIZE,))
    dist2, sin2 = gates(dist_thres, sin_angle_thres)
    kernels.launch(
        "kinfu_icp_solve",
        len(levels), kernels.ptr_array(maps), kernels.host_array(ctypes.c_float, intr),
        kernels.host_array(ctypes.c_int, dims), kernels.host_array(ctypes.c_int, iters),
        kernels.ptr(start) if start is not None else None, kernels.ptr(state),
        kernels.ptr(partial_g), kernels.ptr(partial_n), kernels.ptr(ticket),
        kernels.ptr(A), kernels.ptr(b), kernels.ptr(ninl), dist2, sin2, _MAX_BLOCKS,
        _THREADS, key="icp_normal_eqs", count=sum(iters),
    )
    return state
