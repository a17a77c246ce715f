"""Plain KinectFusion, the benchmark's reference: one frame's measurement
pyramid, point-to-plane ICP, TSDF fusion, raycast and the streaming grid's
shift, written from the published method (Newcombe et al., ISMAR 2011; PCL
gpu/kinfu and its large-scale variant) in plain PyTorch.

It imports nothing of the system under test and takes no table, weight or
buffer that the system made: it is given the frame's raw depth and colour,
the configuration's numbers, and the state the system is judged from.

Every float operation runs in the compute type `dt` that the caller gives:
float32, the precision the configurations state, or a lower one for the
control (`compare.py`). The stored volume stays int16 / int16 / packed
int32, as the configurations store it. The 6x6 solve runs in float32
whatever `dt` is (torch has no bfloat16 solver); its inputs are rounded
to `dt` first.

Semantics (what is held, not how the system computes it):
  - pyramid: 5x5 Gaussian pyrDown of raw depth, a 5x5 bilateral filter per
    level (OpenCV weights), mm -> m, a far clip, back-projection, normals
    from central differences, zero across depth discontinuities;
  - ICP: projective association at the rounded pixel, distance and angle
    gates, point-to-plane normal equations, coarse to fine, each solve's
    increment Rodrigues(x[:3]) with translation x[3:] applied on the right
    of the running estimate (icp_registration.cpp:41 of the reference);
  - fusion: every voxel corner of the grid projected to its nearest pixel;
    the signed distance along the pixel's ray, range(u, v) - ||voxel -
    camera||, truncated; a running average of weight capped at the maximum;
    colour mixed within half the truncation;
  - raycast: unit-voxel steps along each pixel's ray from where it enters
    the volume's box, nearest-voxel samples, the first +/- crossing refined
    linearly, a -/+ crossing ending the ray, normals from the trilinear
    gradient; maps in the camera frame;
  - streaming: the grid moves by whole voxels so that a point half the
    volume's depth in front of the camera stays within the central box;
    voxels moved out are dropped, voxels moved in are empty.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

SHORTMAX = 32767.0


class Camera(NamedTuple):
    """Pinhole intrinsics of one pyramid level."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    def level(self, lv: int) -> "Camera":
        s = 0.5 ** lv
        return Camera(self.width >> lv, self.height >> lv, self.fx * s, self.fy * s,
                      (self.cx + 0.5) * s - 0.5, (self.cy + 0.5) * s - 0.5)


class Grid(NamedTuple):
    """The volume's shape and placement: dims (X, Y, Z), metres per voxel,
    truncation distance (m), largest weight."""

    dims: Tuple[int, int, int]
    voxel: Tuple[float, float, float]
    trunc: float
    max_weight: int


# ---------------------------------------------------------------- pyramid

_PYR = (1.0, 4.0, 6.0, 4.0, 1.0)


def _pad(img: torch.Tensor, r: int) -> torch.Tensor:
    return F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]


def pyr_down(d: torch.Tensor) -> torch.Tensor:
    h, w = d.shape
    p = _pad(d, 2)
    acc = torch.zeros_like(d)
    for i, wy in enumerate(_PYR):
        for j, wx in enumerate(_PYR):
            acc = acc + (wy * wx / 256.0) * p[i:i + h, j:j + w]
    return acc[::2, ::2]


def bilateral(d: torch.Tensor, k: int, sigma_color: float, sigma_space: float) -> torch.Tensor:
    h, w = d.shape
    r = k // 2
    p = _pad(d, r)
    num = torch.zeros_like(d)
    den = torch.zeros_like(d)
    for i in range(k):
        for j in range(k):
            nb = p[i:i + h, j:j + w]
            ws = math.exp(-0.5 * ((i - r) ** 2 + (j - r) ** 2) / sigma_space ** 2)
            wgt = ws * torch.exp(-0.5 * (nb - d) ** 2 / sigma_color ** 2)
            num = num + wgt * nb
            den = den + wgt
    return num / torch.clamp(den, min=1e-20)


def _pixel_grid(cam: Camera, dt, device):
    v = torch.arange(cam.height, dtype=dt, device=device)[:, None]
    u = torch.arange(cam.width, dtype=dt, device=device)[None, :]
    return u, v


def vertex_map(d: torch.Tensor, cam: Camera) -> torch.Tensor:
    u, v = _pixel_grid(cam, d.dtype, d.device)
    return torch.stack([d * (u - cam.cx) / cam.fx, d * (v - cam.cy) / cam.fy, d], dim=-1)


def normal_map(vm: torch.Tensor, disc: float) -> torch.Tensor:
    h, w, _ = vm.shape
    pad = F.pad(vm.permute(2, 0, 1)[None], (1, 1, 1, 1))[0].permute(1, 2, 0)
    left, right = pad[1:-1, :-2], pad[1:-1, 2:]
    up, down = pad[:-2, 1:-1], pad[2:, 1:-1]
    n = torch.linalg.cross(left - right, up - down, dim=-1)
    n = torch.where(n[..., 2:3] > 0, -n, n)
    norm = torch.linalg.vector_norm(n.float(), dim=-1).to(n.dtype)
    z = vm[..., 2]
    ok = norm > 0
    for nb in (left, right, up, down):
        ok = ok & (nb[..., 2] != 0) & ((nb[..., 2] - z).abs() < disc * z)
    yy = torch.arange(h, device=vm.device)[:, None]
    xx = torch.arange(w, device=vm.device)[None, :]
    ok = ok & (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1)
    n = n / torch.clamp(norm, min=1e-30)[..., None]
    return torch.where(ok[..., None], n, torch.zeros_like(n))


def measurement(depth_mm: torch.Tensor, cam: Camera, cfg: dict, dt) -> tuple:
    """(depth [m], vertex, normal) per level, finest first, from raw depth
    in millimetres."""
    raw = [depth_mm.to(dt)]
    for _ in range(1, cfg["pyramid_height"]):
        raw.append(pyr_down(raw[-1]))
    ds, vs, ns = [], [], []
    for lv, r in enumerate(raw):
        d = bilateral(r, cfg["bfilter_kernel_size"], cfg["bfilter_color_sigma"],
                      cfg["bfilter_spatial_sigma"]) * cfg["depth_scale"]
        d = torch.where(d <= cfg["dfilter_dist"], d, torch.zeros_like(d))
        vm = vertex_map(d, cam.level(lv))
        ds.append(d)
        vs.append(vm)
        ns.append(normal_map(vm, cfg["normal_disc_threshold"] * 2.0 ** lv))
    return ds, vs, ns


def model_pyramid(vm: torch.Tensor, nm: torch.Tensor, levels: int):
    """Coarser model maps: the mean of each 2x2 block's valid entries,
    normals renormalised, an empty block zero."""
    vms, nms = [vm], [nm]
    for _ in range(1, levels):
        v, n = vms[-1], nms[-1]
        h, w, _ = v.shape
        vb = v.reshape(h // 2, 2, w // 2, 2, 3)
        nb = n.reshape(h // 2, 2, w // 2, 2, 3)
        vv = vb[..., 2:3] != 0
        nv = (nb != 0).any(-1, keepdim=True)
        vc, nc = vv.sum((1, 3)), nv.sum((1, 3))
        v2 = (vb * vv).sum((1, 3)) / vc.clamp(min=1) * (vc > 0)
        n2 = (nb * nv).sum((1, 3)) / nc.clamp(min=1) * (nc > 0)
        ln = torch.linalg.vector_norm(n2.float(), dim=-1, keepdim=True).to(n2.dtype)
        vms.append(v2)
        nms.append(n2 / ln.clamp(min=1e-30) * (ln > 1e-20))
    return vms, nms


# ---------------------------------------------------------------- poses

def rodrigues(w: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.vector_norm(w.float()).to(w.dtype)
    K = torch.zeros(3, 3, dtype=w.dtype, device=w.device)
    K[0, 1], K[0, 2], K[1, 2] = -w[2], w[1], -w[0]
    K = K - K.T
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(th) < 1e-6:
        return eye + K + 0.5 * (K @ K)
    return eye + torch.sin(th) / th * K + (1.0 - torch.cos(th)) / (th * th) * (K @ K)


def icp(cur_v: Sequence[torch.Tensor], cur_n: Sequence[torch.Tensor],
        pre_v: Sequence[torch.Tensor], pre_n: Sequence[torch.Tensor], cam: Camera,
        cfg: dict, dt) -> Tuple[torch.Tensor, bool, int]:
    """(previous-from-current camera increment 4x4 in `dt`, solvable,
    inliers of the last iteration)."""
    dev = cur_v[0].device
    R = torch.eye(3, dtype=dt, device=dev)
    t = torch.zeros(3, dtype=dt, device=dev)
    dist2 = cfg["icp_dist_threshold"] ** 2
    sin2 = math.sin(math.radians(cfg["icp_angle_threshold"])) ** 2
    ok, inliers = True, 0
    iters = cfg["icp_iters"]
    for lv in range(len(iters) - 1, -1, -1):
        c = cam.level(lv)
        cv, cn = cur_v[lv].to(dt), cur_n[lv].to(dt)
        pv, pn = pre_v[lv].to(dt), pre_n[lv].to(dt)
        h, w, _ = pv.shape
        for _ in range(iters[lv]):
            s = cv @ R.T + t
            m = cn @ R.T
            z = s[..., 2]
            zs = torch.where(z > 0, z, torch.ones_like(z))
            u = torch.round(s[..., 0] / zs * c.fx + c.cx).clamp(-1e7, 1e7).long()
            v = torch.round(s[..., 1] / zs * c.fy + c.cy).clamp(-1e7, 1e7).long()
            inb = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
            lin = (v * w + u).clamp(0, h * w - 1)
            d = pv.reshape(-1, 3)[lin]
            q = pn.reshape(-1, 3)[lin]
            e = d - s
            sin_q = torch.linalg.cross(m, q, dim=-1)
            mask = (inb & (cn != 0).any(-1) & (q != 0).any(-1)
                    & ((e * e).sum(-1) <= dist2) & ((sin_q * sin_q).sum(-1) <= sin2))
            rows = torch.cat([torch.linalg.cross(s, q, dim=-1), q, (q * e).sum(-1, keepdim=True)],
                             dim=-1)
            rows = torch.where(mask[..., None], rows, torch.zeros_like(rows)).reshape(-1, 7)
            G = (rows.T @ rows).float()
            A, b = G[:6, :6], G[:6, 6]
            det = torch.linalg.det(A)
            if not bool(torch.isfinite(det)) or abs(float(det)) < 1e-15:
                ok = False
                break
            x = torch.linalg.solve(A, b).to(dt)
            dR = rodrigues(x[:3])
            R, t = R @ dR, R @ x[3:] + t
            inliers = int(mask.sum())
        if not ok:
            break
    T = torch.eye(4, dtype=dt, device=dev)
    T[:3, :3], T[:3, 3] = R, t
    return T, ok, inliers


# ---------------------------------------------------------------- fusion

def unpack(c: torch.Tensor, dt) -> torch.Tensor:
    return torch.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).to(dt)


def pack(rgb: torch.Tensor) -> torch.Tensor:
    rgb = rgb.to(torch.int32)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]


def _chunk_voxels(grid: Grid, z0: int, nz: int, dt, device, lo=(0, 0, 0), shape=None):
    """Volume-frame corners of planes z0..z0+nz of an array [Z, Y, X]
    (`shape`, the whole grid by default) whose first voxel is the grid's
    voxel `lo` (x, y, z)."""
    X, Y = grid.dims[:2] if shape is None else (shape[2], shape[1])
    x0, y0, zl = lo
    vx, vy, vz = grid.voxel
    z = (torch.arange(zl + z0, zl + z0 + nz, dtype=dt, device=device) * vz)[:, None, None]
    y = (torch.arange(y0, y0 + Y, dtype=dt, device=device) * vy)[None, :, None]
    x = (torch.arange(x0, x0 + X, dtype=dt, device=device) * vx)[None, None, :]
    return x, y, z


def _project_chunk(x, y, z, vol2cam: torch.Tensor, cam: Camera):
    """Camera-frame coordinates, nearest pixel and its in-frame test of the
    chunk's voxel corners."""
    R, t = vol2cam[:3, :3], vol2cam[:3, 3]
    px = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    py = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    pz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    front = pz > 0
    zs = torch.where(front, pz, torch.ones_like(pz))
    u = torch.round(px / zs * cam.fx + cam.cx).clamp(-1e7, 1e7).long()
    v = torch.round(py / zs * cam.fy + cam.cy).clamp(-1e7, 1e7).long()
    inb = front & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    return px, py, pz, u, v, inb


def _observed(depth_m, u, v, inb, cam: Camera):
    """(range along the pixel's ray [m], valid) at each voxel's pixel."""
    h, w = depth_m.shape
    lin = (v * w + u).clamp(0, h * w - 1)
    d = depth_m.reshape(-1)[lin]
    lx = (u.to(d.dtype) - cam.cx) / cam.fx
    ly = (v.to(d.dtype) - cam.cy) / cam.fy
    return d * torch.sqrt(lx * lx + ly * ly + 1.0), inb & (d > 0), lin


def fuse(tsdf, weight, color, depth_m, rgb, vol2cam, cam: Camera, grid: Grid, dt,
         z_chunk: int = 16, upd: torch.Tensor | None = None, lo=(0, 0, 0)) -> None:
    """Fuse one frame into the int16 / int16 / packed int32 arrays [Z, Y, X]
    in place. depth_m [H, W] metres (the filtered level 0), rgb [H, W, 3]
    uint8, vol2cam 4x4 (volume frame to camera frame). `upd`, a bool
    [Z, Y, X], receives the voxels the frame updates. The arrays are the
    whole grid, or a box of it whose first voxel is the grid's voxel `lo`
    (x, y, z): each voxel is fused as the whole grid's voxel."""
    Z = tsdf.shape[0]
    dev = tsdf.device
    vol2cam = vol2cam.to(dt)
    depth_m = depth_m.to(dt)
    col_flat = rgb.reshape(-1, 3)
    trunc = grid.trunc
    for z0 in range(0, Z, z_chunk):
        nz = min(z_chunk, Z - z0)
        x, y, z = _chunk_voxels(grid, z0, nz, dt, dev, lo, tsdf.shape)
        px, py, pz, u, v, inb = _project_chunk(x, y, z, vol2cam, cam)
        rng, valid, lin = _observed(depth_m, u, v, inb, cam)
        sdf = rng - torch.sqrt(px * px + py * py + pz * pz)
        upd_c = valid & (sdf >= -trunc)
        obs = torch.clamp(sdf / trunc, max=1.0)
        sl = slice(z0, z0 + nz)
        if upd is not None:
            upd[sl] = upd_c
        t_old = tsdf[sl].to(dt) / SHORTMAX
        w_old = weight[sl].to(dt)
        w_new = torch.clamp(w_old + 1.0, max=float(grid.max_weight))
        t_new = (t_old * w_old + obs) / (w_old + 1.0)
        t_fix = torch.trunc(torch.clamp(t_new * SHORTMAX, -SHORTMAX, SHORTMAX).float())
        cupd = upd_c & (sdf.abs() <= 0.5 * trunc)
        mixed = (w_new[..., None] * unpack(color[sl], dt) + col_flat[lin].to(dt)) / (
            w_new[..., None] + 1.0)
        mixed = torch.clamp(mixed.float(), 0.0, 255.0).to(torch.uint8)
        tsdf[sl] = torch.where(upd_c, t_fix.to(torch.int16), tsdf[sl])
        weight[sl] = torch.where(upd_c, w_new.to(torch.int16), weight[sl])
        color[sl] = torch.where(cupd, pack(mixed), color[sl])


def fuse_counts(depth_m, vol2cam, cam: Camera, grid: Grid, z_chunk: int = 16, lo=(0, 0, 0),
                shape=None) -> Tuple[int, int]:
    """(voxels one frame updates, voxels whose colour it mixes): what
    `fuse` writes, from the frame and its pose alone (float32), in the
    whole grid or in its box of `shape` [Z, Y, X] from voxel `lo`."""
    dt = torch.float32
    dev = depth_m.device
    vol2cam = vol2cam.to(dt)
    n_upd = torch.zeros((), dtype=torch.int64, device=dev)
    n_col = torch.zeros((), dtype=torch.int64, device=dev)
    Z = grid.dims[2] if shape is None else shape[0]
    for z0 in range(0, Z, z_chunk):
        nz = min(z_chunk, Z - z0)
        x, y, z = _chunk_voxels(grid, z0, nz, dt, dev, lo, shape)
        px, py, pz, u, v, inb = _project_chunk(x, y, z, vol2cam, cam)
        rng, valid, _ = _observed(depth_m.to(dt), u, v, inb, cam)
        sdf = rng - torch.sqrt(px * px + py * py + pz * pz)
        upd = valid & (sdf >= -grid.trunc)
        n_upd += upd.sum()
        n_col += (upd & (sdf.abs() <= 0.5 * grid.trunc)).sum()
    return int(n_upd), int(n_col)


# ---------------------------------------------------------------- raycast

def camera_rays(cam2vol: torch.Tensor, cam: Camera, dt):
    """(origin [3], unit directions [H, W, 3]) in the volume frame."""
    u, v = _pixel_grid(cam, dt, cam2vol.device)
    d = torch.stack([((u - cam.cx) / cam.fx).expand(cam.height, cam.width),
                     ((v - cam.cy) / cam.fy).expand(cam.height, cam.width),
                     torch.ones(cam.height, cam.width, dtype=dt, device=cam2vol.device)], -1)
    d = d @ cam2vol[:3, :3].to(dt).T
    return cam2vol[:3, 3].to(dt), d / torch.linalg.vector_norm(d.float(), dim=-1,
                                                             keepdim=True).to(dt)


def ray_box(org, dirs, box):
    safe = torch.where(dirs.abs() < 1e-12, torch.full_like(dirs, 1e-12), dirs)
    a = (0.0 - org) / safe
    b = (box - org) / safe
    return torch.minimum(a, b).amax(-1), torch.maximum(a, b).amin(-1)


def _nearest(tsdf, grid: Grid, p):
    X, Y, Z = grid.dims
    i = torch.round(p).clamp(-1e7, 1e7).long()
    ix, iy, iz = i[..., 0], i[..., 1], i[..., 2]
    ok = (ix >= 1) & (ix < X - 1) & (iy >= 1) & (iy < Y - 1) & (iz >= 1) & (iz < Z - 1)
    lin = ((iz * Y + iy) * X + ix).clamp(0, X * Y * Z - 1)
    return tsdf.reshape(-1)[lin], ok, lin


def trilinear(tsdf, grid: Grid, p, dt):
    X, Y, Z = grid.dims
    g = torch.floor(p)
    gi = g.clamp(-1e7, 1e7).long()
    ok = ((gi[..., 0] >= 0) & (gi[..., 0] < X - 1) & (gi[..., 1] >= 0) & (gi[..., 1] < Y - 1)
          & (gi[..., 2] >= 0) & (gi[..., 2] < Z - 1))
    gx = gi[..., 0].clamp(0, X - 2)
    gy = gi[..., 1].clamp(0, Y - 2)
    gz = gi[..., 2].clamp(0, Z - 2)
    f = p - g
    flat = tsdf.reshape(-1)
    acc = torch.zeros(p.shape[:-1], dtype=dt, device=p.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[..., 0] if dx else 1 - f[..., 0]) * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                val = flat[((gz + dz) * Y + gy + dy) * X + gx + dx].to(dt) / SHORTMAX
                acc = acc + val * w
    return acc, ok


def raycast(tsdf: torch.Tensor, cam2vol: torch.Tensor, cam: Camera, grid: Grid, dt,
            read: torch.Tensor | None = None):
    """Camera-frame (vertex, normal) maps [H, W, 3], zero where no surface
    is found. `read`, a bool volume [Z, Y, X], receives every voxel a ray
    samples."""
    X, Y, Z = grid.dims
    vox = torch.tensor(grid.voxel, dtype=dt, device=tsdf.device)
    box = torch.tensor([X * grid.voxel[0], Y * grid.voxel[1], Z * grid.voxel[2]], dtype=dt,
                       device=tsdf.device)
    step = grid.voxel[0]
    org, dirs = camera_rays(cam2vol, cam, dt)
    tn, tf = ray_box(org, dirs, box)
    t0 = torch.clamp(tn, min=0.0) + step

    def sample(k):
        t = t0 + k * step
        val, ok, lin = _nearest(tsdf, grid, (org + dirs * t[..., None]) / vox)
        return t, val.to(dt) / SHORTMAX, ok, lin

    t, f_prev, v_prev, lin = sample(0)
    alive = t < tf
    if read is not None:
        read.view(-1)[lin[alive & v_prev]] = True
    hit_t = torch.full(t.shape, math.inf, dtype=dt, device=t.device)
    k = 0
    while bool(alive.any()):
        k += 1
        t_next, f_next, v_next, lin = sample(k)
        if read is not None:
            read.view(-1)[lin[alive & v_next]] = True
        both = alive & v_prev & v_next
        front = both & (f_prev > 0) & (f_next < 0)
        back = both & (f_prev < 0) & (f_next > 0)
        frac = f_prev / torch.clamp(f_prev - f_next, min=1e-30)
        hit_t = torch.where(front, t + step * frac, hit_t)
        alive = alive & ~front & ~back & (t_next < tf)
        t, f_prev, v_prev = t_next, f_next, v_next
    hit = torch.isfinite(hit_t)
    vert = org + dirs * torch.where(hit, hit_t, torch.zeros_like(hit_t))[..., None]
    grads, ok = [], hit
    for a in range(3):
        e = torch.zeros(3, dtype=dt, device=tsdf.device)
        e[a] = 0.5 * grid.voxel[a]
        f1, o1 = trilinear(tsdf, grid, (vert + e) / vox, dt)
        f2, o2 = trilinear(tsdf, grid, (vert - e) / vox, dt)
        grads.append((f1 - f2) / grid.voxel[a])
        ok = ok & o1 & o2
    n = torch.stack(grads, -1)
    ln = torch.linalg.vector_norm(n.float(), dim=-1, keepdim=True).to(dt)
    ok = ok & (ln[..., 0] > 1e-20)
    n = n / ln.clamp(min=1e-30)
    R = cam2vol[:3, :3].to(dt)
    vcam = (vert - org) @ R
    ncam = n @ R
    m = ok[..., None]
    return torch.where(m, vcam, torch.zeros_like(vcam)), torch.where(m, ncam, torch.zeros_like(ncam))


# ---------------------------------------------------------------- streaming

def centering_shift(anchor_vol: torch.Tensor, grid: Grid, margin: float) -> torch.Tensor:
    """Whole-voxel shift (x, y, z) that brings a volume-frame point back to
    the central box [margin * range, (1 - margin) * range] of each axis."""
    out = []
    for a in range(3):
        rng = grid.dims[a] * grid.voxel[a]
        lo, hi = margin * rng, rng - margin * rng
        p = float(anchor_vol[a])
        ex = p - lo if p < lo else (p - hi if p > hi else 0.0)
        out.append(round(ex / grid.voxel[a]))
    return torch.tensor(out, dtype=torch.int64)


def shift(arr: torch.Tensor, s: Sequence[int]) -> torch.Tensor:
    """new[z, y, x] = old[z + sz, y + sy, x + sx], zero outside."""
    out = torch.zeros_like(arr)
    Z, Y, X = arr.shape
    sx, sy, sz = (int(v) for v in s)

    def rng(n, k):
        return slice(max(0, -k), min(n, n - k)), slice(max(0, k), min(n, n + k))

    (dz, oz), (dy, oy), (dx, ox) = rng(Z, sz), rng(Y, sy), rng(X, sx)
    out[dz, dy, dx] = arr[oz, oy, ox]
    return out
