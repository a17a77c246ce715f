"""The comparison that decides `correct`: what the system produced on a
frame, judged against the plain reference (`kinfu.py`) run from the same
inputs.

A state is a dict: "vol" (tsdf int16, weight int16, colour int32, each
[Z, Y, X]), "pose" (world from camera, 4x4 float32), "vmaps" / "nmaps"
(the model maps per pyramid level, camera frame, finest first) and
"origin" (the streaming grid's whole-voxel offset, int [3] x y z, or None
for a fixed grid).

Two checks, each giving numbers in which 0 is perfect:
  - `judge_start`: the bootstrap frame from an empty map, which the system
    fuses at the identity pose: its model maps are the frame's measurement
    pyramid (`pyramid_miss_pct`) and its volume is the frame fused into an
    empty grid (`fuse_miss_pct`);
  - `judge_step`: one tracked frame from the system's own state before it:
    the pose against the reference's ICP from that state (`pose_gap_mm`),
    the volume against the reference's shift and fusion of the frame at
    the system's pose (`fuse_miss_pct`, and `origin_gap_vox` on a moving
    grid), and the model maps against the reference's raycast of the
    system's fused volume at the system's pose (`map_miss_pct`).

Each number's tolerance inside it (a voxel counts as mismatched when ...)
is part of its definition and is stated below; the limits the numbers
are held to live in `limits/<workload>.json`.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from kfbench.reference import kinfu as K

#: a voxel mismatches when its weights differ, when its TSDF differs by
#: more than this share of the truncation band once the running average's
#: weight is undone (|dt| * (w_before + 1)), or when a colour channel
#: differs by more than COLOUR_TOL
OBS_TOL = 0.25
COLOUR_TOL = 8
#: a pixel mismatches when one side finds a surface and the other none, or
#: both do and the system's vertex lies more than PLANE_TOL_VOX voxels from
#: the reference's tangent plane (its vertex and normal) or their normals
#: are more than NORMAL_TOL_DEG apart; the distance to the plane leaves out
#: the sideways offset of a vertex along the surface, which the port's
#: resample onto the camera grid makes by design
PLANE_TOL_VOX = 0.75
NORMAL_TOL_DEG = 30.0
#: a pyramid pixel mismatches when its vertices differ by more than this
#: (m) or a normal component by more than PYR_NORMAL_TOL
PYR_VERTEX_TOL_M = 1e-5
PYR_NORMAL_TOL = 1e-3


class Setup:
    """What the reference needs of a configuration: its parameters (the
    configuration file's "params"), the camera, the grid, and the moving
    grid's margin (None for a fixed grid)."""

    def __init__(self, config: dict):
        p = config["params"]
        s = config["sensor"]
        self.cfg = dict(p)
        self.cam = K.Camera(int(s["width"]), int(s["height"]), float(s["fx"]), float(s["fy"]),
                            float(s["cx"]), float(s["cy"]))
        dims = tuple(int(v) for v in p["volume_dims"])
        rng = tuple(float(v) for v in p["volume_range"])
        voxel = tuple(r / d for r, d in zip(rng, dims))
        trunc = float(p.get("trunc_dist") or 2.1 * rng[0] / dims[0])
        self.grid = K.Grid(dims, voxel, trunc, int(p["tsdf_max_weight"]))
        origin = p.get("volume_origin") or (-rng[0] / 2.0, -rng[1] / 2.0, 0.5)
        self.base = tuple(float(v) for v in origin)
        sess = config.get("session", {})
        self.margin = float(sess.get("margin_frac", 0.25)) if sess.get("streaming") else None

    def vol_pose(self, origin, device) -> torch.Tensor:
        """World from volume, 4x4 float32, of the grid at `origin` voxels."""
        T = torch.eye(4, dtype=torch.float64)
        off = [0, 0, 0] if origin is None else [int(v) for v in origin]
        for a in range(3):
            T[a, 3] = self.base[a] + off[a] * self.grid.voxel[a]
        return T.float().to(device)

    def corners(self, origin, device) -> torch.Tensor:
        """The grid's eight corners in the world, [8, 3] float64."""
        X, Y, Z = (d * v for d, v in zip(self.grid.dims, self.grid.voxel))
        c = torch.tensor([[x, y, z] for x in (0, X) for y in (0, Y) for z in (0, Z)],
                         dtype=torch.float64)
        return c + self.vol_pose(origin, "cpu").double()[:3, 3]


def _q(x: torch.Tensor, qs=(0.5, 0.9, 0.99)) -> str:
    """Quantiles of a sample of `x` (at most 1M values), for the log."""
    x = x.float().flatten()
    if x.numel() == 0:
        return "none"
    x = x[::max(1, x.numel() // 1_000_000)][:1_000_000]
    v = torch.quantile(x, torch.tensor(qs, device=x.device)).tolist()
    return " ".join(f"q{int(q * 100)} {a:.4g}" for q, a in zip(qs, v)) + f" max {float(x.max()):.4g}"


def vol_miss(before, prog, ref, ref_upd):
    """(changed, bad, wbad, gap, dc): the voxels that the reference updates
    or either side changes, those of them where the two disagree (OBS_TOL,
    COLOUR_TOL), those whose weights differ, and each voxel's TSDF gap (of
    the band) and colour gap."""
    (t0, w0, c0), (tp, wp, cp), (tr, wr, cr) = before, prog, ref
    changed = ref_upd | (tp != t0) | (wp != w0) | (cp != c0) | (tr != t0) | (cr != c0)
    gap = (tp.float() - tr.float()).abs() * ((w0.float() + 1.0) / K.SHORTMAX)
    dc = (K.unpack(cp, torch.int32) - K.unpack(cr, torch.int32)).abs().amax(-1)
    wbad = changed & (wp != wr)
    bad = changed & ((wp != wr) | (gap > OBS_TOL) | (dc > COLOUR_TOL))
    return changed, bad, wbad, gap, dc


def _vol_miss_pct(before, prog, ref, ref_upd, diag=None) -> float:
    """Share (%) of the voxels that the reference updates or either side
    changes where the two disagree (OBS_TOL, COLOUR_TOL)."""
    changed, bad, wbad, gap, dc = vol_miss(before, prog, ref, ref_upd)
    n = int(changed.sum())
    if n == 0:
        return 0.0
    if diag is not None:
        diag.append(f"fuse: {n} voxels updated or changed, weight differs on {int(wbad.sum())}, "
                    f"obs gap {_q(gap[changed])}, colour gap {_q(dc[changed])}")
    return 100.0 * int(bad.sum()) / n


def _map_miss_pct(vp, np_, vr, nr, voxel: float, diag=None) -> float:
    """Share (%) of the pixels where either side found a surface on which
    the maps disagree (PLANE_TOL_VOX, NORMAL_TOL_DEG)."""
    hp = (np_ != 0).any(-1)
    hr = (nr != 0).any(-1)
    anyhit = hp | hr
    n = int(anyhit.sum())
    if n == 0:
        return 0.0
    diff = vp.float() - vr.float()
    dplane = (diff * nr.float()).sum(-1).abs() / voxel
    cos = (np_.float() * nr.float()).sum(-1).clamp(-1.0, 1.0)
    both = hp & hr
    bad = (hp != hr) | (both & ((dplane > PLANE_TOL_VOX)
                                | (cos < math.cos(math.radians(NORMAL_TOL_DEG)))))
    if diag is not None:
        dv = torch.linalg.vector_norm(diff, dim=-1) / voxel
        ang = torch.rad2deg(torch.acos(cos[both]))
        diag.append(f"map: {n} pixels hit, {int((hp != hr).sum())} by one side only, "
                    f"plane gap (voxels) {_q(dplane[both])}, vertex gap (voxels) "
                    f"{_q(dv[both])}, normal gap (deg) {_q(ang)}")
    return 100.0 * int((bad & anyhit).sum()) / n


def _pyr_miss_pct(vps, nps, vrs, nrs) -> float:
    bad, n = 0, 0
    for vp, np_, vr, nr in zip(vps, nps, vrs, nrs):
        dv = (vp.float() - vr.float()).abs().amax(-1)
        dn = (np_.float() - nr.float()).abs().amax(-1)
        bad += int(((dv > PYR_VERTEX_TOL_M) | (dn > PYR_NORMAL_TOL)).sum())
        n += dv.numel()
    return 100.0 * bad / n


def _clone_vol(vol):
    return tuple(a.clone() for a in vol)


def step_outputs(st: Setup, depth_mm, rgb, before: dict, dt) -> dict:
    """The reference put in the system's place: the state after one frame
    from `before`, computed in `dt` (the control runs it in a lower
    precision than the configuration states)."""
    dev = before["vol"][0].device
    ds, vs, ns = K.measurement(torch.as_tensor(depth_mm, device=dev), st.cam, st.cfg, dt)
    inc, _, _ = K.icp(vs, ns, before["vmaps"], before["nmaps"], st.cam, st.cfg, dt)
    pose = before["pose"].to(dt) @ inc
    origin = before["origin"]
    vol = _clone_vol(before["vol"])
    if origin is not None:
        s = _shift_of(st, pose.float(), origin)
        vol = tuple(K.shift(a, s.tolist()) for a in vol)
        origin = origin.cpu() + s
    vp = st.vol_pose(origin, dev).to(dt)
    K.fuse(*vol, ds[0], torch.as_tensor(rgb, device=dev), torch.linalg.inv(pose.float()).to(dt)
           @ vp, st.cam, st.grid, dt)
    vm, nm = K.raycast(vol[0], torch.linalg.inv(vp.float()).to(dt) @ pose, st.cam, st.grid, dt)
    vms, nms = K.model_pyramid(vm, nm, st.cfg["pyramid_height"])
    return {"vol": vol, "pose": pose.float(), "vmaps": [v.float() for v in vms],
            "nmaps": [n.float() for n in nms], "origin": origin}


def start_outputs(st: Setup, depth_mm, rgb, device, dt) -> dict:
    """The reference in the system's place on the bootstrap frame."""
    X, Y, Z = st.grid.dims
    vol = (torch.zeros((Z, Y, X), dtype=torch.int16, device=device),
           torch.zeros((Z, Y, X), dtype=torch.int16, device=device),
           torch.zeros((Z, Y, X), dtype=torch.int32, device=device))
    ds, vs, ns = K.measurement(torch.as_tensor(depth_mm, device=device), st.cam, st.cfg, dt)
    vp = st.vol_pose(None if st.margin is None else [0, 0, 0], device).to(dt)
    upd = torch.zeros(vol[0].shape, dtype=torch.bool, device=device)
    K.fuse(*vol, ds[0], torch.as_tensor(rgb, device=device), vp, st.cam, st.grid, dt, upd=upd)
    return {"upd": upd, "vol": vol, "pose": torch.eye(4, device=device), "vmaps": [v.float() for v in vs],
            "nmaps": [n.float() for n in ns],
            "origin": None if st.margin is None else torch.zeros(3, dtype=torch.int64)}


def _shift_of(st: Setup, pose: torch.Tensor, origin) -> torch.Tensor:
    anchor_cam = torch.tensor([0.0, 0.0, 0.5 * st.grid.dims[2] * st.grid.voxel[2]],
                              dtype=torch.float64)
    anchor_w = pose.double().cpu()[:3, :3] @ anchor_cam + pose.double().cpu()[:3, 3]
    anchor_vol = anchor_w - st.vol_pose(origin, "cpu").double()[:3, 3]
    return K.centering_shift(anchor_vol, st.grid, st.margin)


def judge_start(st: Setup, depth_mm, rgb, prog: dict, diag=None) -> Dict[str, float]:
    """The bootstrap frame's numbers: `prog` is the system's state after
    it."""
    dev = prog["vol"][0].device
    ref = start_outputs(st, depth_mm, rgb, dev, torch.float32)
    before = tuple(torch.zeros_like(a) for a in prog["vol"])
    return {"pyramid_miss_pct": _pyr_miss_pct(prog["vmaps"], prog["nmaps"], ref["vmaps"],
                                              ref["nmaps"]),
            "fuse_miss_pct": _vol_miss_pct(before, prog["vol"], ref["vol"], ref["upd"], diag)}


def pose_gap_mm(st: Setup, vs, ns, before: dict, pose) -> float:
    """The largest gap (mm) of the grid's 8 corners between `pose` and the
    reference's ICP of the frame's measurement (vs, ns) from the state
    `before` it."""
    dev = vs[0].device
    inc, _, _ = K.icp(vs, ns, before["vmaps"], before["nmaps"], st.cam, st.cfg, torch.float32)
    pose_ref = before["pose"].double() @ inc.double()
    pose_prog = pose.double()
    pts = st.corners(before["origin"], "cpu").to(dev)
    gap = ((pts @ pose_prog[:3, :3].T + pose_prog[:3, 3])
           - (pts @ pose_ref[:3, :3].T + pose_ref[:3, 3]))
    return float(torch.linalg.vector_norm(gap, dim=-1).max()) * 1e3


def judge_step(st: Setup, depth_mm, rgb, before: dict, prog: dict,
               diag=None) -> Dict[str, float]:
    """One tracked frame's numbers: `before` is the system's state before
    the frame, `prog` after it."""
    dev = before["vol"][0].device
    f32 = torch.float32
    ds, vs, ns = K.measurement(torch.as_tensor(depth_mm, device=dev), st.cam, st.cfg, f32)
    out = {"pose_gap_mm": pose_gap_mm(st, vs, ns, before, prog["pose"])}

    vol = _clone_vol(before["vol"])
    origin = before["origin"]
    if origin is not None:
        s = _shift_of(st, prog["pose"], origin)
        vol = tuple(K.shift(a, s.tolist()) for a in vol)
        origin = origin.cpu() + s
        out["origin_gap_vox"] = float((origin - prog["origin"].cpu()).abs().max())
    vp = st.vol_pose(origin, dev)
    upd = torch.zeros(vol[0].shape, dtype=torch.bool, device=dev)
    K.fuse(*vol, ds[0], torch.as_tensor(rgb, device=dev),
           torch.linalg.inv(prog["pose"].float()) @ vp, st.cam, st.grid, f32, upd=upd)
    before_shifted = before["vol"] if origin is None else tuple(
        K.shift(a, s.tolist()) for a in before["vol"])
    out["fuse_miss_pct"] = _vol_miss_pct(before_shifted, prog["vol"], vol, upd, diag)
    del vol, before_shifted, upd

    vp_prog = st.vol_pose(prog["origin"], dev)
    vm, nm = K.raycast(prog["vol"][0], torch.linalg.inv(vp_prog) @ prog["pose"].float(), st.cam,
                       st.grid, f32)
    out["map_miss_pct"] = _map_miss_pct(prog["vmaps"][0], prog["nmaps"][0], vm, nm,
                                        st.grid.voxel[0], diag)
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the frames checked."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is a number within its limit."""
    return all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())
