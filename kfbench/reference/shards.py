"""The check of `compare.py` on a volume split into slabs over the ranks of
the sharded step: each rank holds one slab of the grid along a natural
array dim (0 = Z, 1 = Y; `work.slab_of`), as host copies that the check
moves to the rank's card a block of planes at a time, so that no more
than a block of check copies lives on a card.

  - fusion: each rank judges its slab as a volume of its own, every
    voxel fused at its place in the whole grid (`fuse_counts`); the
    ranks' counts of mismatched and counted voxels are summed before the
    share is taken, so over a whole state the share is the one-card
    judge's;
  - raycast: the reference raycasts the whole grid, rays entering at the
    whole grid's box, reading the voxels of one box (`union_box`: every
    voxel where the TSDF, the weight or the colour is not 0 on any rank,
    and a margin) gathered onto one card (`BoxVolume`); a read outside the
    box gives 0, the TSDF of every voxel there, so the samples are those
    of the whole volume's raycast.

A host copy (`SlabCopy`) keeps only the box of a slab's nonzero voxels,
losing nothing: the check's copies take the host memory of what is fused,
not of the slab.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from kfbench.reference import compare
from kfbench.reference import kinfu as K

#: voxels of the state moved to the card at a time (8 B each)
BLOCK_VOXELS = 1 << 26
#: voxels added around the box of nonzero voxels on each side
BOX_MARGIN = 1


def slab_shape(st, slab) -> Tuple[int, int, int]:
    """[Z, Y, X] of a slab (dim, lo, hi) of the grid."""
    shape = [st.grid.dims[2], st.grid.dims[1], st.grid.dims[0]]
    shape[slab[0]] = slab[2] - slab[1]
    return tuple(shape)


def slab_origin(slab) -> Tuple[int, int, int]:
    """The grid's (z, y, x) index of a slab's first voxel."""
    return (slab[1], 0, 0) if slab[0] == 0 else (0, slab[1], 0)


def empty(st, slab) -> SlabCopy:
    """The copy of an empty slab (TSDF, weight, colour all 0)."""
    return SlabCopy(slab_shape(st, slab), (torch.int16, torch.int16, torch.int32))


def blocks(shape: Sequence[int]):
    """Slices of planes along dim 0 of an array [Z, Y, X], each of at most
    BLOCK_VOXELS voxels (one plane at least)."""
    step = max(1, BLOCK_VOXELS // max(1, shape[1] * shape[2]))
    return [slice(z, min(shape[0], z + step)) for z in range(0, shape[0], step)]


class SlabCopy:
    """A lossless host copy of a slab's arrays ([Z, Y, X] each; TSDF,
    weight, colour, or fewer) that keeps only the box of voxels where any
    array is not 0: outside it every array is 0. `lo`, `hi`: the box in the
    slab's (z, y, x) indices, None where every voxel is 0."""

    def __init__(self, shape, dtypes, lo=None, hi=None, arrays=()):
        self.shape, self.dtypes = tuple(shape), tuple(dtypes)
        self.lo, self.hi, self.arrays = lo, hi, tuple(arrays)

    @classmethod
    def of(cls, arrays: Sequence[torch.Tensor], device) -> "SlabCopy":
        """The copy of `arrays` (on the host or on `device`), read a block
        of planes at a time on `device`."""
        shape = tuple(arrays[0].shape)
        lo, hi = [None] * 3, [None] * 3
        for sl in blocks(shape):
            m = None
            for a in arrays:
                nz = a[sl].to(device) != 0
                m = nz if m is None else (m | nz)
            for ax in range(3):
                idx = torch.nonzero(m.any(dim=tuple(d for d in range(3) if d != ax))).flatten()
                if idx.numel() == 0:
                    break
                a0, a1 = int(idx[0]), int(idx[-1]) + 1
                if ax == 0:
                    a0, a1 = a0 + sl.start, a1 + sl.start
                lo[ax] = a0 if lo[ax] is None else min(lo[ax], a0)
                hi[ax] = a1 if hi[ax] is None else max(hi[ax], a1)
        dtypes = [a.dtype for a in arrays]
        if lo[0] is None:
            return cls(shape, dtypes)
        (z0, y0, x0), (z1, y1, x1) = lo, hi
        out = [torch.empty((z1 - z0, y1 - y0, x1 - x0), dtype=a.dtype) for a in arrays]
        for sl in blocks(out[0].shape):
            for o, a in zip(out, arrays):
                o[sl].copy_(a[z0 + sl.start:z0 + sl.stop, y0:y1, x0:x1])
        return cls(shape, dtypes, tuple(lo), tuple(hi), out)

    def region(self, lo, hi, device, index: Optional[int] = None):
        """The arrays (or array `index` alone) over the slab's box [lo, hi),
        on `device`."""
        picked = range(len(self.dtypes)) if index is None else [index]
        out = [torch.zeros([b - a for a, b in zip(lo, hi)], dtype=self.dtypes[i], device=device)
               for i in picked]
        if self.lo is not None:
            a = [max(x, y) for x, y in zip(lo, self.lo)]
            b = [min(x, y) for x, y in zip(hi, self.hi)]
            if all(x < y for x, y in zip(a, b)):
                for o, i in zip(out, picked):
                    o[a[0] - lo[0]:b[0] - lo[0], a[1] - lo[1]:b[1] - lo[1],
                      a[2] - lo[2]:b[2] - lo[2]] = self.arrays[i][
                        a[0] - self.lo[0]:b[0] - self.lo[0], a[1] - self.lo[1]:b[1] - self.lo[1],
                        a[2] - self.lo[2]:b[2] - self.lo[2]].to(device)
        return out if index is None else out[0]

    def block(self, sl: slice, device) -> tuple:
        """Planes `sl` of the slab's arrays, on `device`."""
        return tuple(self.region((sl.start, 0, 0), (sl.stop, *self.shape[1:]), device))


def fuse_counts(st, slab, depth_m, rgb, before: SlabCopy, prog: Optional[SlabCopy], vol2cam,
                device, control=None, keep: Optional[torch.Tensor] = None) -> dict:
    """`compare.vol_miss` of a rank's slab: {"bad", "n", "wbad"}, the voxels
    where the program and the reference disagree, those counted (the
    reference updates them or either side changes them) and those whose
    weights differ. `before` and `prog` are the slab's (tsdf, weight,
    colour) before and after the frame; the reference fuses `depth_m` (the
    filtered level 0, on `device`) and `rgb` at `vol2cam` in float32, each
    voxel at its place in the whole grid. With `control` (dt, depth_m,
    vol2cam), the program's slab is instead the reference's fusion of
    `before` in dt at that pose, whose TSDF goes into `keep` (host)."""
    z0, y0, _ = slab_origin(slab)
    rgb = torch.as_tensor(rgb, device=device)
    f32 = torch.float32
    bad = n = wbad = 0
    for sl in blocks(before.shape):
        b = before.block(sl, device)
        lo = (0, y0, z0 + sl.start)
        if control is None:
            p = prog.block(sl, device)
        else:
            dt, dm, v2c = control
            p = tuple(a.clone() for a in b)
            K.fuse(*p, dm, rgb, v2c, st.cam, st.grid, dt, lo=lo)
            keep[sl].copy_(p[0])
        r = tuple(a.clone() for a in b)
        upd = torch.zeros(r[0].shape, dtype=torch.bool, device=device)
        K.fuse(*r, depth_m, rgb, vol2cam, st.cam, st.grid, f32, upd=upd, lo=lo)
        changed, mis, wmis, _, _ = compare.vol_miss(b, p, r, upd)
        n += int(changed.sum())
        bad += int(mis.sum())
        wbad += int(wmis.sum())
        del b, p, r, upd, changed, mis, wmis
    return {"bad": bad, "n": n, "wbad": wbad}


def miss_pct(counts: List[dict]) -> float:
    """The share (%) of mismatched voxels over the ranks' summed counts, as
    `compare._vol_miss_pct` takes it over one volume."""
    n = sum(c["n"] for c in counts)
    return 0.0 if n == 0 else 100.0 * sum(c["bad"] for c in counts) / n


def grid_box(copy: SlabCopy, slab) -> Optional[Tuple[tuple, tuple]]:
    """A copy's box in the whole grid's (z, y, x) indices; None where it
    has none."""
    if copy.lo is None:
        return None
    org = slab_origin(slab)
    return (tuple(o + v for o, v in zip(org, copy.lo)),
            tuple(o + v for o, v in zip(org, copy.hi)))


def union_box(st, boxes) -> Tuple[tuple, tuple]:
    """The box holding every rank's box, BOX_MARGIN voxels wider and within
    the grid; one voxel where no rank has one."""
    boxes = [b for b in boxes if b is not None]
    size = (st.grid.dims[2], st.grid.dims[1], st.grid.dims[0])
    if not boxes:
        return (0, 0, 0), (1, 1, 1)
    lo = tuple(max(0, min(b[0][a] for b in boxes) - BOX_MARGIN) for a in range(3))
    hi = tuple(min(size[a], max(b[1][a] for b in boxes) + BOX_MARGIN) for a in range(3))
    return lo, hi


class BoxVolume:
    """A whole grid's TSDF [Z, Y, X] held only inside a box: `box` the
    values from the grid's voxel `lo` (z, y, x); a read outside gives 0.
    It stands in for the whole array in `kinfu.raycast`, which reads its
    TSDF only through `reshape(-1)[index]`, by the whole grid's linear
    index."""

    def __init__(self, box: torch.Tensor, lo, dims):
        self.box, self.lo, self.dims = box, lo, dims
        self.device = box.device

    def reshape(self, *shape):
        return self

    def __getitem__(self, lin: torch.Tensor) -> torch.Tensor:
        X, Y, _ = self.dims
        bz, by, bx = self.box.shape
        z = lin // (X * Y) - self.lo[0]
        y = (lin // X) % Y - self.lo[1]
        x = lin % X - self.lo[2]
        inside = (z >= 0) & (z < bz) & (y >= 0) & (y < by) & (x >= 0) & (x < bx)
        i = (z.clamp(0, bz - 1) * by + y.clamp(0, by - 1)) * bx + x.clamp(0, bx - 1)
        return torch.where(inside, self.box.reshape(-1)[i], 0)


def raycast_box(st, box: torch.Tensor, lo, cam2vol: torch.Tensor, dt):
    """`kinfu.raycast` of the whole grid whose nonzero TSDF lies in `box`
    from voxel `lo`: camera-frame (vertex, normal) maps."""
    return K.raycast(BoxVolume(box, lo, st.grid.dims), cam2vol, st.cam, st.grid, dt)
