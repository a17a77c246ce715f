"""The sharded step's index and size helpers at a slab of more than 2^31
voxels, without allocating it: the 4096x512x6144 grid of
kfbench/configs/kinfu-shard-floor.json over four ranks in Y slabs, each
rank's slab 6144x128x4096 (3.22 G voxels, 24 GiB), on the "meta" device,
whose tensors have shapes and no storage.

  - `init_state_local` and `global_shape`: the slab's shape and count, and
    the fused rule (`fused_supported`) on the global and the local shape;
  - `halo_exchange` (its collective stood in by the identity): the padded
    slab's shape and the 6.4 GB reduced, counted exactly;
  - `ray_shard`: each face's global plane and row counts and the slab's
    first plane or row, for every rank;
  - `fold_shard_origin`: the slab's origin moved into the pose;
  - `kernels.lengths`: the element counts the kernels take, as int64;
  - `row_shard`: each rank's block of image rows."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose
from kinfu_tpu_torch.ops import kernels
from kinfu_tpu_torch.ops.facewarp import face_frames
from kinfu_tpu_torch.parallel import mesh as pmesh
from kinfu_tpu_torch.parallel.sharded import (
    HALO8,
    global_shape,
    init_state_local,
    ray_shard,
    row_shard,
)
from kinfu_tpu_torch.pipeline.kinfu import fused_supported
from kinfu_tpu_torch.volume.integrate import fold_shard_origin

CONFIG = Path(__file__).resolve().parents[1] / "kfbench" / "configs" / "kinfu-shard-floor.json"
WORLD = 4
LOCAL = (6144, 128, 4096)  # [Z, Y, X] of a rank's slab
BIG = 2**31


def _floor():
    c = json.loads(CONFIG.read_text())
    p = dict(c["params"])
    for k in ("icp_iters", "volume_dims", "volume_range", "volume_origin"):
        p[k] = tuple(p[k])
    s = c["sensor"]
    return KinFuParams(**p), Intrinsics(s["width"], s["height"], s["fx"], s["fy"], s["cx"],
                                        s["cy"])


def _mesh(rank: int) -> pmesh.Mesh:
    return pmesh.Mesh(world=WORLD, rank=rank, device=torch.device("meta"), backend="gloo",
                      shard_dim=1)


@pytest.mark.parametrize("rank", range(WORLD))
def test_slab_shape_and_count(rank):
    params, intr = _floor()
    m = _mesh(rank)
    state = init_state_local(params, intr, m)
    for a, dt in zip(state.vol, (torch.int16, torch.int16, torch.int32)):
        assert tuple(a.shape) == LOCAL and a.dtype == dt and a.device.type == "meta"
    assert state.vol.tsdf.numel() == 6144 * 128 * 4096 > BIG
    assert sum(a.numel() * a.element_size() for a in state.vol) == 24 * 2**30
    assert global_shape(LOCAL, m) == (6144, 512, 4096)
    assert np.prod(global_shape(LOCAL, m), dtype=np.int64) * 8 == 96 * 2**30
    assert (fused_supported(global_shape(LOCAL, m), params, "cuda", 1)
            and fused_supported(LOCAL, params, "cuda", 1))


@pytest.mark.parametrize("rank", range(WORLD))
def test_halo_exchange_sizes(rank, monkeypatch):
    reduced = []
    monkeypatch.setattr(pmesh.dist, "all_reduce", lambda x, op=None: reduced.append(x))
    pmesh.reset_collective_counts()
    tsdf = torch.empty(LOCAL, dtype=torch.int16, device="meta")
    padded = pmesh.halo_exchange(_mesh(rank), tsdf, HALO8, 1)
    assert tuple(padded.shape) == (6144, 128 + 2 * HALO8, 4096)
    assert padded.dtype == torch.int16 and padded.numel() > BIG
    assert [tuple(x.shape) for x in reduced] == [(WORLD, 2, 6144, HALO8, 4096)]
    halo_bytes = WORLD * 2 * HALO8 * 6144 * 4096 * 4
    assert halo_bytes > 2**32
    assert pmesh.COLLECTIVES["halo"] == 1
    assert pmesh.COLLECTIVES["halo_bytes"] == halo_bytes
    pmesh.reset_collective_counts()


@pytest.mark.parametrize("rank", range(WORLD))
def test_ray_shard_of_every_face(rank):
    padded = (6144, 128 + 2 * HALO8, 4096)
    Lg, Ll, off0 = 512, 128, 128 * rank
    nat_g = (6144, Lg, 4096)
    for frame in face_frames(1):
        sh = ray_shard(frame, padded, Lg, Ll, off0, 1)
        assert (sh.Zg, sh.Yg) == (nat_g[frame.axes[0]], nat_g[frame.axes[1]])
        if frame.axes[0] == 1:  # +-y: the slab's rows are the face's planes
            assert sh.row0 == 0
            assert sh.plane0 == (Lg - (off0 + Ll + HALO8) if frame.flip else off0 - HALO8)
        else:  # +-z, +-x: the slab's rows are the face's rows
            assert frame.axes[1] == 1 and (sh.plane0, sh.row0) == (0, off0 - HALO8)
        assert all(-BIG <= v < BIG for v in sh)


@pytest.mark.parametrize("rank", range(WORLD))
def test_slab_origin_in_the_pose(rank):
    params, _ = _floor()
    R = torch.eye(3)
    t = torch.tensor([0.1, -0.2, 0.3])
    moved = fold_shard_origin(Pose(R, t), 128 * rank, 1, params.voxel_size)
    off = float(np.float32(128 * rank) * np.float32(params.voxel_size[1]))
    assert torch.equal(moved.t, t + torch.tensor([0.0, off, 0.0]))
    assert off == pytest.approx(0.75 * rank, abs=1e-6)


def test_kernel_lengths_are_64_bit():
    vol = [torch.empty(LOCAL, dtype=dt, device="meta")
           for dt in (torch.int16, torch.int16, torch.int32)]
    lens = kernels.lengths(*vol, None)
    assert list(lens._keep) == [6144 * 128 * 4096] * 3 + [0]


@pytest.mark.parametrize("rank", range(WORLD))
def test_row_shard_of_the_frame(rank):
    img = torch.empty((480, 640, 3), device="meta")
    rows = row_shard(img, _mesh(rank))
    assert tuple(rows.shape) == (120, 640, 3)
