"""Replica-parallel evaluation sweeps: sequences fanned over the ranks of a
mesh, each rank tracking its share with the single-device step (port of
kinfu_tpu/parallel/sweep.py).

The JAX package scans the step over a sequence inside a `shard_map` over a
"replica" mesh axis (`replica_mesh`); here the replica mesh is any `Mesh`
of `parallel/mesh.py` (`spawn` or `init_mesh`), each rank a process on
its own device (or several on one card, with gloo). A rank tracks its
block of the sequences one after another, and one `psum` of zero
buffers, in which each rank writes its own sequences' poses and flags,
gives every rank all the results.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.parallel.mesh import Mesh, psum
from kinfu_tpu_torch.pipeline.kinfu import init_state, make_step_fn


def _track_one(depths, colors, params: KinFuParams, intr: Intrinsics, device):
    """The single-device step over one sequence: (poses [F,4,4], oks [F])
    as device tensors."""
    step = make_step_fn(params, intr)
    state = init_state(params, intr, device=device)
    poses, oks = [], []
    for d, c in zip(depths, colors):
        state, out = step(state, torch.as_tensor(d, device=device),
                          torch.as_tensor(c, device=device))
        poses.append(out.pose_matrix)
        oks.append(out.tracking_ok)
    return torch.stack(poses), torch.stack(oks)


def track_replicated(depths: np.ndarray, colors: np.ndarray, params: KinFuParams,
                     intr: Intrinsics, mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """Track N sequences, rank r the r-th block of N / world of them.
    depths [N, F, H, W] float32 (raw depth units), colors [N, F, H, W, 3]
    uint8, the same on every rank; N a multiple of the mesh size (see
    `sweep_sequences`). Returns (poses [N,F,4,4], oks [N,F]) on every
    rank."""
    n_seq, n_frames = depths.shape[:2]
    if n_seq % mesh.world:
        raise ValueError(f"{n_seq} sequences do not split over {mesh.world} ranks")
    per = n_seq // mesh.world
    poses = torch.zeros((n_seq, n_frames, 4, 4), dtype=torch.float32, device=mesh.device)
    oks = torch.zeros((n_seq, n_frames), dtype=torch.float32, device=mesh.device)
    for i in range(mesh.rank * per, (mesh.rank + 1) * per):
        p, ok = _track_one(depths[i], colors[i], params, intr, mesh.device)
        poses[i], oks[i] = p, ok.float()
    # each rank wrote only its own rows: the sum is the gather
    flat = psum(torch.cat([poses.reshape(-1), oks.reshape(-1)]))
    return (flat[:poses.numel()].reshape(poses.shape).cpu().numpy(),
            flat[poses.numel():].reshape(oks.shape).cpu().numpy().astype(bool))


def sweep_sequences(sequences: Sequence[Tuple[np.ndarray, np.ndarray]],
                    params: KinFuParams, intr: Intrinsics,
                    mesh: Mesh) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Pad the sequences (list of (depths [F,H,W] float32, colors
    [F,H,W,3] uint8), all the same F, H and W) to a multiple of the mesh
    size with copies of the last, track them over the ranks and drop the
    padding: per sequence (poses [F,4,4], oks [F])."""
    m = len(sequences)
    padded = list(sequences) + [sequences[-1]] * ((-m) % mesh.world)
    depths = np.stack([d for d, _ in padded])
    colors = np.stack([c for _, c in padded])
    poses, oks = track_replicated(depths, colors, params, intr, mesh)
    return [(poses[i], oks[i]) for i in range(m)]
