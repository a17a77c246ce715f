"""The rank mesh of the sharded step and its collectives (port of
kinfu_tpu/parallel/mesh.py and of the collectives of
kinfu_tpu/parallel/sharded.py).

The JAX package runs one program over a device mesh (`shard_map`); the
port runs one process per rank under `torch.distributed`, and the rank
takes the place of `axis_index`. The caller starts the processes and
gives each its rank, the world size and the rendezvous address
(`init_mesh`). The backend is an argument, never a probe: "nccl" needs a
card per rank and raises otherwise, "gloo" also runs several ranks on one
card or on the CPU (it stages CUDA tensors through the host).

Every collective the step makes is an `all_reduce`, written once here:
  - `psum`: SUM (the ICP normal equations, the masked shading psum);
  - `pmin`: MIN (the raycast's hit composite and winner);
  - `halo_exchange`: the neighbours' boundary rows, as a SUM of a zero
    buffer in which each rank writes its own two slots (exact: each slot
    has one writer). NCCL and gloo have no int16 type, so the TSDF
    crosses as int32.
`COLLECTIVES` counts the calls and bytes of each, as `kernels.LAUNCHES`
counts launches. While a profiler records, the halo exchange is the span
`kinfu.shard.halo` and each collective the span `kinfu.shard.collective`,
with its name and the bytes it reduces as the span's args.
"""

from __future__ import annotations

import collections
import os
import pickle
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from kinfu_tpu_torch.device import resolve_device
from kinfu_tpu_torch.utils.profiling import span

#: per collective: calls and bytes reduced, added to where it runs
COLLECTIVES: collections.Counter = collections.Counter()


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: `world` ranks, this one's `rank`,
    the device its tensors live on, the process group's backend and the
    sharded natural array dim of the volume (0 = Z, 1 = Y)."""

    world: int
    rank: int
    device: torch.device
    backend: str
    shard_dim: int = 0


def init_mesh(backend: str, rank: int, world: int, init_method: str,
              device: str | torch.device | None = None) -> Mesh:
    """Join the process group and return this rank's `Mesh`. `backend` is
    "gloo" or "nccl"; `init_method` a rendezvous URL ("tcp://localhost:
    PORT", "file:///path"). The rank's device is cuda:{rank % cards}
    unless `device` names another ("cpu" with gloo); without CUDA that
    raises. "nccl" with more ranks than cards raises: NCCL refuses two
    ranks on one card."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices")
        if world > torch.cuda.device_count():
            raise ValueError(f"the nccl backend needs a card per rank: {world} ranks, "
                             f"{torch.cuda.device_count()} cards")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return Mesh(world=world, rank=rank, device=dev, backend=backend)


def close_mesh() -> None:
    """Leave the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _all_reduce(name: str, x: torch.Tensor, op) -> torch.Tensor:
    nbytes = x.numel() * x.element_size()
    COLLECTIVES[name] += 1
    COLLECTIVES[name + "_bytes"] += nbytes
    with span("kinfu.shard.collective", collective=name, bytes=nbytes):
        dist.all_reduce(x, op=op)
    return x


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `x` (a new tensor; `x` is kept)."""
    return _all_reduce("psum", x.clone(), dist.ReduceOp.SUM)


def pmin(x: torch.Tensor) -> torch.Tensor:
    """The elementwise minimum over the ranks of `x` (a new tensor)."""
    return _all_reduce("pmin", x.clone(), dist.ReduceOp.MIN)


def halo_exchange(mesh: Mesh, x: torch.Tensor, halo: int, dim: int) -> torch.Tensor:
    """`x` padded along `dim` with `halo` rows of each neighbour's slab:
    the previous rank's last rows before it, the next rank's first rows
    after it; zero rows at the global ends, which the raycasts never sample
    (the one-voxel global border rule). kinfu_tpu/parallel/sharded.py:
    59-80."""
    L = x.shape[dim]
    if halo > L:
        raise ValueError(f"halo {halo} exceeds the slab's {L} rows")
    wire = torch.int32 if x.dtype == torch.int16 else x.dtype
    rows = list(x.shape)
    rows[dim] = halo
    with span("kinfu.shard.halo"):
        # slot [r, 0]: rank r's first rows, slot [r, 1]: its last rows
        buf = torch.zeros((mesh.world, 2, *rows), dtype=wire, device=x.device)
        buf[mesh.rank, 0] = x.narrow(dim, 0, halo)
        buf[mesh.rank, 1] = x.narrow(dim, L - halo, halo)
        _all_reduce("halo", buf, dist.ReduceOp.SUM)
        zero = torch.zeros(rows, dtype=wire, device=x.device)
        before = buf[mesh.rank - 1, 1] if mesh.rank > 0 else zero
        after = buf[mesh.rank + 1, 0] if mesh.rank < mesh.world - 1 else zero
        return torch.cat([before.to(x.dtype), x, after.to(x.dtype)], dim=dim)


def reset_collective_counts() -> None:
    COLLECTIVES.clear()


def spawn(fn, world: int, *args, backend: str = "gloo", device=None,
          threads: int | None = None, workdir: str | None = None) -> list:
    """Run `fn(mesh, *args)` on `world` new processes, one rank each, and
    return the ranks' results in rank order. The processes start with the
    "spawn" method (a parent that holds a CUDA context cannot fork), meet
    at a file store under `workdir` (a temporary directory by default),
    take `threads` intra-op threads each when given, and leave the group
    at the end. `fn` and its arguments must pickle. Ranks on the card load
    the kernel library that the parent builds here, so that no two ranks
    build it in one directory. A rank that raises ends them all."""
    import torch.multiprocessing as mp

    from kinfu_tpu_torch.ops import kernels

    on_card = resolve_device("cuda" if device is None else device).type == "cuda"
    if on_card:
        kernels.library()
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        mp.start_processes(_rank_main, nprocs=world, start_method="spawn", join=True,
                           args=(fn, world, backend, f"file://{tmp}/store", device, threads,
                                 on_card, tmp, args))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _rank_main(rank, fn, world, backend, init_method, device, threads, on_card, out_dir,
               args):
    if threads:
        torch.set_num_threads(threads)
    if on_card:
        from kinfu_tpu_torch.ops import kernels

        kernels.library(load_only=True)
    mesh = init_mesh(backend, rank, world, init_method, device=device)
    try:
        res = fn(mesh, *args)
    finally:
        close_mesh()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
