"""Where the port runs: on the card unless the caller asks for the CPU.

Every entry point that allocates state (`init_state`, `create_volume`,
`state_from_numpy`, `KinFuSession`, `load_checkpoint`) defaults to
"cuda" and goes through `resolve_device`, which raises when CUDA is
missing instead of silently running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device to run on; "cuda" without a usable CUDA device
    raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not available")
    return dev


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """`values` (numbers or a numpy array) as a tensor on `device`, without
    waiting for the device: a copy to a CUDA device goes through pinned
    host memory and is asynchronous (`torch.tensor(..., device="cuda")`
    copies with a stream synchronisation). Each float rounds to `dtype` on
    the host, as `torch.tensor` rounds it. Callers build such a tensor once
    per device and configuration and keep it; it must not be written to."""
    host = torch.as_tensor(values, dtype=dtype).clone()
    dev = torch.device(device)
    if dev.type != "cuda":
        return host.to(dev)
    return host.pin_memory().to(dev, non_blocking=True)
