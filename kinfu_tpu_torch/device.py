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
