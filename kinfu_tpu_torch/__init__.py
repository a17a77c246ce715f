"""kinfu_tpu_torch — the PyTorch/CUDA port of kinfu_tpu for NVIDIA Hopper.

The JAX package (`kinfu_tpu/`) stays the reference; this package mirrors
its subpackages one for one and never imports jax or kinfu_tpu. Plain
tensor code is PyTorch; every Pallas TPU kernel on the ported path is a
hand-written CUDA C++ kernel under `csrc/`, built with nvcc for sm_90a at
first use (`ops/kernels.py`). Each kernel has a plain PyTorch version in the
same module: a wrapper takes it for CPU tensors and launches the kernel for
CUDA tensors.

Importing the package disables TF32 for matmuls and cuDNN. It mirrors
`kinfu_tpu/__init__.py`, which forces "highest" matmul precision: the pose
products, ICP's Gram matrix and the 6x6 solve must run in full float32,
because TF32 keeps ~3 decimal digits, which ruins trajectory accuracy.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from kinfu_tpu_torch.config import KinFuParams  # noqa: E402,F401
