"""Build, load and count the hand-written CUDA kernels of `csrc/`.

Every `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, for `sm_90a` with `-fmad=false` (the kernels must reproduce the
rounding of their plain PyTorch versions: every pixel and voxel index is
rint-rounded, and a contracted multiply-add can flip a .5 tie), then
linked into one shared library with a plain C interface, loaded with
ctypes. No PyTorch header is included, so the build takes seconds.

The build runs at first use into `build/kernels/` of the checkout (listed
in .gitignore), keyed by a hash of the sources and flags. `nvcc` is taken
from PATH or from `$CUDA_HOME/bin` (default /usr/local/cuda); without it a
launch raises.

`LAUNCHES` counts, per kernel, the launches made by its wrapper. A run
that sets the counts to 0 before it drives the main path and reads them
after shows that the path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
)

#: launches per kernel name, added to by each wrapper where it launches
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry points: name -> argtypes (pointers and the stream are c_void_p,
#: float arguments c_float)
_SIGNATURES = {
    "kinfu_build_faces": [_P] * 6 + [_I] * 4 + [_P],
    "kinfu_face_integrate": [_P] * 7 + [_I] * 11 + [_P],
    "kinfu_sweep_rays": [_P] * 4 + [_I] * 8 + [_P],
    "kinfu_resample_face": [_P] * 7 + [_F] * 6 + [_I] * 3 + [_P],
    "kinfu_icp_normal_eqs": [_P] * 12 + [_F] * 6 + [_I] * 5 + [_P],
    "kinfu_icp_solve": [_I] + [_P] * 12 + [_F] * 2 + [_I] * 2 + [_P],
}

_lib = None


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels of "
        "kinfu_tpu_torch cannot be built, so CUDA tensors cannot be processed"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build(out_dir: Path = BUILD_DIR) -> Path:
    """Compile every csrc/*.cu in parallel and link one shared library.
    Returns its path; reuses an earlier build of the same sources."""
    nvcc = find_nvcc()
    cu, headers = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + headers:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    tag = digest.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libkinfu_kernels_{tag}.so"
    if lib_path.is_file():
        return lib_path
    objs, procs = [], []
    for src in cu:
        obj = out_dir / f"{src.stem}_{tag}.o"
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objs)]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{' '.join(link)}\n{res.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def timed_build() -> float:
    """Build (or reuse) and load the library; returns the seconds taken."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0


def launch(name: str, *args, key: str | None = None, count: int = 1) -> None:
    """Call C entry point `name` on the current stream; raise on a CUDA
    error reported by its launches; add `count`, the kernel launches the
    entry point makes, to the count of kernel `key` (default: `name`
    without its "kinfu_" prefix)."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[key or name.removeprefix("kinfu_")] += count


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ptr_array(tensors) -> ctypes.c_void_p:
    """A host array of the tensors' device pointers, for an entry point that
    takes several tensors of one kind (the array lives as long as the
    returned pointer object is referenced: until the call returns)."""
    arr = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    p = ctypes.cast(arr, ctypes.c_void_p)
    p._keep = arr
    return p


def host_array(ctype, values) -> ctypes.c_void_p:
    """A host array of C numbers (`ctypes.c_float`, `ctypes.c_int`), passed
    like `ptr_array`."""
    arr = (ctype * len(values))(*values)
    p = ctypes.cast(arr, ctypes.c_void_p)
    p._keep = arr
    return p
