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

Every entry point takes, beside its pointers, the lengths of their arrays
in elements (`lengths`). The checked build (`library(checked=True)`, flags
`CHECKED_FLAGS`) traps on any global load or store outside them
(csrc/checked.cuh); `tools/sanitize.py` runs it. A process loads one of the
two builds, the normal one unless it asks first for the checked one.

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
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
)
#: added for the checked build: bounds checks, and source lines in the binary
CHECKED_FLAGS = ("-DKINFU_CHECKED", "-lineinfo")

#: launches per kernel name, added to by each wrapper where it launches
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry points: name -> argtypes (pointers, the lengths array and the
#: stream are c_void_p, float arguments c_float)
_SIGNATURES = {
    "kinfu_build_faces": [_P] * 6 + [_I] * 4 + [_P] * 2,
    "kinfu_face_integrate": [_P] * 7 + [_I] * 12 + [_P] * 2,
    "kinfu_sweep_rays": [_P] * 4 + [_I] * 12 + [_P] * 2,
    "kinfu_resample_face": [_P] * 7 + [_F] * 6 + [_I] * 3 + [_P] * 2,
    "kinfu_icp_normal_eqs": [_P] * 12 + [_F] * 6 + [_I] * 5 + [_P] * 2,
    "kinfu_icp_solve": [_I] + [_P] * 12 + [_F] * 2 + [_I] * 2 + [_P] * 2,
    "kinfu_march_rays": [_P] * 9 + [_I] * 7 + [_F] + [_P] * 2,
    "kinfu_march_hier": [_P] * 9 + [_I] * 6 + [_F] * 4 + [_P] * 2,
    "kinfu_shift_volume": [_P] * 5 + [_I] * 3 + [_P] * 2,
    "kinfu_face_fields": [_P] * 6 + [_F] * 2 + [_I] * 2 + [_P] * 2,
}

#: the loaded library and whether it is the checked build
_lib = None
_lib_checked = False


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


def build(out_dir: Path = BUILD_DIR, load_only: bool = False, checked: bool = False) -> Path:
    """Compile every csrc/*.cu in parallel and link one shared library
    (with `checked`, the bounds-checked build). Returns its path; reuses an
    earlier build of the same sources, and with `load_only` raises when
    there is none (a process that must not race another on the build
    directory)."""
    cu, headers = _sources()
    flags = NVCC_FLAGS + (CHECKED_FLAGS if checked else ())
    digest = hashlib.sha256(" ".join(flags).encode())
    for p in cu + headers:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = out_dir / f"libkinfu_kernels{'_checked' if checked else ''}_{tag}.so"
    if lib_path.is_file():
        return lib_path
    if load_only:
        raise RuntimeError(f"{lib_path} is not built: build the kernels before loading them")
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in cu:
        obj = out_dir / f"{src.stem}_{tag}.o"
        objs.append(obj)
        cmd = [nvcc, *flags, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
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


def library(load_only: bool = False, checked: bool | None = None) -> ctypes.CDLL:
    """The loaded kernel library, built at first use unless `load_only`.
    `checked` picks the build at first use (default: the normal one); asking
    later for the other build raises."""
    global _lib, _lib_checked
    if _lib is None:
        lib = ctypes.CDLL(str(build(load_only=load_only, checked=bool(checked))))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib, _lib_checked = lib, bool(checked)
    elif checked is not None and checked != _lib_checked:
        raise RuntimeError(f"the {'checked' if _lib_checked else 'normal'} kernel build is "
                           f"already loaded in this process")
    return _lib


def timed_build() -> float:
    """Build (or reuse) the normal and the checked library, their nvcc
    processes all at once, and load the normal one; returns the seconds
    taken."""
    t0 = time.perf_counter()
    checked = threading.Thread(target=build, kwargs={"checked": True})
    checked.start()
    try:
        library()
    finally:
        checked.join()
    build(load_only=True, checked=True)  # raises if the checked build failed
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


def lengths(*tensors) -> ctypes.c_void_p:
    """The lengths array an entry point takes: each tensor's numel (0 for
    None, an array not passed), as int64 in argument order."""
    return host_array(ctypes.c_longlong, [0 if t is None else t.numel() for t in tensors])


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
