"""PLY point-cloud export and import (numpy-only copy of
kinfu_tpu/io/ply.py, without its native C++ writer).

Parity: kinectfusion::savePointcloud writes ASCII xyz PLY
(kinectfusion.cpp:148-166). Binary little-endian output is supported too,
and colour (uchar red, green, blue). The files are byte for byte those of
the JAX package's Python path.
"""

from __future__ import annotations

import numpy as np


def write_ply(
    path: str,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    binary: bool = False,
) -> None:
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors, dtype=np.uint8).reshape(-1, 3)

    fmt = "binary_little_endian" if binary else "ascii"
    header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
    header += [f"property float {c}" for c in "xyz"]
    if has_color:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_color:
                rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
                rec["xyz"] = points
                rec["rgb"] = colors
                f.write(rec.tobytes())
            else:
                f.write(points.astype("<f4").tobytes())
        else:
            if has_color:
                for p, c in zip(points, colors):
                    f.write(
                        f"{p[0]:g} {p[1]:g} {p[2]:g} {c[0]} {c[1]} {c[2]}\n".encode()
                    )
            else:
                for p in points:
                    f.write(f"{p[0]:g} {p[1]:g} {p[2]:g}\n".encode())


def read_ply(path: str) -> np.ndarray:
    """Minimal PLY reader (xyz only) for round-trip tests."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode().splitlines()
    n = 0
    binary = False
    props = 0
    for line in header:
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        elif line.startswith("format binary"):
            binary = True
        elif line.startswith("property"):
            props += 1
    body = data[head_end:]
    if binary:
        rec = np.frombuffer(body, dtype="<f4", count=n * 3).reshape(n, 3)
        return rec.copy()
    return np.array(
        [ln.split()[:3] for ln in body.decode().splitlines()[:n]], dtype=np.float32
    )
