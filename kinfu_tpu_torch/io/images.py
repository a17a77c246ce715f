"""PNG read and write for the dataset loaders (port of
kinfu_tpu/io/images.py), in numpy on the standard library's zlib.

The JAX package reads and writes PNGs through its native C++ codec or,
where that is not built, PIL; this module needs neither. It decodes the
chunk stream (IHDR, the IDATs joined, IEND; every CRC checked), inflates
it and undoes the five row filters (None, Sub, Up, Average, Paeth) for
bit depths 8 and 16 (big-endian) and colour types 0 (grey), 2 (RGB) and 6
(RGBA, alpha dropped). It writes filter 0 rows through `zlib.compress`:
depth as 16-bit grey, colour as 8-bit RGB. The four functions keep the JAX
names and return types: depth PNGs as uint16 [H, W], colour PNGs as uint8
[H, W, 3] RGB.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: samples a pixel, by colour type
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRC-checked, up to IEND."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def _paeth_row(filt: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Paeth filter of one row (sequential along the row)."""
    out = bytearray(filt.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(filt: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Average filter of one row (sequential along the row)."""
    out = bytearray(filt.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """[height, stride] uint8 scanlines from the inflated stream."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size < height * (stride + 1):
        raise ValueError("PNG image data is shorter than the header says")
    rows = rows[:height * (stride + 1)].reshape(height, stride + 1)
    kinds, filt = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of 0-4")
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        kind, f = int(kinds[r]), filt[r]
        if kind == 0:
            row = f
        elif kind == 1:  # Sub: a running sum along the row, per byte of a pixel
            row = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = f + prior
        elif kind == 3:
            row = _average_row(f, prior, bpp)
        else:
            row = _paeth_row(f, prior, bpp)
        out[r] = row
        prior = out[r]
    return out


def read_png(path: str) -> np.ndarray:
    """A PNG as [H, W, channels]: uint8 at bit depth 8, uint16 at 16."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not supported")
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth {depth} is not "
                         f"supported (grey, RGB or RGBA at 8 or 16 bits)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width, ch)
    return rows.reshape(height, width, ch)


def _write_png(path: str, img: np.ndarray, depth: int, ctype: int) -> None:
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(height, -1)
    if depth == 16:
        rows = rows.astype(">u2").view(np.uint8)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)  # filter 0

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as fh:
        fh.write(_SIGNATURE
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw.tobytes()))
                 + chunk(b"IEND", b""))


def read_depth_png(path: str) -> np.ndarray:
    """16-bit (or 8-bit) greyscale depth PNG -> uint16 [H, W] (channel 0 of
    a file with more channels)."""
    return read_png(path)[..., 0].astype(np.uint16)


def read_color_png(path: str) -> np.ndarray:
    """Colour PNG -> uint8 [H, W, 3] RGB (grey repeated, alpha dropped, 16-bit
    samples cut to their high byte)."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def write_depth_png(path: str, depth: np.ndarray) -> None:
    """uint16 [H, W] -> 16-bit greyscale PNG."""
    _write_png(path, np.asarray(depth, dtype=np.uint16), 16, 0)


def write_color_png(path: str, rgb: np.ndarray) -> None:
    """uint8 [H, W, 3] RGB -> 8-bit RGB PNG."""
    _write_png(path, np.asarray(rgb, dtype=np.uint8), 8, 2)
