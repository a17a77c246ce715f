"""The port's user-facing path from disk (kinfu_tpu_torch/io/images.py, data/,
utils/, cli.py) against the JAX package's.

  - the numpy + zlib PNG codec, both ways against the JAX reader and
    writer (PIL on this host): 16-bit grey, 8-bit grey, RGB and RGBA files,
    every row filter (files made by a small encoder here, with chosen
    filter bytes), and an interlaced file, which raises;
  - the bundled, TUM and ICL-NUIM loaders and the sensor layer against the
    JAX loaders on datasets written here: the same intrinsics, frames and
    timestamps;
  - `python -m kinfu_tpu_torch run` on the CPU over 4 frames of the
    synthetic orbit at 160x120 / 128^3: its poses file equals a
    KinFuSession's on the same PNG frames, its 3D view is the session's
    render_3d(); `eval` gives the JAX `eval`'s numbers; the flags of the
    unported modes raise, naming their ROADMAP item.

No JAX step is compiled: the JAX loaders and readers are numpy and PIL."""

import argparse
import dataclasses
import io
import json
import struct
import zlib
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from kinfu_tpu import cli as jcli
from kinfu_tpu.data import bundled as jbundled
from kinfu_tpu.data import icl_nuim as jicl
from kinfu_tpu.data import sensor as jsensor
from kinfu_tpu.data import synthetic as jsynthetic
from kinfu_tpu.data import tum as jtum
from kinfu_tpu.io import images as jimages
from kinfu_tpu_torch import cli
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data import bundled, icl_nuim, sensor, tum
from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.io import images
from kinfu_tpu_torch.io.poses import (
    read_poses_reference_format,
    write_poses_reference_format,
    write_poses_tum,
)
from kinfu_tpu_torch.pipeline.session import KinFuSession

torch.set_num_threads(2)

INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
INTR = Intrinsics(*INTR_T)
N = 4
#: the CLI's parameter flags for the CPU run: those of
#: tests/test_torch_session.py (2 levels, ICP (3, 4), 128^3). A 3-level
#: pyramid loses tracking on frame 2 at 160x120 in both packages: its
#: coarsest level is 40x30, too few pixels for the ICP to converge there.
CLI_FLAGS = ["--dim", "128", "--levels", "2", "--icp-iters", "3,4"]
PARAMS = KinFuParams(pyramid_height=2, icp_iters=(3, 4), volume_dims=(128, 128, 128),
                     fused_mode="on")


# ---- the PNG codec ---------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_png(img: np.ndarray, depth: int, ctype: int, filters, interlace: int = 0) -> bytes:
    """A PNG whose row r is filtered with filters[r % len(filters)]; the
    image data is split over two IDAT chunks."""
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    if depth == 16:
        rows = rows.astype(">u2").view(np.uint8)
    rows = rows.astype(np.int64)
    bpp = {0: 1, 2: 3, 6: 4}[ctype] * depth // 8
    prior = np.zeros(rows.shape[1], np.int64)
    raw = b""
    for r in range(h):
        x, kind = rows[r], filters[r % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pred = [0, a, prior, (a + prior) // 2, _paeth(a, prior, c)][kind]
        raw += bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()
        prior = x
    z = zlib.compress(raw)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + chunk(b"IDAT", z[:len(z) // 2]) + chunk(b"IDAT", z[len(z) // 2:])
            + chunk(b"IEND", b""))


def _image(channels: int, dtype, seed: int = 0) -> np.ndarray:
    """A 17x23 image: smooth gradients (where the filters predict well) with
    a random patch (where they do not)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:17, :23]
    top = np.iinfo(dtype).max
    img = np.stack([(x * 37 + y * 11 + k * 50) % (top + 1) for k in range(channels)], -1)
    img[4:9, 6:15] = rng.integers(0, top + 1, (5, 9, channels))
    return img.astype(dtype)


#: (name, bit depth, colour type, channels, sample type)
FORMATS = (
    ("grey16", 16, 0, 1, np.uint16),
    ("grey8", 8, 0, 1, np.uint8),
    ("rgb8", 8, 2, 3, np.uint8),
    ("rgba8", 8, 6, 4, np.uint8),
)
#: each filter alone, then all five mixed row by row
FILTERS = ((0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0))


@pytest.mark.parametrize("fmt", FORMATS, ids=[f[0] for f in FORMATS])
def test_png_reader_undoes_every_row_filter(tmp_path, fmt):
    """Files made with each row filter read back as the image they encode,
    in the port and in the JAX reader alike."""
    name, depth, ctype, ch, dtype = fmt
    img = _image(ch, dtype)
    for filters in FILTERS:
        path = str(tmp_path / f"{name}_{''.join(map(str, filters))}.png")
        with open(path, "wb") as f:
            f.write(_encode_png(img, depth, ctype, filters))
        np.testing.assert_array_equal(images.read_png(path), img.reshape(17, 23, ch))
        got_d = images.read_depth_png(path)
        assert got_d.dtype == np.uint16
        np.testing.assert_array_equal(got_d, img[..., 0])
        np.testing.assert_array_equal(got_d, jimages.read_depth_png(path))
        if depth == 8:
            got_c = images.read_color_png(path)
            assert got_c.dtype == np.uint8 and got_c.shape == (17, 23, 3)
            np.testing.assert_array_equal(got_c, jimages.read_color_png(path))


def test_png_round_trips_with_the_jax_package(tmp_path):
    """The port writes and the JAX reader reads; the JAX writer writes and
    the port reads: depth as 16-bit grey, colour as 8-bit RGB, and an RGBA
    file (alpha dropped)."""
    depth = _image(1, np.uint16)[..., 0]
    rgb = _image(3, np.uint8, seed=1)
    images.write_depth_png(str(tmp_path / "d.png"), depth)
    images.write_color_png(str(tmp_path / "c.png"), rgb)
    np.testing.assert_array_equal(jimages.read_depth_png(str(tmp_path / "d.png")), depth)
    np.testing.assert_array_equal(jimages.read_color_png(str(tmp_path / "c.png")), rgb)
    jimages.write_depth_png(str(tmp_path / "jd.png"), depth)
    jimages.write_color_png(str(tmp_path / "jc.png"), rgb)
    np.testing.assert_array_equal(images.read_depth_png(str(tmp_path / "jd.png")), depth)
    np.testing.assert_array_equal(images.read_color_png(str(tmp_path / "jc.png")), rgb)
    from PIL import Image

    rgba = _image(4, np.uint8, seed=2)
    Image.fromarray(rgba, "RGBA").save(str(tmp_path / "a.png"))
    got = images.read_color_png(str(tmp_path / "a.png"))
    np.testing.assert_array_equal(got, rgba[..., :3])
    np.testing.assert_array_equal(got, jimages.read_color_png(str(tmp_path / "a.png")))


def test_png_reader_refuses_what_it_cannot_read(tmp_path):
    """An interlaced file, a corrupted chunk and a palette file raise."""
    img = _image(3, np.uint8)
    data = _encode_png(img, 8, 2, (0,), interlace=1)
    (tmp_path / "i.png").write_bytes(data)
    with pytest.raises(ValueError, match="interlaced"):
        images.read_color_png(str(tmp_path / "i.png"))
    bad = bytearray(_encode_png(img, 8, 2, (0,)))
    bad[45] ^= 0xFF  # a byte of the first IDAT's data
    (tmp_path / "b.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        images.read_color_png(str(tmp_path / "b.png"))
    pal = bytearray(_encode_png(img[..., 0], 8, 0, (0,)))
    pal[25] = 3  # colour type in IHDR: palette
    pal[29:33] = struct.pack(">I", zlib.crc32(bytes(pal[12:29])))
    (tmp_path / "p.png").write_bytes(bytes(pal))
    with pytest.raises(ValueError, match="colour type 3"):
        images.read_depth_png(str(tmp_path / "p.png"))


# ---- datasets ---------------------------------------------------------------


def _orbit(n, intr=INTR):
    scene = default_test_scene()
    traj = make_orbit_trajectory(n, angle_step_deg=0.3)
    return [scene.render_frame(T, intr) for T in traj], traj


def _write_bundled(root, n):
    (root / "color").mkdir(parents=True)
    (root / "depth").mkdir()
    frames, traj = _orbit(n)
    for i, (depth_mm, color) in enumerate(frames):
        images.write_color_png(str(root / "color" / f"{i:04d}.png"), color)
        images.write_depth_png(str(root / "depth" / f"{i:04d}.png"),
                               np.clip(depth_mm, 0, 65535).astype(np.uint16))
    (root / "intr.txt").write_text(f"{INTR.fx} {INTR.cx} {INTR.fy} {INTR.cy} 1000\n")
    return str(root), traj


def _write_tum(root, n):
    """A TUM-format sequence: depth 5 ms after colour, one colour frame with
    no depth partner (the association drops it), 1/5000 m depth units."""
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    frames, traj = _orbit(n)
    t0 = 1305031102.175304
    rgb_lines, depth_lines, stamps = ["# color images"], ["# depth images"], []
    for i, (depth_mm, color) in enumerate(frames):
        ts = t0 + i / 30.0
        stamps.append(ts)
        images.write_color_png(str(root / f"rgb/{ts:.6f}.png"), color)
        images.write_depth_png(str(root / f"depth/{ts + 0.005:.6f}.png"),
                               np.clip(depth_mm * 5.0, 0, 65535).astype(np.uint16))
        rgb_lines.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        depth_lines.append(f"{ts + 0.005:.6f} depth/{ts + 0.005:.6f}.png")
    rgb_lines.append(f"{t0 + n / 30.0 + 1.0:.6f} rgb/orphan.png")
    (root / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    write_poses_tum(str(root / "groundtruth.txt"), traj, stamps)
    return str(root)


def _same_intrinsics(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _same_frames(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        for got, want in zip(port_ds[i], jax_ds[i]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_bundled_dataset_matches_jax(tmp_path):
    path, _ = _write_bundled(tmp_path / "seq", 3)
    ds, jds = bundled.BundledDataset(path), jbundled.BundledDataset(path)
    _same_intrinsics(ds.intrinsics, jds.intrinsics)
    assert ds.intrinsics.depth_scale == pytest.approx(0.001)
    _same_frames(ds, jds)
    with pytest.raises(FileNotFoundError, match="no camera"):
        bundled.BundledDataset(str(tmp_path / "missing"))


@pytest.mark.parametrize("name", ["rgbd_dataset_freiburg1_xyz", "rgbd_dataset_freiburg2_desk"])
def test_tum_dataset_matches_jax(tmp_path, name):
    path = _write_tum(tmp_path / name, 3)
    ds, jds = tum.TUMDataset(path), jtum.TUMDataset(path)
    _same_intrinsics(ds.intrinsics, jds.intrinsics)
    assert ds.pairs == jds.pairs and len(ds) == 3
    assert [ds.timestamp(i) for i in range(3)] == [jds.timestamp(i) for i in range(3)]
    np.testing.assert_array_equal(ds.gt_timestamps, jds.gt_timestamps)
    for a, b in zip(ds.gt_poses, jds.gt_poses):
        np.testing.assert_array_equal(a, b)
    _same_frames(ds, jds)
    a = [(0.0, "a0"), (0.10, "a1"), (0.20, "a2"), (0.201, "a3")]
    b = [(0.004, "b0"), (0.115, "b1"), (0.5, "b2"), (0.2005, "b3")]
    assert tum.associate(a, b) == jtum.associate(a, b)
    assert tum.associate(a, b, max_dt=0.2) == jtum.associate(a, b, max_dt=0.2)


def test_icl_nuim_dataset_matches_jax(tmp_path):
    path = _write_tum(tmp_path / "living_room_traj2_frei_png", 2)
    ds, jds = icl_nuim.ICLNuimDataset(path), jicl.ICLNuimDataset(path)
    _same_intrinsics(ds.intrinsics, jds.intrinsics)
    _same_intrinsics(icl_nuim.ICL_INTRINSICS, jicl.ICL_INTRINSICS)
    _same_frames(ds, jds)


def test_sensors_match_jax(tmp_path):
    """DatasetSensor replays a folder as the JAX one does, SyntheticSensor
    renders the same frames, and the live backends raise the JAX error."""
    path, traj = _write_bundled(tmp_path / "seq", 2)
    s, js = sensor.DatasetSensor(path), jsensor.DatasetSensor(path)
    _same_intrinsics(s.intrinsics, js.intrinsics)
    got, want = list(s), list(js)
    assert len(got) == len(want) == 2 and s.get_frame() is None
    for (c, d), (jc, jd) in zip(got, want):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(d, jd)
    s.reset()
    np.testing.assert_array_equal(s.get_frame()[1], want[0][1])
    assert isinstance(sensor.open_sensor(path), sensor.DatasetSensor)
    for live in ("kinect2", "realsense"):
        with pytest.raises(RuntimeError) as err:
            sensor.open_sensor(live)
        with pytest.raises(RuntimeError) as jerr:
            jsensor.open_sensor(live)
        assert str(err.value) == str(jerr.value) and "vendor SDK" in str(err.value)
    from kinfu_tpu.geometry.intrinsics import Intrinsics as JIntr

    syn = sensor.SyntheticSensor(default_test_scene(), traj, INTR)
    jsyn = jsensor.SyntheticSensor(jsynthetic.default_test_scene(), traj, JIntr(*INTR_T))
    for (c, d), (jc, jd) in zip(syn, jsyn):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(d, jd)


def test_profiling_helpers_on_the_cpu(tmp_path):
    """utils/profiling.py: `trace` writes a Chrome trace of the block, and
    `device_time` returns the best of its timed calls (the host clock for
    CPU tensors) and the last result."""
    from kinfu_tpu_torch.utils import profiling

    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "trace")):
        (x @ x).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    secs, out = profiling.device_time(torch.matmul, x, x, reps=2)
    assert 0 < secs < 10 and torch.equal(out, x @ x)


# ---- the CLI ----------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """`run` on the CPU over 4 PNG frames, then a KinFuSession over the same
    frames; both write their poses and 3D views."""
    root = tmp_path_factory.mktemp("cli")
    data, traj = _write_bundled(root / "seq", N)
    out = root / "out"
    out.mkdir()
    rc = cli.main(["run", "--data", data, "--device", "cpu", "--frames", str(N), *CLI_FLAGS,
                   "--save-poses", str(out / "poses.txt"), "--save-ply", str(out / "cloud.ply"),
                   "--metrics", str(out / "metrics.jsonl"), "--dump-3d", str(out / "3d"),
                   "--quiet"])
    ds = bundled.BundledDataset(data)
    sess = KinFuSession(ds.intrinsics, PARAMS, device="cpu")
    oks = [sess.pipeline(*ds[i]) for i in range(N)]
    sess.save_poses(str(out / "session_poses.txt"))
    gt = [np.linalg.inv(traj[0]) @ T for T in traj]
    write_poses_reference_format(str(out / "gt.txt"), gt)
    write_poses_tum(str(out / "gt_tum.txt"), gt)
    return rc, out, sess, oks


def test_cli_run_equals_the_session(cli_run):
    rc, out, sess, oks = cli_run
    assert rc == 0 and all(oks)
    assert (out / "poses.txt").read_text() == (out / "session_poses.txt").read_text()
    assert len(read_poses_reference_format(str(out / "poses.txt"))) == N
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["frame"] for r in rows] == list(range(N)) and all(r["tracking_ok"] for r in rows)
    from kinfu_tpu_torch.io.ply import read_ply

    np.testing.assert_allclose(read_ply(str(out / "cloud.ply")), sess.extract_pointcloud(),
                               rtol=1e-5, atol=1e-6)


def test_save_3d_writes_the_render(cli_run):
    """The CLI's --dump-3d goes through KinFuSession.save_3d: its PNG reads
    back as the same session's render_3d()."""
    _, out, sess, _ = cli_run
    view = images.read_color_png(str(out / "3d" / "3d_final.png"))
    np.testing.assert_array_equal(view, sess.render_3d())
    assert view.any()


@pytest.mark.parametrize("fmt", ["ref", "tum"])
def test_cli_eval_matches_jax(cli_run, fmt):
    _, out, _, _ = cli_run
    gt = out / ("gt.txt" if fmt == "ref" else "gt_tum.txt")
    argv = ["eval", "--est", str(out / "poses.txt"), "--gt", str(gt)]
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(argv) == 0
    got = json.loads(buf.getvalue())
    buf = io.StringIO()
    with redirect_stdout(buf):
        jcli.cmd_eval(argparse.Namespace(est=str(out / "poses.txt"), gt=str(gt),
                                         est_format="auto", gt_format="auto", rpe_delta=1,
                                         no_align=False))
    want = json.loads(buf.getvalue())
    assert got.keys() == want.keys() and got["n_est"] == N
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    assert got["ate_rmse_m"] < 2e-3


@pytest.mark.parametrize("argv, item", [
    (["run", "--data", "unused", "--device", "cpu", "--streaming"], "item 11"),
    (["run", "--data", "unused", "--device", "cpu", "--relocalize"], "item 10"),
    (["run", "--data", "unused", "--device", "cpu", "--pose-graph"], "item 10"),
    (["sweep"], "item 12"),
    (["bench"], "item 7"),
], ids=["streaming", "relocalize", "pose-graph", "sweep", "bench"])
def test_cli_unported_modes_raise(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, {item}"):
        cli.main(argv)


def test_cli_runs_on_the_card_by_default(monkeypatch, tmp_path):
    """Without CUDA, `run` without --device raises instead of running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, _ = _write_bundled(tmp_path / "seq", 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", "--data", path, "--quiet"])
