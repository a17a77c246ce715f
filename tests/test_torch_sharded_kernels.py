"""The shard forms of the port's kernels against the JAX package, on one
process (no mesh): a rank's slab is cut from the whole volume here.

  - the frame sets `face_frames(shard_dim)` and `warp_dims_ok(shape,
    shard_dim)` against JAX's, for shard_dim None, 0 and 1;
  - K4's shard form (`sweep_rays_plain` with a `Shard`) on each of two
    ranks' halo-padded slabs against the interpret-mode
    `_sweep_face_rays(..., dims_global, plane0, row0)`: a plane-sharded
    face (+z, Z slabs), a flipped one (-z), and a row-sharded face (+x,
    Z slabs in the (2, 0, 1) frame and Y slabs in the (2, 1, 0) frame).
    Hits equal; back events by the rule of test_torch_raycast.py (they
    differ only in where an outward exit is recorded); and the ranks'
    minimum gives the unsharded march's hits wherever a hit comes before
    its back event, which is all the shading reads (a rank past an earlier
    back event may find a later hit there); and K4's per-ray interval of a
    slab (`ray_plane_interval` with the shard) changes no bit of it.

K3's shard form and the `integrate` dispatcher's fold are held against JAX
in tests/test_torch_sharded_integrate.py. The JAX side runs without FMA
contraction (tests/torch_jaxref.py)."""

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose, rodrigues
from kinfu_tpu_torch.ops import face_raycast as tfr
from kinfu_tpu_torch.ops import facewarp as tfw
from kinfu_tpu_torch.ops.face_integrate import prime
from kinfu_tpu_torch.parallel.sharded import HALO8, ray_shard

torch.set_num_threads(2)

DIM = 128
RANKS = 2
#: tests/test_torch_raycast.py's sphere volume and face grid
RAY_INTR = Intrinsics(64, 48, 53.0, 53.0, 31.5, 23.5)
RAY_PARAMS = KinFuParams(pyramid_height=1, icp_iters=(4,), volume_dims=(DIM,) * 3)
RAY_SPEC_T = (256, 104.0)
RAY_SPEC = tfr.RaySpec(*RAY_SPEC_T)
SPHERE_C = np.array([1.5, 1.5, 1.8], np.float32)
SPHERE_R = 0.6


def _sphere_tsdf() -> np.ndarray:
    g = (np.arange(DIM) * RAY_PARAMS.voxel_size[0]).astype(np.float32)
    Z, Y, X = np.meshgrid(g, g, g, indexing="ij")
    d = np.sqrt((X - SPHERE_C[0]) ** 2 + (Y - SPHERE_C[1]) ** 2
                + (Z - SPHERE_C[2]) ** 2) - SPHERE_R
    t = np.clip(d / RAY_PARAMS.trunc_dist, -1.0, 1.0).astype(np.float32)
    return np.trunc(np.clip(t * np.float32(32767.0), -32767.0, 32767.0)).astype(np.int16)


def _padded(tsdf: np.ndarray, sd: int, rank: int) -> np.ndarray:
    """Rank `rank`'s slab along `sd` with HALO8 rows of its neighbours and
    zero rows past the volume, as `parallel/mesh.py::halo_exchange` gives
    it."""
    L = tsdf.shape[sd]
    Ll = L // RANKS
    lo, hi = rank * Ll - HALO8, (rank + 1) * Ll + HALO8
    pad = [(0, 0)] * 3
    pad[sd] = (max(0, -lo), max(0, hi - L))
    return np.pad(np.take(tsdf, range(max(lo, 0), min(hi, L)), axis=sd), pad)


#: (name, rotation vector, camera centre in volume coords, face, shard dim)
RAY_CASES = (
    ("plane +z", (0.0, 0.0, 0.0), (1.5, 1.5, 0.2), "+z", 0),
    ("plane flipped -z", (0.0, np.pi, 0.0), (1.5, 1.5, 2.9), "-z", 0),
    ("row +x (2,0,1)", (0.0, np.pi / 2, 0.0), (0.2, 1.4, 1.6), "+x", 0),
    ("row +x (2,1,0)", (0.0, np.pi / 2, 0.0), (0.2, 1.4, 1.6), "+x", 1),
)


def _ray_inputs():
    tsdf = _sphere_tsdf()
    out = []
    for name, rvec, t, face, sd in RAY_CASES:
        frame = next(f for f in tfw.face_frames(sd) if f.name == face)
        c2v = Pose(rodrigues(torch.tensor(rvec, dtype=torch.float32)),
                   torch.tensor(t, dtype=torch.float32))
        f = [fr.name for fr in tfw.face_frames()].index(face)
        org_p = tfr.composite_params(c2v, RAY_PARAMS, sd)[f, 9:12]
        vs_p = tfw.primed_voxel_size(frame, RAY_PARAMS.voxel_size)
        for r in range(RANKS):
            padded = _padded(tsdf, sd, r)
            sh = ray_shard(frame, padded.shape, DIM, DIM // RANKS, r * DIM // RANKS, sd)
            out.append(dict(case=name, rank=r, frame=frame, tsdf=tsdf, padded=padded,
                            org_p=org_p, vs_p=vs_p, shard=sh))
    return out


@pytest.fixture(scope="module")
def rays():
    items = _ray_inputs()
    refs = torch_jaxref.run(
        ("sweep_face_rays_shard", dict(
            tsdf_p=prime(torch.as_tensor(it["padded"]), it["frame"]).numpy(),
            origin_p=it["org_p"].numpy(), vs_p=it["vs_p"], spec=RAY_SPEC_T,
            dims_global=(it["shard"].Zg, it["shard"].Yg, DIM), plane0=it["shard"].plane0,
            row0=it["shard"].row0))
        for it in items)
    return [dict(it, ref=r) for it, r in zip(items, refs)]


@pytest.mark.parametrize("shard_dim", [None, 0, 1])
def test_face_frames_match_jax(shard_dim):
    from kinfu_tpu.ops import facewarp as jfw

    for tf, jf in zip(tfw.face_frames(shard_dim), jfw.face_frames(shard_dim)):
        assert (tf.name, tf.axes, tf.flip, tf.gt_x, tf.gt_y) == (
            jf.name, jf.axes, jf.flip, jf.gt_x, jf.gt_y)
        np.testing.assert_array_equal(tf.D, jf.D)
    for shape in [(128, 128, 128), (64, 128, 128), (128, 64, 128), (128, 128, 64),
                  (96, 128, 256), (128, 40, 128), (60, 128, 128)]:
        assert tfw.warp_dims_ok(shape, shard_dim) == jfw.warp_dims_ok(shape, shard_dim), shape


def test_sweep_rays_shard_matches_tpu_sweep(rays):
    """Each rank's march of its halo-padded slab gives the JAX shard
    sweep's hits; the back events differ only in the exits that the TPU
    sweep's work lists record later or never."""
    for it in rays:
        prm = tfr.ray_params(it["org_p"], it["vs_p"], RAY_SPEC, torch.tensor(True))
        hit, back = tfr.sweep_rays(torch.as_tensor(it["padded"]), it["frame"], prm, RAY_SPEC,
                                   it["shard"])
        hit, back, ref = hit.numpy(), back.numpy(), it["ref"]
        tag = f"{it['case']} rank {it['rank']} {it['shard']}"
        ref_hit, ref_back = ref
        np.testing.assert_array_equal(hit, ref_hit, err_msg=f"{tag} hit")
        np.testing.assert_array_equal(hit < back, ref_hit < ref_back, err_msg=f"{tag} mask")
        assert (back <= ref_back).all(), tag
        np.testing.assert_array_equal(back[hit < 1e30], ref_back[hit < 1e30],
                                      err_msg=f"{tag} back of hit rays")


def test_sweep_rays_shards_compose_to_the_whole(rays):
    """The ranks' minimum of hit and back gives the unsharded march's hit
    wherever it comes before the back event (the field the shading reads),
    on every case."""
    for case, *_ in RAY_CASES:
        items = [it for it in rays if it["case"] == case]
        it = items[0]
        prm = tfr.ray_params(it["org_p"], it["vs_p"], RAY_SPEC, torch.tensor(True))
        hw, bw = tfr.sweep_rays_plain(torch.as_tensor(it["tsdf"]), it["frame"], prm, RAY_SPEC)
        hc = torch.stack([torch.as_tensor(i["ref"][0]) for i in items]).amin(0)
        bc = torch.stack([torch.as_tensor(i["ref"][1]) for i in items]).amin(0)
        tw = torch.where((hw < bw) & (hw < 1e30), hw, 1e30)
        tc = torch.where((hc < bc) & (hc < 1e30), hc, 1e30)
        assert torch.equal(tw, tc), (case, int((tw != tc).sum()))
        assert int((tw < 1e30).sum()) > 2000, case
        # the sphere straddles the Y halves: both ranks of a row-sharded face
        # find hits
        with_hits = [int((i["ref"][0] < 1e30).sum()) > 0 for i in items]
        assert all(with_hits) if case.startswith("row") else any(with_hits), case


def _march_run(padded, frame, prm, shard, z_first, v_last, z_last):
    """K4's shard form as csrc/sweep_rays.cu marches: each ray's valid run
    [z_first, v_last] of local planes, sampled at global t without bounds
    or exit tests (a row is global, less row0 in the buffer), then, for a
    ray it leaves unresolved, the exit at z_last where z_last lies past the
    run. (hit_t, back_t)."""
    from kinfu_tpu_torch.numerics import rint_index
    from kinfu_tpu_torch.volume.tsdf import SHORTMAX

    t_p = prime(torch.as_tensor(padded), frame)
    Zl, Yl, Xp = t_p.shape
    F = RAY_SPEC.size
    ox, oy, oz, vsx, vsy, vsz, f, c = (prm[i] for i in range(8))
    pix = torch.arange(F, dtype=torch.float32)
    dy = ((pix - c) * (1.0 / f))[:, None]
    dx = ((pix - c) * (1.0 / f))[None, :]
    ht, bt = torch.full((F, F), 1e30), torch.full((F, F), 1e30)
    fp = torch.full((F, F), float("nan"))
    flat = t_p.reshape(-1)
    for zl in range(Zl):
        t_m = float(shard.plane0 + zl) * vsz - oz
        ts = torch.clamp(t_m, min=1e-6)
        yi = rint_index((oy + dy * ts) * (1.0 / vsy)) - shard.row0
        xi = rint_index((ox + dx * ts) * (1.0 / vsx))
        run = (ht >= 1e30) & (bt >= 1e30) & (z_first <= zl) & (zl <= v_last)
        f_new = flat[(zl * Yl + yi.clamp(0, Yl - 1)) * Xp + xi.clamp(0, Xp - 1)].float() * (
            1.0 / SHORTMAX)
        front = run & (fp > 0.0) & (f_new < 0.0)
        back = run & (fp < 0.0) & (f_new > 0.0)
        denom = fp - f_new
        frac = fp / torch.where(denom.abs() < 1e-30, torch.full_like(denom, 1e-30), denom)
        ht = torch.where(front, t_m - vsz + vsz * frac, ht)
        bt = torch.where(back, t_m, bt)
        fp = torch.where(run, f_new, fp)
    exit_t = (z_last + shard.plane0).float() * vsz - oz
    left = (ht >= 1e30) & (bt >= 1e30) & (z_last > v_last)
    return ht, torch.where(left, exit_t, bt)


def test_ray_interval_shard_form_changes_nothing(rays):
    """K4's shard form marches each ray's `ray_plane_interval` of the slab:
    the valid run, then the exit, gives the full slab march's hit and back
    bits on every case and rank; a gated-off face gives empty intervals."""
    for it in rays:
        tag = f"{it['case']} rank {it['rank']}"
        frame, sh = it["frame"], it["shard"]
        dims_p = tuple(it["padded"].shape[a] for a in frame.axes)
        prm = tfr.ray_params(it["org_p"], it["vs_p"], RAY_SPEC, torch.tensor(True))
        z_first, z_last, v_last = tfr.ray_plane_interval(prm, frame, dims_p, RAY_SPEC, sh)
        ht, bt = tfr.sweep_rays_plain(torch.as_tensor(it["padded"]), frame, prm, RAY_SPEC, sh)
        h, b = _march_run(it["padded"], frame, prm, sh, z_first, v_last, z_last)
        assert torch.equal(h.view(torch.int32), ht.view(torch.int32)), f"{tag} hit"
        assert torch.equal(b.view(torch.int32), bt.view(torch.int32)), f"{tag} back"
        assert bool((z_last >= 0).any()), tag
        off = tfr.ray_params(it["org_p"], it["vs_p"], RAY_SPEC, torch.tensor(False))
        lo, hi, _ = tfr.ray_plane_interval(off, frame, dims_p, RAY_SPEC, sh)
        assert bool((lo > hi).all()), tag
