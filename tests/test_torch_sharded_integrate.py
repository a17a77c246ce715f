"""K3's shard form and the `integrate` dispatcher's shard-origin fold
against the JAX package, on one process (no mesh): a rank's slab is cut
from the whole volume here.

  - K3's shard form (`integrate_warped` on a slab with the slab origin
    folded into the pose, `shard_dim` frames) against the JAX dispatcher
    on the same slab (its fold and `_sweep_face`), bit for bit, on both
    slabs of Z and of Y sharding, the +x face in the (2, 1, 0) frame
    included;
  - the gather pass on the whole 128^3 volume and on a Z slab against the
    JAX dispatcher, bit for bit;
  - the `integrate` dispatcher's fold: each slab's gather pass with its
    `z_offset` against JAX's on the same slab, bit for bit, and the stacked
    slabs against the JAX dispatcher on the whole volume: bit for bit for
    the gather pass (the offsets and voxel sizes here are exact in
    float32), within tests/test_distributed.py's tolerances for the warped
    sweeps (the fold moves the camera by a rounded offset).

The JAX side runs without FMA contraction (tests/torch_jaxref.py); the
gather references with at most SSE4.2."""

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import default_test_scene
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
from kinfu_tpu_torch.ops import facewarp as tfw
from kinfu_tpu_torch.ops.face_integrate import faces_needed, integrate_warped
from kinfu_tpu_torch.ops.facewarp import FaceSpec
from kinfu_tpu_torch.volume.integrate import fold_shard_origin, integrate
from kinfu_tpu_torch.volume.tsdf import TSDFVolume

torch.set_num_threads(2)

DIM = 128
RANKS = 2
#: tests/test_torch_integrate.py's frames and face stacks
INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
INTR = Intrinsics(*INTR_T)
CFG = dict(pyramid_height=1, icp_iters=(4,), volume_dims=(DIM,) * 3)
SPEC_T = (256, 104.0, 6)
#: the fold's tolerance against the whole volume (test_distributed.py)
TSDF_TOL, TSDF_SHARE, WEIGHT_SHARE = 2e-2, 2e-3, 2e-3


def _pose(ry_deg: float, t=(0.1, -0.05, 0.2)) -> np.ndarray:
    a = np.radians(ry_deg)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T[:3, 3] = t
    return T


#: +z and +x live (the faces_needed flags of this pose)
T_TILTED = _pose(40.0)


def _prior(seed: int, dim: int):
    rng = np.random.default_rng(seed)
    shape = (dim,) * 3
    return (rng.integers(-32767, 32768, shape).astype(np.int16),
            rng.integers(0, 65, shape).astype(np.int16),
            rng.integers(0, 1 << 24, shape).astype(np.int32))


def _frame():
    depth, color = default_test_scene().render_frame(T_TILTED, INTR)
    return (depth * np.float32(0.001)).astype(np.float32), color


def _vol2cam(params):
    cam = pose_from_matrix(torch.as_tensor(T_TILTED))
    return compose(inverse(cam), pose_from_matrix(torch.as_tensor(params.volume_pose)))


def _slab(a: np.ndarray, sd: int, r: int) -> np.ndarray:
    Ll = a.shape[sd] // RANKS
    return np.ascontiguousarray(np.take(a, range(r * Ll, (r + 1) * Ll), axis=sd))


#: per integrate mode: its configuration (the warped sweeps at the least
#: cube `warp_dims_ok` admits; the gather pass at test_torch_volume.py's
#: 64^3 over 2 m, whose voxel size is a power of two, and at 128^3 over
#: 3 m, whose voxel size is not) and the JAX reference's instruction set
MODES = {
    "warped": (dict(CFG, integrate_mode="warped"), "AVX"),
    "gather": (dict(pyramid_height=1, icp_iters=(4,), volume_dims=(64,) * 3,
                    volume_range=(2.0, 2.0, 2.0), volume_origin=(-1.0, -1.0, 0.5),
                    integrate_mode="gather"), "SSE4_2"),
    "gather_128": (dict(CFG, integrate_mode="gather"), "SSE4_2"),
}


@pytest.fixture(scope="module")
def folds():
    """Per mode: the JAX dispatcher on the whole volume and on each slab of
    both shard dims, from one random prior; the calls run in parallel
    child processes."""
    depth_m, color = _frame()
    priors, jobs = {}, {}
    for mode, (cfg, isa) in MODES.items():
        prior = priors[mode] = _prior(3, cfg["volume_dims"][0])
        v2c = _vol2cam(KinFuParams(**cfg))
        base = dict(depth_m=depth_m, color_rgb=color, R=v2c.R.numpy(), t=v2c.t.numpy(),
                    intr=INTR_T, params_kw=tuple(cfg.items()),
                    spec=SPEC_T if mode == "warped" else None)
        calls = [dict(base, tsdf=prior[0], weight=prior[1], color=prior[2], z_offset=0,
                      shard_dim=0)]
        for sd in (0, 1):
            for r in range(RANKS):
                sl = [_slab(a, sd, r) for a in prior]
                calls.append(dict(base, tsdf=sl[0], weight=sl[1], color=sl[2],
                                  z_offset=r * prior[0].shape[sd] // RANKS, shard_dim=sd))
        # the warped calls are slow in interpret mode: a child each
        groups = [[c] for c in calls] if mode == "warped" else [calls]
        jobs[mode] = [torch_jaxref.start([("integrate_shard", c) for c in g], isa=isa)
                      for g in groups]
    return priors, {mode: [r for job in js for r in job.result()] for mode, js in jobs.items()}


def _port_slab(prior, sd: int, r: int, mode: str, monkeypatch):
    """The port's dispatcher on rank r's slab, in `mode` (warped with the
    test's face spec)."""
    from kinfu_tpu_torch.ops import face_integrate

    params = KinFuParams(**MODES[mode][0])
    monkeypatch.setattr(face_integrate, "default_face_spec", lambda: FaceSpec(*SPEC_T))
    depth_m, color = _frame()
    vol = TSDFVolume(*(torch.as_tensor(_slab(a, sd, r)) for a in prior))
    integrate(vol, torch.as_tensor(depth_m), torch.as_tensor(color), _vol2cam(params), INTR,
              params, z_offset=r * prior[0].shape[sd] // RANKS, shard_dim=sd)
    return vol


@pytest.mark.parametrize("shard_dim", [0, 1])
def test_k3_shard_form_matches_jax(folds, shard_dim, monkeypatch):
    """K3's shard form, through the warped dispatcher: each slab, its
    origin folded into the pose and the `shard_dim` frames (+x in (2, 1, 0)
    for Y slabs), bit for bit against JAX's fold and `_sweep_face` on the
    same slab; and the fold is `fold_shard_origin`'s, which the sharded
    step gives K2 and K3."""
    priors, out = folds
    prior = priors["warped"]
    params = KinFuParams(**MODES["warped"][0])
    gates = faces_needed(_vol2cam(params), INTR)
    assert [fr.name for f, fr in enumerate(tfw.face_frames()) if gates[f]] == ["+z", "+x"]
    for r in range(RANKS):
        vol = _port_slab(prior, shard_dim, r, "warped", monkeypatch)
        want = out["warped"][1 + 2 * shard_dim + r]
        for name, got, w in zip(("tsdf", "weight", "colour"), vol, want):
            np.testing.assert_array_equal(got.numpy(), w, err_msg=f"rank {r} {name}")
        assert int((vol.weight.numpy() != _slab(prior[1], shard_dim, r)).sum()) > 5000
        # the same sweeps, called as the sharded step calls them
        direct = TSDFVolume(*(torch.as_tensor(_slab(a, shard_dim, r)) for a in prior))
        depth_m, color = _frame()
        integrate_warped(direct, torch.as_tensor(depth_m), torch.as_tensor(color),
                         fold_shard_origin(_vol2cam(params), r * DIM // RANKS, shard_dim,
                                           params.voxel_size),
                         INTR, params, spec=FaceSpec(*SPEC_T), shard_dim=shard_dim)
        for a, b in zip(direct, vol):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode", list(MODES))
def test_integrate_fold_matches_jax(folds, mode, monkeypatch):
    """The dispatcher's `z_offset` / `shard_dim` on every slab against
    JAX's on the same slab, bit for bit; the slabs stacked against the JAX
    dispatcher on the whole volume."""
    priors, out = folds
    prior = priors[mode]
    whole = out[mode][0]
    for sd in (0, 1):
        slabs = []
        for r in range(RANKS):
            vol = _port_slab(prior, sd, r, mode, monkeypatch)
            want = out[mode][1 + 2 * sd + r]
            for name, got, w in zip(("tsdf", "weight", "colour"), vol, want):
                np.testing.assert_array_equal(got.numpy(), w, err_msg=f"{sd} {r} {name}")
            slabs.append(vol)
        stacked = [torch.cat([s[k] for s in slabs], dim=sd).numpy() for k in range(3)]
        assert (stacked[1] != prior[1]).sum() > 5000
        if MODES[mode][0]["integrate_mode"] == "gather":
            for name, got, w in zip(("tsdf", "weight", "colour"), stacked, whole):
                np.testing.assert_array_equal(got, w, err_msg=f"shard dim {sd}: {name}")
        else:
            mismatch = np.abs(stacked[0].astype(np.float32) - whole[0]) / 32767.0 > TSDF_TOL
            assert mismatch.mean() < TSDF_SHARE, (sd, mismatch.mean())
            assert (stacked[1] != whole[1]).mean() < WEIGHT_SHARE, sd


def test_gather_integrate_matches_jax_at_128(folds):
    """`integrate_gather` on the whole 128^3 volume of the random prior and
    on its [64, 128, 128] Z slab at offset 0, bit for bit against the JAX
    dispatcher. At 3 m over 128 voxels the voxel size is not a power of
    two, so this holds only because the port computes the x and y terms of
    the camera-frame position as XLA reassociates them, (R * vs) * index
    (a slab's step here was one TSDF step off on 4 voxels before)."""
    from kinfu_tpu_torch.volume.integrate import integrate_gather

    priors, out = folds
    prior = priors["gather_128"]
    params = KinFuParams(**MODES["gather_128"][0])
    depth_m, color = _frame()
    for name, arrays, want in (("whole", prior, out["gather_128"][0]),
                               ("slab", [_slab(a, 0, 0) for a in prior],
                                out["gather_128"][1])):
        vol = TSDFVolume(*(torch.as_tensor(a.copy()) for a in arrays))
        integrate_gather(vol, torch.as_tensor(depth_m), torch.as_tensor(color),
                         _vol2cam(params), INTR, params)
        assert (vol.weight.numpy() != arrays[1]).sum() > 50000, name
        for field, got, w in zip(("tsdf", "weight", "colour"), vol, want):
            np.testing.assert_array_equal(got.numpy(), w, err_msg=f"{name} {field}")
