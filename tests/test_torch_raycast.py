"""The raycast kernels' plain versions against the JAX package, stage by
stage, on the sphere volumes of test_pallas_raycast.py (128^3, 256 px
face):

  - K4 `sweep_rays_plain` (a full march of every face ray through every
    plane) against the interpret-mode `_sweep_face_rays` (the TPU sweep
    with its occupancy pooling and slab/tile work lists): equal hits, and
    back events that differ only in where an outward exit is recorded;
  - `face_fields` against `_face_fields` on the same events;
  - K5 `resample_face_plain` against the interpret-mode `_resample_face`
    on the same face fields: equal.

Each stage gets the JAX stage's inputs, so a difference is that stage's
own. The JAX side runs without FMA contraction (tests/torch_jaxref.py)."""

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose, inverse, rodrigues
from kinfu_tpu_torch.ops import face_raycast as tfr
from kinfu_tpu_torch.ops.face_integrate import faces_needed, prime, unprime
from kinfu_tpu_torch.ops.facewarp import face_frames, face_params

torch.set_num_threads(2)

DIM = 128
INTR_T = (64, 48, 53.0, 53.0, 31.5, 23.5)
INTR = Intrinsics(*INTR_T)
PARAMS = KinFuParams(pyramid_height=1, icp_iters=(4,), volume_dims=(DIM,) * 3)
SPEC_T = (256, 104.0)
SPEC = tfr.RaySpec(*SPEC_T)
SPHERE_C = np.array([1.5, 1.5, 1.8], np.float32)
SPHERE_R = 0.6


def _sphere_tsdf(with_floor: bool) -> np.ndarray:
    g = (np.arange(DIM) * PARAMS.voxel_size[0]).astype(np.float32)
    Z, Y, X = np.meshgrid(g, g, g, indexing="ij")
    d = np.sqrt((X - SPHERE_C[0]) ** 2 + (Y - SPHERE_C[1]) ** 2
                + (Z - SPHERE_C[2]) ** 2) - SPHERE_R
    if with_floor:
        d = np.minimum(d, 2.6 - Y)
    t = np.clip(d / PARAMS.trunc_dist, -1.0, 1.0).astype(np.float32)
    return np.trunc(np.clip(t * np.float32(32767.0), -32767.0, 32767.0)).astype(np.int16)


def _cam2vol(rvec, t) -> Pose:
    return Pose(rodrigues(torch.tensor(rvec, dtype=torch.float32)),
                torch.tensor(t, dtype=torch.float32))


#: (name, floor, rotation vector, camera centre in volume coords)
CASES = (
    ("axis", False, (0.0, 0.0, 0.0), (1.5, 1.5, 0.2)),
    ("tilted", False, (0.0, np.deg2rad(30.0), 0.0), (0.7, 1.5, 0.4)),
    ("backward", False, (0.0, np.pi, 0.0), (1.5, 1.5, 2.9)),
    ("oblique", True, (np.deg2rad(25.0), np.deg2rad(55.0), 0.0), (0.4, 1.0, 0.5)),
)


def _face_inputs():
    """Per (case, needed face): everything both sides take."""
    out = []
    for name, floor, rvec, t in CASES:
        tsdf = _sphere_tsdf(floor)
        c2v = _cam2vol(rvec, t)
        flags = faces_needed(inverse(c2v), INTR)
        for f, fr in enumerate(face_frames()):
            if not bool(flags[f]):
                continue
            D, off, vs_p = tfr.prime_geometry(fr, PARAMS, "cpu")
            org_p = D @ c2v.t + off
            A = D @ c2v.R
            out.append(dict(case=name, frame=fr, tsdf=tsdf, org_p=org_p.numpy(),
                            vs_p=vs_p, A=A.numpy()))
    return out


@pytest.fixture(scope="module")
def faces():
    items = _face_inputs()
    refs = torch_jaxref.run(
        ("face_pass_parts", dict(
            tsdf_p=prime(torch.as_tensor(it["tsdf"]), it["frame"]).numpy(),
            origin_p=it["org_p"], vs_p=it["vs_p"], A=it["A"], intr=INTR_T, spec=SPEC_T))
        for it in items)
    return [dict(it, ref=r) for it, r in zip(items, refs)]


def test_cases_cover_several_faces(faces):
    names = {it["frame"].name for it in faces}
    assert len(names) >= 4, names
    hits = sum(int((it["ref"]["hit"] < it["ref"]["back"]).sum()) for it in faces)
    assert hits > 20_000, hits


def test_sweep_rays_plain_matches_tpu_sweep(faces):
    """The full per-ray march gives the work-listed TPU sweep's hits and
    hit mask exactly. Its back events differ only in outward exits: the
    march records an exit at the first plane past the volume's side, the
    TPU sweep only at a plane it visits (its work lists skip slabs and
    tiles that hold no negative voxel), so later or never. An exit ends a
    ray without a hit, so `hit < back` is the same either way."""
    for it in faces:
        prm = tfr.ray_params(torch.as_tensor(it["org_p"]), it["vs_p"], SPEC,
                             torch.tensor(True))
        hit, back = tfr.sweep_rays(torch.as_tensor(it["tsdf"]), it["frame"], prm, SPEC)
        hit, back = hit.numpy(), back.numpy()
        ref = it["ref"]
        tag = f"{it['case']} {it['frame'].name}"
        np.testing.assert_array_equal(hit, ref["hit"], err_msg=f"{tag} hit")
        np.testing.assert_array_equal(hit < back, ref["hit"] < ref["back"],
                                      err_msg=f"{tag} hit mask")
        assert (back <= ref["back"]).all(), tag
        hit_rays = hit < 1e30
        np.testing.assert_array_equal(back[hit_rays], ref["back"][hit_rays],
                                      err_msg=f"{tag} back of hit rays")


def test_face_fields_match_jax(faces):
    """t and the validity mask equal; normals within 1e-6 (the 3-term norm
    may sum in another order)."""
    for it in faces:
        ref = it["ref"]
        t, n, ok = tfr.face_fields(torch.as_tensor(ref["hit"]), torch.as_tensor(ref["back"]),
                                   torch.as_tensor(it["org_p"]), SPEC)
        tag = f"{it['case']} {it['frame'].name}"
        np.testing.assert_array_equal(ok.numpy(), ref["ok"], err_msg=f"{tag} ok")
        np.testing.assert_array_equal(t.numpy(), ref["t_f"], err_msg=f"{tag} t")
        np.testing.assert_allclose(n.numpy(), ref["n_f"], rtol=0, atol=1e-6,
                                   err_msg=f"{tag} normal")


def test_resample_face_plain_matches_jax(faces):
    for it in faces:
        ref = it["ref"]
        prm = face_params(torch.as_tensor(it["A"]), INTR, torch.tensor(True), SPEC)
        t, n = tfr.resample_face(torch.as_tensor(ref["t_f"]),
                                 torch.as_tensor(ref["n_f"]).contiguous(), prm, INTR)
        tag = f"{it['case']} {it['frame'].name}"
        np.testing.assert_array_equal(t.numpy(), ref["t_cam"], err_msg=f"{tag} t")
        np.testing.assert_array_equal(n.numpy(), ref["n_cam"], err_msg=f"{tag} normal")


def test_gate_off_gives_no_events(faces):
    it = faces[0]
    prm = tfr.ray_params(torch.as_tensor(it["org_p"]), it["vs_p"], SPEC, torch.tensor(False))
    hit, back = tfr.sweep_rays(torch.as_tensor(it["tsdf"]), it["frame"], prm, SPEC)
    assert (hit >= 1e30).all() and (back >= 1e30).all()
    prm5 = face_params(torch.as_tensor(it["A"]), INTR, torch.tensor(False), SPEC)
    t, n = tfr.resample_face(torch.as_tensor(it["ref"]["t_f"]),
                             torch.as_tensor(it["ref"]["n_f"]).contiguous(), prm5, INTR)
    assert (t >= 1e30).all() and not n.any()


def test_sweep_work_counts_what_the_march_reads(faces):
    """sweep_rays_work's voxels (what K4's bound charges) are all the march
    reads: the hits and backs do not change when every other voxel is
    overwritten. Each sampled voxel costs a ray-plane step, and a gated-off
    face costs nothing."""
    rng = np.random.default_rng(3)
    for it in faces:
        prm = tfr.ray_params(torch.as_tensor(it["org_p"]), it["vs_p"], SPEC,
                             torch.tensor(True))
        tsdf = torch.as_tensor(it["tsdf"])
        touched = torch.zeros(tsdf.numel(), dtype=torch.bool)
        hit, back, steps = tfr._march(tsdf, it["frame"], prm, SPEC, touched)
        n_vox, n_steps = tfr.sweep_rays_work(tsdf, it["frame"], prm, SPEC)
        tag = f"{it['case']} {it['frame'].name}"
        assert int(n_vox) == int(touched.sum()) and int(n_steps) == int(steps), tag
        assert 0 < int(n_vox) <= int(n_steps), tag
        t_p = prime(tsdf, it["frame"]).reshape(-1)
        noise = torch.as_tensor(rng.integers(-32767, 32768, t_p.shape[0]).astype(np.int16))
        t_p = torch.where(touched, t_p, noise).reshape(prime(tsdf, it["frame"]).shape)
        hit2, back2 = tfr.sweep_rays_plain(unprime(t_p, it["frame"]).contiguous(),
                                           it["frame"], prm, SPEC)
        assert torch.equal(hit, hit2) and torch.equal(back, back2), tag
    prm = tfr.ray_params(torch.as_tensor(it["org_p"]), it["vs_p"], SPEC, torch.tensor(False))
    assert [int(c) for c in tfr.sweep_rays_work(tsdf, it["frame"], prm, SPEC)] == [0, 0]
