"""The raycast kernels' plain versions against the JAX package, stage by
stage, on the sphere volumes of test_pallas_raycast.py (128^3, 256 px
face):

  - K4 `sweep_rays_plain` (a full march of every face ray through every
    plane) against the interpret-mode `_sweep_face_rays` (the TPU sweep
    with its occupancy pooling and slab/tile work lists): equal hits, and
    back events that differ only in where an outward exit is recorded;
  - `face_fields_plain` against `_face_fields` on the same events, and
    R1's six-face entry `face_fields` against both, on the one-card
    step's list of events, a rank's reduced events and a face whose rays
    all miss;
  - K5 `resample_face_plain` against the interpret-mode `_resample_face`
    on the same face fields: equal;
  - K5 `resample_composite_plain` (all faces of a view in one pass) against
    `_face_pass` and the fused step's composite over the faces, and
    against the port's per-face form of the same composite;
  - K4's per-ray plane interval (`ray_plane_interval`) against the full
    march: restricting the march to it changes no bit.

Each stage gets the JAX stage's inputs, so a difference is that stage's
own. The JAX side runs without FMA contraction (tests/torch_jaxref.py)."""

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose, inverse, rodrigues
from kinfu_tpu_torch.numerics import rint_index
from kinfu_tpu_torch.ops import face_raycast as tfr
from kinfu_tpu_torch.ops.face_integrate import faces_needed, prime, unprime
from kinfu_tpu_torch.ops.facewarp import face_frames, face_params
from kinfu_tpu_torch.volume.tsdf import SHORTMAX

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
                            vs_p=vs_p, A=A.numpy(), c2v=c2v, flags=flags))
    return out


@pytest.fixture(scope="module")
def faces():
    items = _face_inputs()
    refs = torch_jaxref.run(
        ("face_pass_parts", dict(
            tsdf_p=prime(torch.as_tensor(it["tsdf"]), it["frame"]).numpy(),
            origin_p=it["org_p"], vs_p=it["vs_p"], A=it["A"], intr=INTR_T, spec=SPEC_T,
            face=it["frame"].name, R=it["c2v"].R.numpy(), t=it["c2v"].t.numpy(),
            params_kw=(("volume_dims", (DIM,) * 3),)))
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
        t, n, ok = tfr.face_fields_plain(torch.as_tensor(ref["hit"]),
                                         torch.as_tensor(ref["back"]),
                                         torch.as_tensor(it["org_p"]), SPEC)
        tag = f"{it['case']} {it['frame'].name}"
        np.testing.assert_array_equal(ok.numpy(), ref["ok"], err_msg=f"{tag} ok")
        np.testing.assert_array_equal(t.numpy(), ref["t_f"], err_msg=f"{tag} t")
        np.testing.assert_allclose(n.numpy(), ref["n_f"], rtol=0, atol=1e-6,
                                   err_msg=f"{tag} normal")


#: R1's layouts: (the case, how its six faces' events reach the entry)
SHADE_LAYOUTS = (("oblique", "list"), ("tilted", "events"), ("axis", "miss"))


@pytest.mark.parametrize("case,layout", SHADE_LAYOUTS, ids=[lay for _, lay in SHADE_LAYOUTS])
def test_face_fields_six_faces(faces, case, layout):
    """R1's six-face entry on a case's six faces (JAX's events where the
    face is needed, all misses as a gated-off sweep leaves them elsewhere)
    equals `face_fields_plain` face by face, and JAX's `_face_fields` on
    the needed faces (t and valid equal, normals within 1e-6). "list" is
    the one-card step's six separate events, "events" a rank's reduced
    [6, 2, F, F] events passed as views; "miss" holds the faces whose rays
    all miss to t = 1e30, n = 0 and valid = False."""
    its = {it["frame"].name: it for it in faces if it["case"] == case}
    c2v = next(iter(its.values()))["c2v"]
    prm = tfr.composite_params(c2v, PARAMS)
    F = SPEC.size
    miss = torch.full((F, F), 1e30)
    hits = [torch.as_tensor(its[fr.name]["ref"]["hit"]) if fr.name in its else miss
            for fr in face_frames()]
    backs = [torch.as_tensor(its[fr.name]["ref"]["back"]) if fr.name in its else miss
             for fr in face_frames()]
    if layout == "events":
        events = torch.stack([torch.stack([h, b]) for h, b in zip(hits, backs)])
        hits, backs = [e[0] for e in events], [e[1] for e in events]
    t, n, ok = tfr.face_fields(hits, backs, prm, SPEC)
    assert t.shape == (6, F, F) and n.shape == (6, F, F, 3) and ok.shape == (6, F, F)
    for f, fr in enumerate(face_frames()):
        tag = f"{case} {layout} {fr.name}"
        tp, np_, okp = tfr.face_fields_plain(hits[f], backs[f], prm[f, 9:12], SPEC)
        assert torch.equal(t[f], tp) and torch.equal(n[f], np_) and torch.equal(ok[f], okp), tag
        if fr.name in its:
            ref = its[fr.name]["ref"]
            np.testing.assert_array_equal(ok[f].numpy(), ref["ok"], err_msg=f"{tag} ok")
            np.testing.assert_array_equal(t[f].numpy(), ref["t_f"], err_msg=f"{tag} t")
            np.testing.assert_allclose(n[f].numpy(), ref["n_f"], rtol=0, atol=1e-6,
                                       err_msg=f"{tag} normal")
        else:
            assert bool((t[f] == 1e30).all()) and not bool(n[f].any()), tag
            assert not bool(ok[f].any()), tag
    assert int(ok.sum()) > 1000, case
    if layout == "miss":
        assert len(its) < 6, "the case has no face whose rays all miss"


def test_resample_face_plain_matches_jax(faces):
    for it in faces:
        ref = it["ref"]
        prm = face_params(torch.as_tensor(it["A"]), INTR, torch.tensor(True), SPEC)
        t, n = tfr.resample_face_plain(torch.as_tensor(ref["t_f"]),
                                       torch.as_tensor(ref["n_f"]).contiguous(), prm, INTR)
        tag = f"{it['case']} {it['frame'].name}"
        np.testing.assert_array_equal(t.numpy(), ref["t_cam"], err_msg=f"{tag} t")
        np.testing.assert_array_equal(n.numpy(), ref["n_cam"], err_msg=f"{tag} normal")


def _composite_inputs(case, faces):
    """The six faces' fields of one case (JAX's, where the face is needed;
    what a gated-off sweep leaves elsewhere), its gates and its K5 block."""
    its = {it["frame"].name: it for it in faces if it["case"] == case}
    c2v, flags = next(iter(its.values()))["c2v"], next(iter(its.values()))["flags"]
    F = SPEC.size
    t_f = [torch.as_tensor(its[fr.name]["ref"]["t_f"]) if fr.name in its
           else torch.full((F, F), 1e30) for fr in face_frames()]
    n_f = [torch.as_tensor(its[fr.name]["ref"]["n_f"]).contiguous() if fr.name in its
           else torch.zeros((F, F, 3)) for fr in face_frames()]
    return its, t_f, n_f, flags, tfr.composite_params(c2v, PARAMS)


def _composite(parts, h, w):
    """The fused step's composite over faces (kinfu_tpu/ops/fused_step.py:
    132-144) of [(p_v, n_v, ok, own), ...] in face order."""
    vertex, normal = np.zeros((h, w, 3), np.float32), np.zeros((h, w, 3), np.float32)
    valid = np.zeros((h, w), bool)
    for p_v, n_v, ok, own in parts:
        m = own & ok
        vertex = np.where(m[..., None], p_v, vertex)
        normal = np.where(m[..., None], n_v, normal)
        valid = (m & (np.abs(n_v) > 0).any(-1)) | valid
    return vertex, normal, valid


#: composite against JAX: vertex (metres, within 3 m of the origin, a few
#: float32 ulps of the primed ray, which JAX forms with an einsum and K5
#: element-wise) and unit normals (copied, only unprimed)
COMPOSITE_TOL = 1e-6


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_resample_composite_matches_jax(faces, case):
    its, t_f, n_f, gates, prm = _composite_inputs(case, faces)
    vertex, normal, valid = tfr.resample_composite(t_f, n_f, prm, gates, INTR, SPEC)
    h, w = INTR.height, INTR.width
    jv, jn, jvalid = _composite([(it["ref"]["p_v"], it["ref"]["n_v"], it["ref"]["ok_cam"],
                                  it["ref"]["own"]) for it in its.values()], h, w)
    np.testing.assert_array_equal(valid.numpy(), jvalid, err_msg=f"{case} valid")
    assert valid.sum() > 50, case
    np.testing.assert_allclose(vertex.numpy()[jvalid], jv[jvalid], rtol=0, atol=COMPOSITE_TOL)
    np.testing.assert_allclose(normal.numpy()[jvalid], jn[jvalid], rtol=0, atol=COMPOSITE_TOL)

    # the port's per-face form: K5's one-face resample, ownership from the
    # pixel rays' matmul, unprime by D, composite
    parts = []
    rays = INTR.pixel_rays()
    for f, fr in enumerate(face_frames()):
        if fr.name not in its:
            continue
        D, off, _ = tfr.prime_geometry(fr, PARAMS, "cpu")
        A = D @ its[fr.name]["c2v"].R
        t_cam, n_cam = tfr.resample_face_plain(t_f[f], n_f[f],
                                               face_params(A, INTR, torch.tensor(True), SPEC),
                                               INTR)
        d_p = rays @ A.T
        adx, ady, dz = d_p[..., 0].abs(), d_p[..., 1].abs(), d_p[..., 2]
        own = (dz > 0) & ((adx < dz) if fr.gt_x else (adx <= dz)) & (
            (ady < dz) if fr.gt_y else (ady <= dz))
        ok = t_cam < 1e30
        tsafe = torch.where(ok, t_cam, 0.0)
        p_p = prm[f, 9:12] + d_p / torch.clamp(dz, min=1e-9)[..., None] * tsafe[..., None]
        parts.append(((p_p - off) @ D, n_cam @ D, ok, own))
    ov, on_, ovalid = _composite([tuple(a.numpy() for a in p) for p in parts], h, w)
    np.testing.assert_array_equal(valid.numpy(), ovalid, err_msg=f"{case} per-face valid")
    print(f"{case}: {int(valid.sum())} valid pixels; max |vertex - JAX| "
          f"{np.abs(vertex.numpy() - jv)[jvalid].max():.3g} m, per-face form "
          f"{np.abs(vertex.numpy() - ov)[ovalid].max():.3g} m; max |normal - per-face| "
          f"{np.abs(normal.numpy() - on_)[ovalid].max():.3g}")


def test_gate_off_gives_no_events(faces):
    it = faces[0]
    prm = tfr.ray_params(torch.as_tensor(it["org_p"]), it["vs_p"], SPEC, torch.tensor(False))
    hit, back = tfr.sweep_rays(torch.as_tensor(it["tsdf"]), it["frame"], prm, SPEC)
    assert (hit >= 1e30).all() and (back >= 1e30).all()
    prm5 = face_params(torch.as_tensor(it["A"]), INTR, torch.tensor(False), SPEC)
    t, n = tfr.resample_face_plain(torch.as_tensor(it["ref"]["t_f"]),
                                   torch.as_tensor(it["ref"]["n_f"]).contiguous(), prm5, INTR)
    assert (t >= 1e30).all() and not n.any()
    _, t_f, n_f, gates, prm = _composite_inputs(it["case"], faces)
    vertex, normal, valid = tfr.resample_composite(t_f, n_f, prm, gates & False, INTR, SPEC)
    assert not (vertex.any() or normal.any() or valid.any())


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


def _march_in(tsdf, frame, prm, z_first, z_last):
    """`_march` with each ray restricted to its planes [z_first, z_last]:
    (hit_t, back_t, first and last plane where a live ray samples a voxel
    or an exit fires; Zp and -1 where none)."""
    t_p = prime(tsdf, frame)
    Zp, Yp, Xp = t_p.shape
    F = SPEC.size
    ox, oy, oz, vsx, vsy, vsz = prm[0], prm[1], prm[2], prm[3], prm[4], prm[5]
    f, c, t_cover, own_tan, gate = prm[6], prm[7], prm[8], prm[9], prm[10]
    inv_vsx = 1.0 / vsx
    inv_vsy = 1.0 / vsy
    pix = torch.arange(F, dtype=torch.float32)
    dy = ((pix - c) * (1.0 / f))[:, None]
    dx = ((pix - c) * (1.0 / f))[None, :]
    ht = torch.full((F, F), 1e30)
    bt = torch.full((F, F), 1e30)
    fp = torch.full((F, F), float("nan"))
    nan = torch.tensor(float("nan"))
    first = torch.full((F, F), Zp)
    last = torch.full((F, F), -1)
    alive = tfr._own_mask(SPEC, own_tan, "cpu") & (gate != 0)
    flat = t_p.reshape(-1)
    for zg in range(Zp):
        t_m = float(zg) * vsz - oz
        t_ok = (t_m > 1e-6) & (t_m <= t_cover)
        ts = torch.clamp(t_m, min=1e-6)
        yi = rint_index((oy + dy * ts) * inv_vsy)
        xi = rint_index((ox + dx * ts) * inv_vsx)
        lin = (zg * Yp + yi.clamp(0, Yp - 1)) * Xp + xi.clamp(0, Xp - 1)
        f_new = flat[lin].float() * (1.0 / SHORTMAX)
        valid = t_ok & (1 <= zg < Zp - 1) & (yi >= 1) & (yi < Yp - 1) & (xi >= 1) & (xi < Xp - 1)
        live = alive & (ht >= 1e30) & (bt >= 1e30) & (z_first <= zg) & (zg <= z_last)
        front = live & valid & (fp > 0.0) & (f_new < 0.0)
        back = live & valid & (fp < 0.0) & (f_new > 0.0)
        denom = fp - f_new
        frac = fp / torch.where(denom.abs() < 1e-30, torch.full_like(denom, 1e-30), denom)
        ht = torch.where(front, t_m - vsz + vsz * frac, ht)
        bt = torch.where(back, t_m, bt)
        exit_out = (((xi >= Xp - 1) & (dx > 0)) | ((xi <= 0) & (dx < 0))
                    | ((yi >= Yp - 1) & (dy > 0)) | ((yi <= 0) & (dy < 0))) & t_ok
        bt = torch.where(live & ~front & ~back & exit_out, t_m, bt)
        fp = torch.where(live, torch.where(valid, f_new, nan), fp)
        used = live & (valid | exit_out)
        first = torch.where(used & (first == Zp), zg, first)
        last = torch.where(used, zg, last)
    return ht, bt, first, last


def _march_run(tsdf, frame, prm, z_first, v_last, z_last):
    """K4's march: the valid run [z_first, v_last] sampled without bounds or
    exit tests, then, for a ray it leaves unresolved, the exit at z_last
    where z_last lies past the run. (hit_t, back_t)."""
    t_p = prime(tsdf, frame)
    Zp, Yp, Xp = t_p.shape
    F = SPEC.size
    ox, oy, oz, vsx, vsy, vsz = prm[0], prm[1], prm[2], prm[3], prm[4], prm[5]
    f, c = prm[6], prm[7]
    pix = torch.arange(F, dtype=torch.float32)
    dy = ((pix - c) * (1.0 / f))[:, None]
    dx = ((pix - c) * (1.0 / f))[None, :]
    ht = torch.full((F, F), 1e30)
    bt = torch.full((F, F), 1e30)
    fp = torch.full((F, F), float("nan"))
    flat = t_p.reshape(-1)
    for zg in range(Zp):
        t_m = float(zg) * vsz - oz
        ts = torch.clamp(t_m, min=1e-6)
        yi = rint_index((oy + dy * ts) * (1.0 / vsy))
        xi = rint_index((ox + dx * ts) * (1.0 / vsx))
        run = (ht >= 1e30) & (bt >= 1e30) & (z_first <= zg) & (zg <= v_last)
        lin = (zg * Yp + yi.clamp(0, Yp - 1)) * Xp + xi.clamp(0, Xp - 1)
        f_new = flat[lin].float() * (1.0 / SHORTMAX)
        front = run & (fp > 0.0) & (f_new < 0.0)
        back = run & (fp < 0.0) & (f_new > 0.0)
        denom = fp - f_new
        frac = fp / torch.where(denom.abs() < 1e-30, torch.full_like(denom, 1e-30), denom)
        ht = torch.where(front, t_m - vsz + vsz * frac, ht)
        bt = torch.where(back, t_m, bt)
        fp = torch.where(run, f_new, fp)
    exit_t = z_last.float() * vsz - oz
    left = (ht >= 1e30) & (bt >= 1e30) & (z_last > v_last)
    return ht, torch.where(left, exit_t, bt)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_ray_interval_changes_nothing(faces, case):
    """K4 marches each ray over `ray_plane_interval` only: every plane where
    a live ray of the full march samples or exits lies inside the interval,
    the march restricted to it gives the full march's hit and back bits, so
    does K4's own form of it (the valid run, then the exit), and a gated-off
    face gives empty intervals."""
    items = [it for it in faces if it["case"] == case]
    assert items
    for it in items:
        frame = it["frame"]
        tag = f"{case} {frame.name}"
        tsdf = torch.as_tensor(it["tsdf"])
        dims_p = tuple(tsdf.shape[a] for a in frame.axes)
        prm = tfr.ray_params(torch.as_tensor(it["org_p"]), it["vs_p"], SPEC, torch.tensor(True))
        z_first, z_last, v_last = tfr.ray_plane_interval(prm, frame, dims_p, SPEC)
        ht, bt, _ = tfr._march(tsdf, frame, prm, SPEC)
        full = _march_in(tsdf, frame, prm, 0, dims_p[0] - 1)
        assert torch.equal(_bits(full[0]), _bits(ht)) and torch.equal(_bits(full[1]), _bits(bt))
        used = full[3] >= 0
        assert bool(used.any()), tag
        assert bool((z_first[used] <= full[2][used]).all()), tag
        assert bool((full[3][used] <= z_last[used]).all()), tag
        h2, b2, _, _ = _march_in(tsdf, frame, prm, z_first, z_last)
        assert torch.equal(_bits(h2), _bits(ht)), f"{tag} hit"
        assert torch.equal(_bits(b2), _bits(bt)), f"{tag} back"
        h3, b3 = _march_run(tsdf, frame, prm, z_first, v_last, z_last)
        assert torch.equal(_bits(h3), _bits(ht)), f"{tag} hit of the valid run"
        assert torch.equal(_bits(b3), _bits(bt)), f"{tag} back of the valid run"
        # the interval skips planes: fewer than every plane of every live ray
        span = (z_last - z_first + 1).clamp(min=0)
        assert int(span.sum()) < int((z_last >= 0).sum()) * dims_p[0], tag
        off = tfr.ray_params(torch.as_tensor(it["org_p"]), it["vs_p"], SPEC, torch.tensor(False))
        lo, hi, _ = tfr.ray_plane_interval(off, frame, dims_p, SPEC)
        assert bool((lo > hi).all()), tag
