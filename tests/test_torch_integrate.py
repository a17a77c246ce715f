"""K3's plain version (kinfu_tpu_torch/ops/face_integrate.py::sweep_face_plain,
driven through integrate_warped) against the JAX package's interpret-mode
`integrate_warped` at 128^3: int16 TSDF, int16 weight and int32 colour
equal, for explicit faces and for "auto"; and K3's per-plane footprint
(`plane_footprint`) against the voxels the plain version updates.

Every case starts from a random prior volume (seeded numpy), so the update
math runs on old values and saturated weights, not only on an empty grid.
The JAX side runs without FMA contraction (tests/torch_jaxref.py)."""

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu_torch.config import tiny_params
from kinfu_tpu_torch.data.synthetic import default_test_scene
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
from kinfu_tpu_torch.ops import face_integrate as tfi
from kinfu_tpu_torch.ops.facewarp import FaceSpec, build_face_plain, face_frames
from kinfu_tpu_torch.volume.tsdf import TSDFVolume, create_volume

torch.set_num_threads(2)

INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
INTR = Intrinsics(*INTR_T)
PARAMS = tiny_params(128)
PARAMS_KW = (("pyramid_height", 1), ("icp_iters", (4,)), ("volume_dims", (128, 128, 128)))
SPEC_T = (256, 104.0, 6)
SPEC = FaceSpec(*SPEC_T)
ALL_FACES = tuple(f.name for f in face_frames())


def _pose(ry_deg: float, rx_deg: float = 0.0, t=(0.1, -0.05, 0.2)) -> np.ndarray:
    a, b = np.radians(ry_deg), np.radians(rx_deg)
    Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Ry @ Rx
    T[:3, 3] = t
    return T


#: (name, camera pose, faces): forward on +z, tilted over +z/-x with the
#: device face gating, backward on -z from inside the volume
CASES = (
    ("forward", _pose(0.0), ("+z",)),
    ("tilted_auto", _pose(40.0), "auto"),
    ("backward", _pose(180.0, t=(0.1, -0.05, 2.4)), ("-z",)),
)


def _prior(seed: int):
    """Random int16 TSDF, weights up to and at the cap, random colours."""
    rng = np.random.default_rng(seed)
    shape = (128, 128, 128)
    return (
        rng.integers(-32767, 32768, shape).astype(np.int16),
        rng.integers(0, PARAMS.tsdf_max_weight + 1, shape).astype(np.int16),
        rng.integers(0, 1 << 24, shape).astype(np.int32),
    )


def _frame(T):
    depth, color = default_test_scene().render_frame(T, INTR)
    return (depth * np.float32(0.001)).astype(np.float32), color


def _vol2cam(T):
    cam = pose_from_matrix(torch.as_tensor(T))
    volp = pose_from_matrix(torch.as_tensor(PARAMS.volume_pose))
    return compose(inverse(cam), volp)


def _port(vol_np, T, faces):
    depth_m, color = _frame(T)
    vol = TSDFVolume(*(torch.as_tensor(a.copy()) for a in vol_np))
    return tfi.integrate_warped(vol, torch.as_tensor(depth_m), torch.as_tensor(color),
                                _vol2cam(T), INTR, PARAMS, spec=SPEC, faces=faces)


@pytest.fixture(scope="module")
def jax_refs():
    calls = []
    for k, (_, T, faces) in enumerate(CASES):
        depth_m, color = _frame(T)
        v2c = _vol2cam(T)
        calls.append(("integrate_warped", dict(
            vol=_prior(k), depth_m=depth_m, color_rgb=color, R=v2c.R.numpy(),
            t=v2c.t.numpy(), intr=INTR_T, params_kw=PARAMS_KW, spec=SPEC_T, faces=faces)))
    v2c = _vol2cam(CASES[1][1])
    calls.append(("faces_needed", dict(R=v2c.R.numpy(), t=v2c.t.numpy(), intr=INTR_T)))
    return torch_jaxref.run(calls)


@pytest.mark.parametrize("k", range(len(CASES)), ids=[c[0] for c in CASES])
def test_integrate_matches_jax_exactly(jax_refs, k):
    _, T, faces = CASES[k]
    prior = _prior(k)
    vol = _port(prior, T, faces)
    ref = jax_refs[k]
    for name, got, want in zip(("tsdf", "weight", "colour"), vol, ref):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    changed = (vol.weight.numpy() != prior[1]).sum()
    assert changed > 10_000, changed


def test_faces_needed_matches_jax(jax_refs):
    flags = tfi.faces_needed(_vol2cam(CASES[1][1]), INTR)
    want = jax_refs[-1]
    assert [bool(f) for f in flags] == [want[n] for n in ALL_FACES]
    assert 1 < sum(want.values()) < 6


def test_auto_equals_all_faces():
    """The device flags only skip faces that would update nothing."""
    T = CASES[1][1]
    a = _port(_prior(1), T, "auto")
    b = _port(_prior(1), T, ALL_FACES)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_face_ownership_exclusive():
    """Each voxel is owned by one face: on an empty volume the six single
    sweeps update disjoint voxel sets, and all six together update every
    voxel at most once."""
    T = _pose(45.0, -35.0)
    zero = tuple(a.numpy() for a in create_volume(PARAMS.volume_dims, device="cpu"))
    seen = np.zeros((128, 128, 128), np.int32)
    faces_hit = 0
    for name in ALL_FACES:
        w = _port(zero, T, (name,)).weight.numpy()
        seen += w > 0
        faces_hit += int((w > 0).sum() > 1000)
    assert seen.max() == 1
    assert faces_hit >= 3, faces_hit
    w_all = _port(zero, T, ALL_FACES).weight.numpy()
    assert w_all.max() == 1
    np.testing.assert_array_equal(w_all > 0, seen > 0)


def test_sweep_gate_off_leaves_volume():
    T = CASES[0][1]
    depth_m, color = _frame(T)
    prior = _prior(5)
    vol = TSDFVolume(*(torch.as_tensor(a.copy()) for a in prior))
    tfi.integrate_faces(vol, torch.as_tensor(depth_m), tfi.pack_rgb(torch.as_tensor(color)),
                        _vol2cam(T), INTR, PARAMS, SPEC, torch.zeros(6, dtype=torch.bool),
                        names=("+z",))
    for got, want in zip(vol, prior):
        np.testing.assert_array_equal(got.numpy(), want)


def test_sweep_counts_the_voxels_it_changes():
    """sweep_face_plain returns what K3's bound charges: the voxels whose
    TSDF and weight it updated and those whose colour it mixed. On an empty
    volume every update raises the weight; a colour word with bit 30 set
    changes wherever a colour is mixed, since the mix writes 24 bits."""
    T = CASES[0][1]
    depth_m, color = _frame(T)
    frame = next(f for f in face_frames() if f.name == "+z")
    vol = create_volume(PARAMS.volume_dims, device="cpu")
    vol.color.fill_(1 << 30)
    on = torch.tensor(True)
    A, c_p = tfi.face_geometry(_vol2cam(T), frame, PARAMS.volume_dims, PARAMS.voxel_size)
    face_prm = tfi.face_params(A, INTR, on, SPEC)
    rk, ck = build_face_plain(torch.as_tensor(depth_m), tfi.pack_rgb(torch.as_tensor(color)),
                              face_prm, SPEC)
    prm = tfi.sweep_params(c_p, tfi.primed_voxel_size(frame, PARAMS.voxel_size), SPEC, PARAMS,
                           rk.max().float(), on, face_prm, INTR)
    dims_p = tuple(vol.tsdf.shape[a] for a in frame.axes)
    n_upd, n_col = tfi.sweep_face_plain(vol, frame, rk, ck, prm,
                                        tfi.plane_table(SPEC, prm, dims_p))
    assert int(n_upd) == int((vol.weight != 0).sum()) > 10_000
    assert int(n_col) == int((vol.color != 1 << 30).sum()) > 1_000
    assert int(n_col) < int(n_upd)


#: the footprint test's cases: the module's, with "auto" as every face, and
#: all six faces of test_face_ownership_exclusive's pose
FOOTPRINT_CASES = tuple((n, T, ALL_FACES if f == "auto" else f) for n, T, f in CASES) + (
    ("ownership", _pose(45.0, -35.0), ALL_FACES),)
#: the most of the admitted planes' voxels that the footprints may cover: the
#: rectangles follow the camera's frustum where each corner ray of the image
#: is in front of the face, else the face's 45-degree ownership cone
#: (0.17-0.49 on these cases)
FOOTPRINT_SHARE = 0.5


@pytest.mark.parametrize("case", FOOTPRINT_CASES, ids=[c[0] for c in FOOTPRINT_CASES])
def test_plane_footprint_covers_every_update(case):
    """K3 visits only the voxels inside each plane's footprint rectangle, so
    every voxel the plain sweep updates must lie inside the rectangle of its
    primed plane; a plane the gate shuts has an empty one, and the
    rectangles leave out a good share of the admitted planes' voxels."""
    _, T, faces = case
    depth_m, color = _frame(T)
    col_packed = tfi.pack_rgb(torch.as_tensor(color))
    on = torch.tensor(True)
    covered = admitted = 0
    for frame in face_frames():
        if frame.name not in faces:
            continue
        vol = create_volume(PARAMS.volume_dims, device="cpu")
        A, c_p = tfi.face_geometry(_vol2cam(T), frame, PARAMS.volume_dims, PARAMS.voxel_size)
        face_prm = tfi.face_params(A, INTR, on, SPEC)
        rk, ck = build_face_plain(torch.as_tensor(depth_m), col_packed, face_prm, SPEC)
        prm = tfi.sweep_params(c_p, tfi.primed_voxel_size(frame, PARAMS.voxel_size), SPEC,
                               PARAMS, rk.max().float(), on, face_prm, INTR)
        dims_p = tuple(vol.tsdf.shape[a] for a in frame.axes)
        table = tfi.plane_table(SPEC, prm, dims_p)
        n_upd, _ = tfi.sweep_face_plain(vol, frame, rk, ck, prm, table)
        fp = tfi.plane_footprint(table, prm, dims_p)
        upd = tfi.prime(vol.weight, frame) != 0
        assert int(upd.sum()) == int(n_upd)
        z, y, x = torch.nonzero(upd, as_tuple=True)
        inside = ((fp[z, 0] <= x) & (x <= fp[z, 1]) & (fp[z, 2] <= y) & (y <= fp[z, 3]))
        assert bool(inside.all()), (frame.name, int((~inside).sum()))
        shut = table[:, -1] == 0
        assert (fp[shut] == torch.tensor([0, -1, 0, -1])).all(), frame.name
        covered += int(tfi.footprint_voxels(fp))
        admitted += int((~shut).sum()) * dims_p[1] * dims_p[2]
    assert covered <= FOOTPRINT_SHARE * admitted, (covered, admitted)
    assert admitted > 0


def test_one_launch_stacks_fuse_as_the_per_face_form():
    """The fused update's K2 form, six stacks from one `build_faces` call
    with each face's largest range from it, gives the volume bit for bit
    that the per-face form it replaced gives (one `build_face_plain` stack
    and its `max()` a face), on a corner-orbit frame where two faces are
    live, from a random prior."""
    from kinfu_tpu_torch.data.synthetic import corner_test_scene, yaw_trajectory

    T = yaw_trajectory([_pose(0.0, t=(0.0, 0.0, 0.0))])[0]
    depth, color = corner_test_scene().render_frame(T, INTR)
    depth_m = torch.as_tensor((depth * np.float32(0.001)).astype(np.float32))
    col_packed = tfi.pack_rgb(torch.as_tensor(color))
    v2c = _vol2cam(T)
    gates = tfi.faces_needed(v2c, INTR)
    assert int(gates.sum()) == 2, gates
    prior = _prior(7)
    one = TSDFVolume(*(torch.as_tensor(a.copy()) for a in prior))
    tfi.integrate_faces(one, depth_m, col_packed, v2c, INTR, PARAMS, SPEC, gates)

    per_face = TSDFVolume(*(torch.as_tensor(a.copy()) for a in prior))
    vs = PARAMS.voxel_size
    updated = []
    for f, frame in enumerate(face_frames()):
        A, c_p = tfi.face_geometry(v2c, frame, PARAMS.volume_dims, vs)
        face_prm = tfi.face_params(A, INTR, gates[f], SPEC)
        rk, ck = build_face_plain(depth_m, col_packed, face_prm, SPEC)
        prm = tfi.sweep_params(c_p, tfi.primed_voxel_size(frame, vs), SPEC, PARAMS,
                               rk.max().float(), gates[f], face_prm, INTR)
        dims_p = tuple(per_face.tsdf.shape[a] for a in frame.axes)
        n_upd, _ = tfi.sweep_face_plain(per_face, frame, rk, ck, prm,
                                        tfi.plane_table(SPEC, prm, dims_p))
        updated.append(int(n_upd))
    for name, a, b in zip(("tsdf", "weight", "colour"), one, per_face):
        assert torch.equal(a, b), name
    # both live faces did work
    assert all((n > 1000) == bool(g) for n, g in zip(updated, gates)), updated
