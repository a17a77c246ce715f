"""K2's plain version (kinfu_tpu_torch/ops/facewarp.py::build_face_plain,
and `build_faces_plain` over the six faces with their largest ranges)
against the JAX package's `_build_face_jnp` + `_stack_mips`, bit for bit,
on every cube face for forward, tilted, sideways and backward cameras; and
the property K2's one-launch design rests on: every mip level is level 0
subsampled by 2^l.

The JAX side runs without FMA contraction (tests/torch_jaxref.py), so both
sides evaluate the same float32 operations; the face geometry is compared
in-process at 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_jaxref
from kinfu_tpu.geometry.se3 import Pose as JPose
from kinfu_tpu.ops import facewarp as jfw
from kinfu_tpu_torch.config import tiny_params
from kinfu_tpu_torch.data.synthetic import default_test_scene
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
from kinfu_tpu_torch.ops import facewarp as tfw
from kinfu_tpu_torch.volume.tsdf import pack_rgb

torch.set_num_threads(2)

INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
INTR = Intrinsics(*INTR_T)
PARAMS = tiny_params(128)
SPEC_T = (256, 104.0, 6)
SPEC = tfw.FaceSpec(*SPEC_T)


def _rot(axis: int, deg: float, t=(0.1, -0.05, 0.2)) -> np.ndarray:
    a = np.radians(deg)
    c, s = np.cos(a), np.sin(a)
    i, j = [k for k in range(3) if k != axis]
    T = np.eye(4, dtype=np.float32)
    T[i, i], T[i, j], T[j, i], T[j, j] = c, -s, s, c
    T[:3, 3] = t
    return T


#: forward (+z), tilted (+z and -x), sideways (-x, +x), backward (-z), and
#: looking down and up (+y, -y)
POSES = {
    "forward": _rot(1, 0.0),
    "tilted": _rot(1, 35.0),
    "left": _rot(1, 55.0),
    "right": _rot(1, -55.0),
    "backward": _rot(1, 180.0),
    "down": _rot(0, -60.0),
    "up": _rot(0, 60.0),
}


def _vol2cam(T):
    cam = pose_from_matrix(torch.as_tensor(T))
    volp = pose_from_matrix(torch.as_tensor(PARAMS.volume_pose))
    return compose(inverse(cam), volp)


@pytest.fixture(scope="module")
def cases():
    """Per (pose, face): the inputs and the JAX reference stacks."""
    scene = default_test_scene()
    out, calls = [], []
    for pname, T in POSES.items():
        depth, color = scene.render_frame(T, INTR)
        depth_m = (depth * np.float32(0.001)).astype(np.float32)
        col = pack_rgb(torch.as_tensor(color)).numpy()
        v2c = _vol2cam(T)
        for fr in tfw.face_frames():
            A, _ = tfw.face_geometry(v2c, fr, PARAMS.volume_dims, PARAMS.voxel_size)
            A = A.numpy()
            out.append((pname, fr.name, depth_m, col, A))
            calls.append(("build_face_jnp", dict(depth_m=depth_m, col_packed=col, A=A,
                                                 intr=INTR_T, spec=SPEC_T)))
    refs = torch_jaxref.run(calls)
    return [(*c, r) for c, r in zip(out, refs)]


def test_build_face_plain_bit_exact_all_faces(cases):
    covered = set()
    for pname, fname, depth_m, col, A, (r_ref, c_ref) in cases:
        prm = tfw.face_params(torch.as_tensor(A), INTR, torch.tensor(True), SPEC)
        r, c = tfw.build_face_plain(torch.as_tensor(depth_m), torch.as_tensor(col), prm, SPEC)
        assert r.dtype == torch.int16 and c.dtype == torch.int32
        assert tuple(r.shape) == (SPEC.stack_rows, SPEC.size)
        np.testing.assert_array_equal(r.numpy(), r_ref, err_msg=f"{pname} {fname} range")
        np.testing.assert_array_equal(c.numpy(), c_ref, err_msg=f"{pname} {fname} colour")
        if (r_ref > 0).sum() > 500:
            covered.add(fname)
    # every face saw real content from at least one camera
    assert covered == {fr.name for fr in tfw.face_frames()}, covered


def test_face_gate_off_gives_empty_stack(cases):
    _, _, depth_m, col, A, _ = cases[0]
    prm = tfw.face_params(torch.as_tensor(A), INTR, torch.tensor(False), SPEC)
    r, c, r_max = tfw.build_faces_plain(torch.as_tensor(depth_m), torch.as_tensor(col),
                                        prm.expand(tfw.FACES, -1), SPEC)
    assert tuple(r.shape) == (tfw.FACES, SPEC.stack_rows, SPEC.size)
    assert not r.any() and not c.any() and not r_max.any()


def _face_inputs(cases, pname):
    """(depth_m, col, [A per face], [JAX (range, colour) per face]) of a pose."""
    mine = [c for c in cases if c[0] == pname]
    assert [c[1] for c in mine] == [fr.name for fr in tfw.face_frames()]
    return mine[0][2], mine[0][3], [c[4] for c in mine], [c[5] for c in mine]


def test_build_faces_matches_jax_on_the_active_faces(cases):
    """One call over the six faces of a pose that engages two of them (the
    gates of `faces_needed`): each active face's stack equals the JAX
    reference's, its r_max equals jnp.max of the reference's range, and each
    gated-off face is an empty stack with r_max 0."""
    from kinfu_tpu_torch.ops.face_integrate import faces_needed

    depth_m, col, As, refs = _face_inputs(cases, "tilted")
    gates = faces_needed(_vol2cam(POSES["tilted"]), INTR)
    assert int(gates.sum()) == 2, gates
    prm6 = torch.stack([tfw.face_params(torch.as_tensor(A), INTR, gates[f], SPEC)
                        for f, A in enumerate(As)])
    r, c, r_max = tfw.build_faces_plain(torch.as_tensor(depth_m), torch.as_tensor(col), prm6,
                                        SPEC)
    assert r.dtype == torch.int16 and c.dtype == torch.int32 and r_max.dtype == torch.int32
    for f, (fr, (r_ref, c_ref)) in enumerate(zip(tfw.face_frames(), refs)):
        if bool(gates[f]):
            np.testing.assert_array_equal(r[f].numpy(), r_ref, err_msg=f"{fr.name} range")
            np.testing.assert_array_equal(c[f].numpy(), c_ref, err_msg=f"{fr.name} colour")
            assert int(r_max[f]) == int(jnp.max(jnp.asarray(r_ref))) > 0, fr.name
        else:
            assert not r[f].any() and not c[f].any() and int(r_max[f]) == 0, fr.name


def test_face_reads_are_what_the_stack_depends_on(cases):
    """`face_reads`, which K2's bound counts, holds every camera pixel a
    face's stack reads: poisoning depth and colour everywhere else leaves
    the stack unchanged, and `build_faces_work` sums it over the faces
    whose gate is set."""
    from kinfu_tpu_torch.ops.face_integrate import faces_needed

    depth_m, col, As, _ = _face_inputs(cases, "tilted")
    gates = faces_needed(_vol2cam(POSES["tilted"]), INTR)
    prm6 = torch.stack([tfw.face_params(torch.as_tensor(A), INTR, gates[f], SPEC)
                        for f, A in enumerate(As)])
    d, c = torch.as_tensor(depth_m), torch.as_tensor(col)
    want = 0
    for f in range(tfw.FACES):
        reads = tfw.face_reads(prm6[f], SPEC, INTR.height, INTR.width)
        assert 0 < int(reads.sum()) < reads.numel()
        want += int(reads.sum()) if bool(gates[f]) else 0
        d2 = torch.where(reads, d, torch.full_like(d, 7.5))
        c2 = torch.where(reads, c, torch.full_like(c, 0x123456))
        for a, b in zip(tfw.build_face_plain(d, c, prm6[f], SPEC),
                        tfw.build_face_plain(d2, c2, prm6[f], SPEC)):
            assert torch.equal(a, b), f
    assert int(tfw.build_faces_work(prm6, SPEC, INTR.height, INTR.width)) == want > 0


def _subsampled_stack(base: np.ndarray, spec: tfw.FaceSpec) -> np.ndarray:
    """A stack written the way K2 writes it: level-0 pixel (i, j) also goes
    to (i >> l, j >> l) of every level l where i and j are multiples of 2^l
    and that position lies inside the level; everything else is zero."""
    out = np.zeros((spec.stack_rows, spec.size), base.dtype)
    for l, off in enumerate(spec.row_offsets):
        wl = spec.size >> l
        out[off:off + wl, :wl] = base[::1 << l, ::1 << l][:wl, :wl]
    return out


@pytest.mark.parametrize("pname", list(POSES))
def test_mip_levels_are_subsamples_of_level_0(cases, pname):
    """Level l of the stack, whose pixels the plain version computes from
    their own rays, equals level 0 subsampled by 2^l, on every face of the
    pose: K2 computes each ray once, at level 0, and writes the mips from
    it. The JAX reference's stacks hold the same property."""
    depth_m, col, As, refs = _face_inputs(cases, pname)
    on = torch.ones(tfw.FACES, dtype=torch.bool)
    prm6 = torch.stack([tfw.face_params(torch.as_tensor(A), INTR, on[f], SPEC)
                        for f, A in enumerate(As)])
    r, c, _ = tfw.build_faces_plain(torch.as_tensor(depth_m), torch.as_tensor(col), prm6, SPEC)
    n = SPEC.size
    for f, (r_ref, c_ref) in enumerate(refs):
        for stack in (r[f].numpy(), c[f].numpy(), r_ref, c_ref):
            np.testing.assert_array_equal(stack, _subsampled_stack(stack[:n], SPEC))
    assert r.any()


@pytest.mark.parametrize("pname", list(POSES))
def test_face_geometry_matches_jax(pname):
    v2c = _vol2cam(POSES[pname])
    jv2c = JPose(jnp.asarray(v2c.R.numpy()), jnp.asarray(v2c.t.numpy()))
    dims, vs = PARAMS.volume_dims, PARAMS.voxel_size
    for tf, jf in zip(tfw.face_frames(), jfw.face_frames()):
        assert tf.name == jf.name and tf.axes == jf.axes and tf.flip == jf.flip
        assert (tf.gt_x, tf.gt_y) == (jf.gt_x, jf.gt_y)
        np.testing.assert_array_equal(tf.D, jf.D)
        A, c = tfw.face_geometry(v2c, tf, dims, vs)
        jA, jc = jfw._face_geometry(jv2c, jf, dims, vs)
        np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=0, atol=1e-6)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)


def test_face_spec_and_eligibility_match_jax():
    for spec in ((640, 261.0, 7), SPEC_T):
        t, j = tfw.FaceSpec(*spec), jfw.FaceSpec(*spec)
        assert (t.stack_rows, t.level_rows, t.row_offsets, t.centre) == (
            j.stack_rows, j.level_rows, j.row_offsets, j.centre)
    assert tuple(tfw.default_face_spec()) == tuple(jfw.default_face_spec())
    for shape in ((512, 512, 512), (128, 128, 128), (64, 64, 64), (128, 64, 128)):
        assert tfw.warp_dims_ok(shape) == jfw.warp_dims_ok(shape), shape
