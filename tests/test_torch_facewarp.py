"""K2's plain version (kinfu_tpu_torch/ops/facewarp.py::build_face_plain)
against the JAX package's `_build_face_jnp` + `_stack_mips`, bit for bit,
on every cube face for forward, tilted, sideways and backward cameras.

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
        r, c = tfw.build_face(torch.as_tensor(depth_m), torch.as_tensor(col), prm, SPEC)
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
    r, c = tfw.build_face(torch.as_tensor(depth_m), torch.as_tensor(col), prm, SPEC)
    assert not r.any() and not c.any()


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
