"""The plain reference (`kfbench/reference/kinfu.py`) against the port's
plain paths on the same frames, at 160x120 and 128^3 on the CPU. The
reference imports nothing of the port; this test imports both."""

import numpy as np
import pytest
import torch

from kfbench import gen, harness
from kfbench.reference import compare
from kfbench.reference import kinfu as K

from .conftest import small_entry

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    """(entry, traffic, session after three frames on the CPU's default
    path, the reference's set-up)."""
    e = small_entry("pcl512.orbit")
    tr = gen.Traffic(e["mix"], 2024, harness._camera(e["config"]), "cpu")
    sess = harness.make_session(e["config"], "cpu")
    for k in range(3):
        c, d = tr.frame(k)
        assert sess.pipeline(c, d)
    return e, tr, sess, compare.Setup(e["config"])


def test_measurement_matches_port(setup):
    from kinfu_tpu_torch.pipeline.kinfu import _measurement

    e, tr, sess, st = setup
    _, d = tr.frame(3)
    depth = torch.as_tensor(d.astype(np.float32))
    _, pv, pn = _measurement(depth, sess.params, sess.intr)
    _, rv, rn = K.measurement(depth, st.cam, st.cfg, torch.float32)
    for a, b in zip(pv, rv):
        assert float((a - b).abs().max()) < 1e-5
    assert compare._pyr_miss_pct(pv, pn, rv, rn) < 0.05


def test_icp_matches_port(setup):
    from kinfu_tpu_torch.pipeline.kinfu import _measurement
    from kinfu_tpu_torch.tracking.icp import rigid_icp

    e, tr, sess, st = setup
    _, d = tr.frame(3)
    depth = torch.as_tensor(d.astype(np.float32))
    _, cv, cn = _measurement(depth, sess.params, sess.intr)
    res = rigid_icp(cv, cn, sess.state.model_vmaps, sess.state.model_nmaps, sess.intr,
                    sess.params)
    inc, ok, inl = K.icp(cv, cn, sess.state.model_vmaps, sess.state.model_nmaps, st.cam, st.cfg,
                         torch.float32)
    assert ok and bool(res.ok)
    assert float((inc[:3, :3] - res.pose.R).abs().max()) < 1e-5
    assert float((inc[:3, 3] - res.pose.t).abs().max()) < 1e-5
    assert abs(inl - int(res.num_inliers)) <= 5


def test_raycast_matches_port_step_march(setup):
    from kinfu_tpu_torch.geometry.se3 import pose_from_matrix
    from kinfu_tpu_torch.volume.raycast import raycast

    e, tr, sess, st = setup
    S = harness.host_state(sess)
    c2v = torch.linalg.inv(st.vol_pose(None, "cpu")) @ S["pose"]
    pv, pn = raycast(sess.state.vol, pose_from_matrix(c2v), sess.intr,
                     sess.params.replace(raycast_mode="step"))
    rv, rn = K.raycast(S["vol"][0], c2v, st.cam, st.grid, torch.float32)
    assert int((pn != 0).any(-1).sum()) > 5000
    assert compare._map_miss_pct(pv, pn, rv, rn, st.grid.voxel[0]) < 0.1


def test_fusion_matches_port_warped(setup):
    from kinfu_tpu_torch.geometry.se3 import compose, identity_pose, inverse
    from kinfu_tpu_torch.ops.face_integrate import integrate_warped
    from kinfu_tpu_torch.pipeline.kinfu import _measurement, _volume_pose
    from kinfu_tpu_torch.volume.tsdf import create_volume

    e, tr, sess, st = setup
    c, d = tr.frame(0)
    dm, _, _ = _measurement(torch.as_tensor(d.astype(np.float32)), sess.params, sess.intr)
    vol = create_volume(sess.params.volume_dims, device="cpu")
    v2c = compose(inverse(identity_pose("cpu")), _volume_pose(sess.params, torch.device("cpu")))
    integrate_warped(vol, dm[0], torch.as_tensor(c), v2c, sess.intr, sess.params)
    ref = compare.start_outputs(st, d.astype(np.float32), c, "cpu", torch.float32)
    empty = tuple(torch.zeros_like(a) for a in ref["vol"])
    assert int((vol.weight > 0).sum()) > 100_000
    assert compare._vol_miss_pct(empty, tuple(vol), ref["vol"], ref["upd"]) < 10.0


def test_shift_matches_port():
    from kinfu_tpu_torch.volume.stream import camera_centering_shift, shift_volume
    from kinfu_tpu_torch.volume.tsdf import TSDFVolume

    g = torch.Generator().manual_seed(3)
    arrs = (torch.randint(-30000, 30000, (16, 12, 8), generator=g, dtype=torch.int16),
            torch.randint(0, 64, (16, 12, 8), generator=g, dtype=torch.int16),
            torch.randint(0, 1 << 24, (16, 12, 8), generator=g, dtype=torch.int32))
    for s in ([2, -3, 1], [0, 0, 0], [-8, 5, 16], [1, 1, -2]):
        port = shift_volume(TSDFVolume(*arrs), torch.tensor(s, dtype=torch.int32))
        for a, b in zip(port, arrs):
            assert torch.equal(a, K.shift(b, s))
    grid = K.Grid((64, 64, 64), (3 / 64,) * 3, 0.1, 64)
    for p in ([0.1, 1.5, 2.9], [1.5, 1.5, 1.5], [2.3, 0.7, 0.74]):
        port = camera_centering_shift(torch.tensor(p), (64, 64, 64), (3 / 64,) * 3, 0.25)
        assert port.tolist() == K.centering_shift(torch.tensor(p, dtype=torch.float64), grid,
                                                  0.25).tolist()
