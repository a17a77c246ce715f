"""The port's ICP (kinfu_tpu_torch/tracking/icp.py, "gather" mode) against
the JAX package's `_normal_equations` and `rigid_icp`.

The current maps are the measurement pyramid of a rendered 160x120 frame,
the model maps that of the frame before it; both packages get the same
numpy arrays. The normal equations hold their inlier count exactly and A,
b to 1e-4 of their largest entry (a 19,200-row Gram sum taken in another
order); the coarse-to-fine poses hold 1e-5."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kinfu_tpu.config import KinFuParams as JParams
from kinfu_tpu.frontend.maps import build_measurement_pyramid
from kinfu_tpu.geometry.intrinsics import Intrinsics as JIntr
from kinfu_tpu.geometry.se3 import Pose as JPose
from kinfu_tpu.tracking import icp as jicp
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose, rodrigues
from kinfu_tpu_torch.tracking import icp as ticp

torch.set_num_threads(2)

INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
PARAMS = KinFuParams(icp_mode="gather")
JPARAMS = JParams(icp_mode="gather")


def _pyramid(T):
    depth, _ = default_test_scene().render_frame(T, Intrinsics(*INTR_T))
    p = PARAMS
    _, v, n = build_measurement_pyramid(
        jnp.asarray(depth), JIntr(*INTR_T), pyramid_height=p.pyramid_height,
        bfilter_kernel_size=p.bfilter_kernel_size, bfilter_color_sigma=p.bfilter_color_sigma,
        bfilter_spatial_sigma=p.bfilter_spatial_sigma, depth_scale=p.depth_scale,
        max_dist=p.dfilter_dist, normal_disc_threshold=p.normal_disc_threshold)
    return [np.asarray(a) for a in v], [np.asarray(a) for a in n]


@pytest.fixture(scope="module")
def maps():
    """(current, model) pyramids two orbit steps apart (0.6 deg)."""
    traj = make_orbit_trajectory(3, angle_step_deg=0.3)
    return _pyramid(traj[2]), _pyramid(traj[0])


INCREMENTS = {
    "identity": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
    "small": ((0.002, -0.004, 0.001), (0.004, -0.002, 0.003)),
}


@pytest.mark.parametrize("name", list(INCREMENTS))
@pytest.mark.parametrize("level", [0, 2])
def test_normal_equations_match_jax(maps, name, level):
    (cv, cn), (pv, pn) = maps
    rvec, t = INCREMENTS[name]
    R = rodrigues(torch.tensor(rvec, dtype=torch.float32))
    t = torch.tensor(t, dtype=torch.float32)
    intr = Intrinsics(*INTR_T).level(level)
    sin_t = math.sin(math.radians(PARAMS.icp_angle_threshold))
    args = [cv[level], cn[level], pv[level], pn[level]]
    A, b, n = ticp._normal_equations(Pose(R, t), *map(torch.as_tensor, args), intr,
                                     PARAMS.icp_dist_threshold, sin_t)
    jA, jb, jn = jax.jit(
        lambda R, t, *m: jicp._normal_equations(JPose(R, t), *m, JIntr(*INTR_T).level(level),
                                                PARAMS.icp_dist_threshold, sin_t)
    )(jnp.asarray(R.numpy()), jnp.asarray(t.numpy()), *map(jnp.asarray, args))
    assert int(n) == int(jn) > 100
    jA, jb = np.asarray(jA), np.asarray(jb)
    np.testing.assert_allclose(A.numpy(), jA, rtol=0, atol=1e-4 * np.abs(jA).max())
    np.testing.assert_allclose(b.numpy(), jb, rtol=0, atol=1e-4 * np.abs(jb).max())


def test_rigid_icp_matches_jax(maps):
    (cv, cn), (pv, pn) = maps
    res = ticp.rigid_icp(*[[torch.as_tensor(a) for a in m] for m in (cv, cn, pv, pn)],
                         Intrinsics(*INTR_T), PARAMS)
    jres = jax.jit(lambda *m: jicp.rigid_icp(*m, JIntr(*INTR_T), JPARAMS))(
        *[[jnp.asarray(a) for a in m] for m in (cv, cn, pv, pn)])
    assert bool(res.ok) and bool(jres.ok)
    np.testing.assert_allclose(res.pose.R.numpy(), np.asarray(jres.pose.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.pose.t.numpy(), np.asarray(jres.pose.t), rtol=0, atol=1e-5)
    assert abs(int(res.num_inliers) - int(jres.num_inliers)) <= 2
    # the increment is the real 0.6 deg orbit step, not the identity
    assert np.abs(np.asarray(jres.pose.t)).max() > 5e-3


def test_singular_system_fails_and_keeps_pose():
    """No correspondences: |det A| < 1e-15 fails the frame and the
    increment stays the identity (icp.py:188-193)."""
    z = [torch.zeros((120 >> l, 160 >> l, 3)) for l in range(3)]
    res = ticp.rigid_icp(z, z, z, z, Intrinsics(*INTR_T), PARAMS)
    assert not bool(res.ok)
    assert torch.equal(res.pose.R, torch.eye(3)) and not res.pose.t.any()
    assert int(res.num_inliers) == 0
