"""The port's measurement pyramid (kinfu_tpu_torch/frontend) against the JAX
package's `build_measurement_pyramid` on a rendered 160x120 frame with
seeded sensor noise, and the model-pyramid downsample
`resize_points_normals`, at 1e-5.

Both run in this process. The bilateral filter's exp (XLA's and PyTorch's
differ in the last bit) and XLA's fused multiply-adds move depths and
vertices by a few ulps. A normal is the cross product of two ~5 mm central
differences of vertices, which amplifies those ulps about a hundredfold:
normals hold 1e-5 on all but a few pixels and 1e-4 everywhere."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kinfu_tpu.frontend import maps as jmaps
from kinfu_tpu.geometry.intrinsics import Intrinsics as JIntr
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import default_test_scene
from kinfu_tpu_torch.frontend import maps as tmaps
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics

torch.set_num_threads(2)

INTR_T = (160, 120, 140.0, 138.0, 79.2, 60.1)
TOL = 1e-5


def _depth_mm() -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.05, -0.02, 0.1)
    depth, _ = default_test_scene().render_frame(T, Intrinsics(*INTR_T))
    rng = np.random.default_rng(11)
    noisy = np.round(depth + rng.normal(0.0, 2.0, depth.shape)) * (depth > 0)
    noisy[50:58, 70:90] = 0.0  # a hole, as a sensor drops returns
    return noisy.astype(np.float32)


def _kw(p: KinFuParams, levels: int):
    return dict(pyramid_height=levels, bfilter_kernel_size=p.bfilter_kernel_size,
                bfilter_color_sigma=p.bfilter_color_sigma,
                bfilter_spatial_sigma=p.bfilter_spatial_sigma, depth_scale=p.depth_scale,
                max_dist=p.dfilter_dist, normal_disc_threshold=p.normal_disc_threshold)


@pytest.fixture(scope="module")
def pyramids():
    depth = _depth_mm()
    kw = _kw(KinFuParams(), 3)
    j = jmaps.build_measurement_pyramid(jnp.asarray(depth), JIntr(*INTR_T), **kw)
    t = tmaps.build_measurement_pyramid(torch.as_tensor(depth), Intrinsics(*INTR_T), **kw)
    return [[np.array(a) for a in level] for level in j], [
        [a.numpy() for a in level] for level in t]


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["depth", "vertex", "normal"])
def test_pyramid_matches_jax(pyramids, kind):
    jp, tp = pyramids
    for lv, (j, t) in enumerate(zip(jp[kind], tp[kind])):
        assert t.shape == j.shape and t.dtype == j.dtype, lv
        if kind != 2:
            np.testing.assert_allclose(t, j, rtol=0, atol=TOL, err_msg=f"level {lv}")
        else:
            err = np.abs(t - j)
            assert (err <= TOL).mean() >= 0.99, (lv, (err <= TOL).mean())
            np.testing.assert_allclose(t, j, rtol=0, atol=10 * TOL, err_msg=f"level {lv}")
            # invalid normals are exact zeros in both, the border included
            np.testing.assert_array_equal((t != 0).any(-1), (j != 0).any(-1))
            assert not t[0].any() and not t[-1].any()
            assert not t[:, 0].any() and not t[:, -1].any()
            assert (t != 0).any(-1).mean() > 0.5


def test_resize_points_normals_matches_jax(pyramids):
    jp, _ = pyramids
    v, n = jp[1][0].copy(), jp[2][0]
    v[::7, ::5] = 0.0  # partly empty 2x2 blocks
    jv, jn = jmaps.resize_points_normals(jnp.asarray(v), jnp.asarray(n))
    tv, tn = tmaps.resize_points_normals(torch.as_tensor(v), torch.as_tensor(n))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=TOL)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=TOL)
    np.testing.assert_array_equal((tn.numpy() != 0).any(-1), (np.asarray(jn) != 0).any(-1))
