"""K1, the warped ICP iteration (kinfu_tpu_torch/ops/icp_warped.py), against
the JAX package's Pallas kernel `kinfu_tpu.ops.pallas_icp.icp_normal_eqs_warped`
in interpret mode, and the port's warped `rigid_icp` against JAX's.

Inputs, the same numpy arrays for both packages: a bumpy synthetic surface
seen from two nearby poses with 5% holes (as tests/test_pallas_icp.py makes
it), and the measurement pyramids of two rendered 160x120 frames of the
orbit 0.6 deg apart. The JAX side runs in a child process without FMA
contraction (tests/torch_jaxref.py), so both sides round every product and
sum alike: the inlier count is exact; A and b hold 2e-4 of their largest
|entry|, since the Gram sums run in another order. The coarse-to-fine
increments hold 1e-5."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu_torch.frontend.maps import build_measurement_pyramid
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose, rodrigues
from kinfu_tpu_torch.ops import icp_warped as iw
from kinfu_tpu_torch.ops.icp_warped import icp_normal_eqs_warped, icp_normal_eqs_warped_plain
from kinfu_tpu_torch.tracking.icp import resolve_icp_mode, rigid_icp

torch.set_num_threads(2)

INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
INTR = Intrinsics(*INTR_T)
DIST = 0.015
SIN = math.sin(math.radians(30.0))
GRAM_TOL = 2e-4
POSE_TOL = 1e-5
ICP_CFG = dict(pyramid_height=2, icp_iters=(4, 5), icp_mode="warped")

INCREMENTS = {
    "identity": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
    "small": ((0.002, -0.004, 0.001), (0.004, -0.002, 0.003)),
    "rot1.5": ((0.0, math.radians(1.5), 0.0), (0.002, 0.0, -0.001)),
}


def _synthetic_maps(seed=0, h=120, w=160, shift=(0.004, -0.003, 0.006)):
    """A smooth bumpy surface observed from two nearby poses, holes in the
    current maps (tests/test_pallas_icp.py::_synthetic_maps)."""
    rng = np.random.default_rng(seed)
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    depth = 1.5 + 0.2 * np.sin(uu / 25.0) * np.cos(vv / 19.0)
    lx = (uu - INTR.cx) / INTR.fx
    ly = (vv - INTR.cy) / INTR.fy
    v_pre = np.stack([lx * depth, ly * depth, depth], -1).astype(np.float32)
    n = np.cross(np.gradient(v_pre, axis=1), np.gradient(v_pre, axis=0))
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    n = np.where(n[..., 2:3] > 0, -n, n).astype(np.float32)
    v_cur = v_pre + np.asarray(shift, np.float32)
    n_cur = n.copy()
    holes = rng.random((h, w)) < 0.05
    n_cur[holes] = 0.0
    v_cur[holes] = 0.0
    return v_cur, n_cur, v_pre, n


def _pyramid(T, levels=3):
    depth, _ = default_test_scene().render_frame(T, INTR)
    p = KinFuParams()
    _, v, n = build_measurement_pyramid(
        torch.as_tensor(depth), INTR, pyramid_height=levels,
        bfilter_kernel_size=p.bfilter_kernel_size, bfilter_color_sigma=p.bfilter_color_sigma,
        bfilter_spatial_sigma=p.bfilter_spatial_sigma, depth_scale=p.depth_scale,
        max_dist=p.dfilter_dist, normal_disc_threshold=p.normal_disc_threshold)
    return [a.numpy() for a in v], [a.numpy() for a in n]


def _inc(name):
    rvec, t = INCREMENTS[name]
    R = rodrigues(torch.tensor(rvec, dtype=torch.float32))
    return R.numpy(), np.asarray(t, np.float32)


def _cases():
    """(tag, increment, level, (cur_v, cur_n, pre_v, pre_n))."""
    traj = make_orbit_trajectory(3, angle_step_deg=0.3)
    (cv, cn), (pv, pn) = _pyramid(traj[2]), _pyramid(traj[0])
    syn = _synthetic_maps()
    cases = [(f"synthetic-{k}", k, 0, syn) for k in ("identity", "rot1.5")]
    cases += [(f"orbit-L{lv}-{k}", k, lv, (cv[lv], cn[lv], pv[lv], pn[lv]))
              for lv in (0, 1) for k in ("identity", "small")]
    return cases, (cv, cn, pv, pn)


@pytest.fixture(scope="module")
def refs():
    """The JAX references in one child process (interpret-mode Pallas, no
    FMA); the port's side runs in the tests meanwhile."""
    cases, pyr = _cases()
    calls = []
    for _, inc, lv, maps in cases:
        R, t = _inc(inc)
        calls.append(("icp_normal_eqs_warped", dict(
            R=R, t=t, cur_vmap=maps[0], cur_nmap=maps[1], pre_vmap=maps[2],
            pre_nmap=maps[3], intr=dataclasses.astuple(INTR.level(lv)),
            dist=DIST, sin=SIN)))
    levels = ICP_CFG["pyramid_height"]
    calls.append(("rigid_icp", dict(
        cur_vmaps=pyr[0][:levels], cur_nmaps=pyr[1][:levels], pre_vmaps=pyr[2][:levels],
        pre_nmaps=pyr[3][:levels], intr=INTR_T, params_kw=tuple(ICP_CFG.items()))))
    job = torch_jaxref.start(calls)
    return cases, pyr, job


@pytest.fixture(scope="module")
def ref_results(refs):
    return refs[2].result()


def _port(inc, lv, maps, fn=icp_normal_eqs_warped):
    R, t = _inc(inc)
    return fn(Pose(torch.as_tensor(R), torch.as_tensor(t)), *map(torch.as_tensor, maps),
              INTR.level(lv), DIST, SIN)


def _assert_gram_close(got, want, tag):
    (A, b, n), (jA, jb, jn) = got, want
    assert int(n) == jn, (tag, int(n), jn)
    np.testing.assert_allclose(A.numpy(), jA, rtol=0, atol=GRAM_TOL * np.abs(jA).max(),
                               err_msg=tag)
    np.testing.assert_allclose(b.numpy(), jb, rtol=0, atol=GRAM_TOL * np.abs(jb).max(),
                               err_msg=tag)


@pytest.mark.parametrize("index", range(6))
def test_normal_eqs_match_pallas_kernel(refs, ref_results, index):
    cases, _, _ = refs
    tag, inc, lv, maps = cases[index]
    got = _port(inc, lv, maps)
    # the check tests something: a real share of the pixels are inliers
    assert int(got[2]) > (1000 if lv == 0 else 250), (tag, int(got[2]))
    _assert_gram_close(got, ref_results[index], tag)
    A = got[0].numpy()
    np.testing.assert_array_equal(A, A.T)


def test_wrapper_takes_plain_version_on_cpu(refs):
    cases, _, _ = refs
    _, inc, lv, maps = cases[1]
    for a, b in zip(_port(inc, lv, maps), _port(inc, lv, maps, icp_normal_eqs_warped_plain)):
        assert torch.equal(a, b)


def test_rigid_icp_warped_matches_jax(refs, ref_results):
    _, (cv, cn, pv, pn), _ = refs
    levels = ICP_CFG["pyramid_height"]
    res = rigid_icp(*[[torch.as_tensor(a) for a in m[:levels]] for m in (cv, cn, pv, pn)],
                    INTR, KinFuParams(**ICP_CFG))
    jR, jt, jok, jn = ref_results[-1]
    assert bool(res.ok) and jok
    np.testing.assert_allclose(res.pose.R.numpy(), jR, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(res.pose.t.numpy(), jt, rtol=0, atol=POSE_TOL)
    assert int(res.num_inliers) == jn
    # the increment is the real 0.6 deg orbit step, not the identity
    assert np.abs(jt).max() > 5e-3


@pytest.mark.parametrize("split", [1, 37, 60])
def test_row_shards_sum_to_the_whole(split):
    """Current maps with fewer rows than the model maps (a row shard): the
    two shards' sums add up to the whole image's, the count exactly."""
    cv, cn, pv, pn = _synthetic_maps(seed=1)
    whole = _port("rot1.5", 0, (cv, cn, pv, pn))
    top = _port("rot1.5", 0, (cv[:split], cn[:split], pv, pn))
    bottom = _port("rot1.5", 0, (cv[split:], cn[split:], pv, pn))
    assert int(top[2]) + int(bottom[2]) == int(whole[2]) > 1000
    for k in (0, 1):
        ref = whole[k].numpy()
        np.testing.assert_allclose((top[k] + bottom[k]).numpy(), ref, rtol=0,
                                   atol=GRAM_TOL * np.abs(ref).max())


def test_auto_resolves_by_device():
    auto = KinFuParams()
    assert resolve_icp_mode(auto, torch.device("cpu")) == "gather"
    assert resolve_icp_mode(auto, torch.device("cuda")) == "warped"
    assert resolve_icp_mode(auto.replace(icp_mode="warped"), torch.device("cpu")) == "warped"
    assert resolve_icp_mode(auto.replace(icp_mode="gather"), torch.device("cuda")) == "gather"


def test_work_counts_the_model_pixels_read():
    """icp_normal_eqs_warped_work's count (what K1's bound charges) covers
    every model pixel the iteration reads: A, b and the count do not change
    when every other model pixel is overwritten."""
    cv, cn, pv, pn = (torch.as_tensor(a) for a in _synthetic_maps(seed=2))
    R, t = _inc("rot1.5")
    inc = Pose(torch.as_tensor(R), torch.as_tensor(t))
    h, w, _ = pv.shape
    _, lin, inb = iw._project(inc, cv, cn, h, w, INTR)
    read = torch.zeros(h * w, dtype=torch.bool)
    read[lin[inb]] = True
    n_read = int(iw.icp_normal_eqs_warped_work(inc, cv, cn, pv, INTR))
    assert n_read == int(read.sum()) and 0.5 * h * w < n_read < h * w
    rng = np.random.default_rng(4)
    keep = read.reshape(h, w, 1)
    pv2 = torch.where(keep, pv, torch.as_tensor(rng.normal(size=pv.shape).astype(np.float32)))
    pn2 = torch.where(keep, pn, torch.as_tensor(rng.normal(size=pn.shape).astype(np.float32)))
    for a, b in zip(icp_normal_eqs_warped_plain(inc, cv, cn, pv, pn, INTR, DIST, SIN),
                    icp_normal_eqs_warped_plain(inc, cv, cn, pv2, pn2, INTR, DIST, SIN)):
        assert torch.equal(a, b)
