"""The port's sharded fused update on two gloo ranks on the CPU, Z- and
Y-sharded, against the port's single-device fused step (which
test_torch_step.py holds against the JAX package's).

tests/test_ysharded.py's configuration: 128^3, the warped kernels forced on
(`fused_mode="on"`, their plain versions here), a 256 px raycast face; its
3-frame translation, then an all-zero frame. One spawn runs both shard
dims. Checked, with tests/test_distributed.py's tolerances: the ranks'
poses equal each other and the single-device step's within 1e-4; the
gathered volume's TSDF beyond 2e-2 on under 0.2% of voxels, weights
differing on under 0.2%, the model maps' 99th percentile gap under 2e-3;
the all-zero frame fails on every rank, resets the frame count and
zeroes every rank's slab (tests/test_distributed.py:95-107).
"""

import numpy as np
import pytest
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import default_test_scene, make_translation_trajectory
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.parallel.mesh import spawn
from kinfu_tpu_torch.parallel.sharded import (
    global_shape,
    init_state_local,
    make_sharded_step_fn,
    unshard_state,
)
from kinfu_tpu_torch.pipeline.kinfu import fused_supported, init_state, make_step_fn
from kinfu_tpu_torch.pipeline.state import state_to_numpy

torch.set_num_threads(2)

RANKS = 2
INTR = Intrinsics(width=160, height=120, fx=140.0, fy=140.0, cx=79.5, cy=59.5)
#: tests/test_ysharded.py's PARAMS
PARAMS = KinFuParams(pyramid_height=1, icp_iters=(3,), volume_dims=(128, 128, 128),
                     volume_range=(3.0, 3.0, 3.0), integrate_mode="warped", icp_mode="warped",
                     raycast_mode="warped", fused_mode="on", raycast_face=(256, 104.0))


def _frames():
    scene = default_test_scene()
    traj = make_translation_trajectory(3, step=(0.004, -0.003, 0.006))
    return [scene.render_frame(T, INTR) for T in traj]


def _rank(mesh, frames):
    """Both shard dims on one rank: per dim, the outputs of each frame, the
    gathered state after the last real frame, and the rank's slab weight
    and frame count after the all-zero frame."""
    import dataclasses

    out = {}
    zero = (np.zeros_like(frames[0][0]), frames[0][1])
    for sd in (0, 1):
        m = dataclasses.replace(mesh, shard_dim=sd)
        state = init_state_local(PARAMS, INTR, m)
        local = state.vol.tsdf.shape
        assert (fused_supported(global_shape(local, m), PARAMS, m.device, sd)
                and fused_supported(local, PARAMS, m.device, sd))
        step = make_sharded_step_fn(PARAMS, INTR, m)
        outs = []
        for d, c in frames:
            state, o = step(state, torch.as_tensor(d), torch.as_tensor(c))
            outs.append((o.pose_matrix.numpy(), bool(o.tracking_ok)))
        full = unshard_state(state, m)
        state, o = step(state, torch.as_tensor(zero[0]), torch.as_tensor(zero[1]))
        out[sd] = dict(outs=outs, full=full, zero_ok=bool(o.tracking_ok),
                       zero_fc=int(state.frame_count),
                       zero_weight=int(state.vol.weight.int().sum()),
                       zero_tsdf=bool(state.vol.tsdf.any()))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    frames = _frames()
    ranks = spawn(_rank, RANKS, frames, device="cpu", threads=1,
                  workdir=str(tmp_path_factory.mktemp("store")))
    step = make_step_fn(PARAMS, INTR)
    state = init_state(PARAMS, INTR, device="cpu")
    outs = []
    for d, c in frames:
        state, o = step(state, torch.as_tensor(d), torch.as_tensor(c))
        outs.append(o.pose_matrix.numpy())
    return ranks, outs, state_to_numpy(state)


@pytest.mark.parametrize("shard_dim", [0, 1], ids=["z", "y"])
def test_fused_sharded_matches_single_device(run, shard_dim):
    ranks, ref_poses, ref = run
    got = [r[shard_dim] for r in ranks]
    for k, want in enumerate(ref_poses):
        pose, ok = got[0]["outs"][k]
        assert ok, k
        np.testing.assert_allclose(pose, want, atol=1e-4, err_msg=f"frame {k}")
        np.testing.assert_array_equal(pose, got[1]["outs"][k][0])
    full = got[0]["full"]
    mismatch = np.abs(full["tsdf"].astype(np.float32) - ref["tsdf"]) / 32767.0 > 2e-2
    assert mismatch.mean() < 2e-3, mismatch.mean()
    assert (full["weight"] != ref["weight"]).mean() < 2e-3
    assert (full["weight"] > 0).sum() > 50_000
    sv, dv = ref["model_vmaps"][0], full["model_vmaps"][0]
    both = (np.abs(sv[..., 2]) > 0) & (np.abs(dv[..., 2]) > 0)
    assert both.sum() > 5000
    assert np.percentile(np.abs(sv - dv).max(axis=-1)[both], 99) < 2e-3


@pytest.mark.parametrize("shard_dim", [0, 1], ids=["z", "y"])
def test_fused_sharded_failure_resets_every_slab(run, shard_dim):
    ranks, _, _ = run
    for r in ranks:
        z = r[shard_dim]
        assert not z["zero_ok"]
        assert z["zero_fc"] == 1
        assert z["zero_weight"] == 0 and not z["zero_tsdf"]
