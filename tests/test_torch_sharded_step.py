"""The port's sharded step and its collectives on two gloo ranks on the CPU
(`torch.distributed`, "spawn" processes meeting at a file store), against
the JAX package and the port's single-device step.

One spawn runs every rank-side check of this file (each spawn costs
seconds of start-up), and the module's tests read its results:

  - the sharded step over tests/test_distributed.py's 4-frame translation
    at 64^3 / 160x120 (its PARAMS: `raycast_mode="step"`, the march
    raycast, and the gather integrate), against the JAX package's
    single-device `make_step_fn` on the same frames, with that test's
    tolerances: poses within 1e-4, TSDF beyond 2e-2 on under 0.2% of
    voxels, weights differing on under 0.2%, the model maps' 99th
    percentile gap under 2e-3 (and above it on under 0.5% of pixels);
    and the final model maps, bit for bit, against the single-device
    march raycast of the gathered volume at the final pose;
  - `halo_exchange` along Z and Y, int16 and float32: each rank's padded
    slab is the whole volume's rows around it, zeros past its ends;
  - K1's row-shard form: `rigid_icp_local` on each rank's rows of a
    118-row frame (59 rows at level 1: one zero row pads it to two shards
    of 30), in the gather and the warped mode, against JAX `rigid_icp` on
    one device: the increment within 1e-5, ok and the inlier count equal;
  - `sweep_sequences`: three sequences over the two ranks (padded to four)
    give each sequence's poses of serial single-device steps, bit for bit
    where both run one thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import (
    default_test_scene,
    make_orbit_trajectory,
    make_translation_trajectory,
)
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.parallel.mesh import Mesh, halo_exchange, spawn
from kinfu_tpu_torch.parallel.sharded import (
    init_state_local,
    make_sharded_step_fn,
    rigid_icp_local,
    row_shard,
    shard_state,
    unshard_state,
)
from kinfu_tpu_torch.pipeline.state import state_from_numpy
from kinfu_tpu_torch.parallel.sweep import sweep_sequences
from kinfu_tpu_torch.pipeline.kinfu import _measurement, init_state, make_step_fn

torch.set_num_threads(2)

RANKS = 2
INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
INTR = Intrinsics(*INTR_T)
#: tests/test_distributed.py's PARAMS
CFG = dict(pyramid_height=2, icp_iters=(4, 8), volume_dims=(64, 64, 64),
           volume_range=(3.0, 3.0, 3.0), raycast_mode="step")
PARAMS = KinFuParams(**CFG)
#: the ICP frame: 118 rows, odd at level 1
ICP_INTR_T = (160, 118, 140.0, 140.0, 79.5, 58.5)
ICP_INTR = Intrinsics(*ICP_INTR_T)
ICP_CFG = dict(pyramid_height=2, icp_iters=(4, 8), volume_dims=(64, 64, 64))
#: the sweep's configuration (raycast "auto": the "hier" march on the CPU)
SWEEP_PARAMS = PARAMS.replace(raycast_mode="auto")
POSE_TOL = 1e-4
ICP_TOL = 1e-5


def _translation_frames():
    scene = default_test_scene()
    traj = make_translation_trajectory(4, step=(0.004, 0.0, 0.006))
    return [scene.render_frame(T, INTR) for T in traj]


def _icp_maps():
    """(current, model) vertex and normal pyramids: two orbit frames'
    measurements, the second as the current frame."""
    scene = default_test_scene()
    maps = []
    for T in make_orbit_trajectory(2, angle_step_deg=0.5):
        depth, _ = scene.render_frame(T, ICP_INTR)
        _, v, n = _measurement(torch.as_tensor(depth), KinFuParams(**ICP_CFG), ICP_INTR)
        maps.append(([a.numpy() for a in v], [a.numpy() for a in n]))
    return maps[1], maps[0]


def _volume(seed: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-32767, 32768, (16, 24, 8)).astype(dtype)


def _random_state(seed: int = 5) -> dict:
    """A state as the numpy fields of `state_from_numpy`, from a seed."""
    rng = np.random.default_rng(seed)
    shape = (16, 24, 8)
    return dict(
        tsdf=rng.integers(-32767, 32768, shape).astype(np.int16),
        weight=rng.integers(0, 65, shape).astype(np.int16),
        color=rng.integers(0, 1 << 24, shape).astype(np.int32),
        pose=np.eye(4, dtype=np.float32) + rng.normal(0, 0.01, (4, 4)).astype(np.float32)
        * np.array([1, 1, 1, 0], np.float32)[:, None],
        model_vmaps=[rng.normal(size=(6 >> i, 8 >> i, 3)).astype(np.float32) for i in range(2)],
        model_nmaps=[rng.normal(size=(6 >> i, 8 >> i, 3)).astype(np.float32) for i in range(2)],
        frame_count=np.asarray(7, np.int32),
    )


def _sweep_sequences():
    scene = default_test_scene()
    out = []
    for step in (0.2, 0.5, 0.8):
        frames = [scene.render_frame(T, INTR)
                  for T in make_orbit_trajectory(3, angle_step_deg=step)]
        out.append((np.stack([d for d, _ in frames]), np.stack([c for _, c in frames])))
    return out


def _rank(mesh, frames, icp_maps, sequences):
    """Every rank-side check of this file on one rank."""
    out = {}
    state = init_state_local(PARAMS, INTR, mesh)
    step = make_sharded_step_fn(PARAMS, INTR, mesh)
    outs = []
    for d, c in frames:
        state, o = step(state, torch.as_tensor(d), torch.as_tensor(c))
        outs.append((o.pose_matrix.numpy(), bool(o.tracking_ok), int(o.icp_inliers)))
    out["step"] = outs, unshard_state(state, mesh)

    halos = []
    for dim, halo, dtype in ((0, 3, np.int16), (1, 8, np.int16), (0, 2, np.float32)):
        whole = torch.as_tensor(_volume(dim + halo, dtype))
        Ll = whole.shape[dim] // mesh.world
        slab = whole.narrow(dim, mesh.rank * Ll, Ll).contiguous()
        halos.append(halo_exchange(mesh, slab, halo, dim).numpy())
    out["halo"] = halos

    (cv, cn), (pv, pn) = icp_maps
    out["icp"] = {}
    for mode in ("gather", "warped"):
        params = KinFuParams(**ICP_CFG, icp_mode=mode)
        res = rigid_icp_local([row_shard(torch.as_tensor(a), mesh) for a in cv],
                              [row_shard(torch.as_tensor(a), mesh) for a in cn],
                              [torch.as_tensor(a) for a in pv], [torch.as_tensor(a) for a in pn],
                              ICP_INTR, params, mesh)
        out["icp"][mode] = (res.pose.R.numpy(), res.pose.t.numpy(), bool(res.ok),
                            int(res.num_inliers))
    out["sweep"] = sweep_sequences(sequences, SWEEP_PARAMS, INTR, mesh)
    out["roundtrip"] = [unshard_state(shard_state(_random_state(), m), m)
                        for m in (dataclasses.replace(mesh, shard_dim=sd) for sd in (0, 1))]
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    frames = _translation_frames()
    icp_maps = _icp_maps()
    (cv, cn), (pv, pn) = icp_maps
    jax = torch_jaxref.start(
        [("kinfu_track", dict(params_kw=tuple(CFG.items()), intr=INTR_T,
                              sequences=[frames]))]
        + [("rigid_icp", dict(cur_vmaps=cv, cur_nmaps=cn, pre_vmaps=pv, pre_nmaps=pn,
                              intr=ICP_INTR_T,
                              params_kw=tuple(dict(ICP_CFG, icp_mode=mode).items())))
           for mode in ("gather", "warped")])
    ranks = spawn(_rank, RANKS, frames, icp_maps, _sweep_sequences(), device="cpu",
                  threads=1, workdir=str(tmp_path_factory.mktemp("store")))
    return ranks, jax.result()


def test_sharded_step_matches_jax_single_device(run):
    ranks, (track, *_) = run
    ref = track[0]
    outs, full = ranks[0]["step"]
    for k, ((pose, ok, _), want) in enumerate(zip(outs, ref)):
        assert ok and want["tracking_ok"], k
        np.testing.assert_allclose(pose, want["pose_matrix"], atol=POSE_TOL, err_msg=f"frame {k}")
        np.testing.assert_array_equal(pose, ranks[1]["step"][0][k][0])
    last = ref[-1]
    mismatch = np.abs(full["tsdf"].astype(np.float32) - last["tsdf"]) / 32767.0 > 2e-2
    assert mismatch.mean() < 2e-3, mismatch.mean()
    assert (full["weight"] != last["weight"]).mean() < 2e-3
    assert (full["weight"] > 0).sum() > 10_000
    sv, dv = last["model_vmaps"][0], full["model_vmaps"][0]
    both = (np.abs(sv[..., 2]) > 0) & (np.abs(dv[..., 2]) > 0)
    diff = np.abs(sv - dv).max(axis=-1)[both]
    assert both.sum() > 5000
    assert np.percentile(diff, 99) < 2e-3
    assert (diff > 2e-3).mean() < 5e-3
    assert ((np.abs(sv[..., 2]) > 0) != (np.abs(dv[..., 2]) > 0)).mean() < 5e-3


def test_sharded_march_model_map_is_the_unsharded_march(run):
    """The sharded march raycast (each rank's slab with its halo, k_start
    and t_end, the pmin composite, one winning rank a pixel, the masked
    psum) gives the model maps of the single-device "step" raycast of the
    gathered volume at the final pose, bit for bit."""
    from kinfu_tpu_torch.geometry.se3 import compose, inverse
    from kinfu_tpu_torch.pipeline.kinfu import _volume_pose
    from kinfu_tpu_torch.volume.raycast import raycast

    ranks, _ = run
    outs, full = ranks[0]["step"]
    assert outs[-1][1]
    state = state_from_numpy(full, device="cpu")
    cam2vol = compose(inverse(_volume_pose(PARAMS, "cpu")), state.pose)
    rv, rn = raycast(state.vol, cam2vol, INTR, PARAMS)
    np.testing.assert_array_equal(rv.numpy(), full["model_vmaps"][0])
    np.testing.assert_array_equal(rn.numpy(), full["model_nmaps"][0])
    assert (np.abs(full["model_vmaps"][0][..., 2]) > 0).sum() > 5000


@pytest.mark.parametrize("case", range(3), ids=["z int16", "y int16", "z float32"])
def test_halo_exchange_is_the_neighbours_rows(run, case):
    ranks, _ = run
    dim, halo, dtype = ((0, 3, np.int16), (1, 8, np.int16), (0, 2, np.float32))[case]
    whole = _volume(dim + halo, dtype)
    L = whole.shape[dim]
    Ll = L // RANKS
    for r in range(RANKS):
        got = ranks[r]["halo"][case]
        assert got.dtype == dtype
        lo, hi = r * Ll - halo, (r + 1) * Ll + halo
        pad = [(0, 0)] * 3
        pad[dim] = (max(0, -lo), max(0, hi - L))
        want = np.pad(np.take(whole, range(max(lo, 0), min(hi, L)), axis=dim), pad)
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


@pytest.mark.parametrize("mode", ["gather", "warped"])
def test_row_shard_icp_matches_jax(run, mode):
    ranks, (_, *icp) = run
    R, t, ok, n = icp[["gather", "warped"].index(mode)]
    for r in range(RANKS):
        Rk, tk, okk, nk = ranks[r]["icp"][mode]
        assert okk and ok
        assert nk == n > 1000
        np.testing.assert_allclose(Rk, R, atol=ICP_TOL)
        np.testing.assert_allclose(tk, t, atol=ICP_TOL)
    # 59 rows at level 1: one zero row pads the second shard
    mesh = Mesh(world=RANKS, rank=1, device=torch.device("cpu"), backend="gloo")
    assert row_shard(torch.zeros(59, 80, 3), mesh).shape[0] == 30
    assert not bool(row_shard(torch.ones(59, 80, 3), mesh)[-1].any())


def test_sweep_sequences_match_serial_steps(run):
    ranks, _ = run
    seqs = _sweep_sequences()
    results = ranks[0]["sweep"]
    assert len(results) == len(seqs)
    step = make_step_fn(SWEEP_PARAMS, INTR)
    # one thread, as the ranks run: the ICP's Gram products then sum in the
    # same order, and the poses are the serial ones bit for bit
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for (depths, colors), (poses, oks) in zip(seqs, results):
            assert oks.all()
            st = init_state(SWEEP_PARAMS, INTR, device="cpu")
            for f in range(depths.shape[0]):
                st, o = step(st, torch.as_tensor(depths[f]), torch.as_tensor(colors[f]))
                np.testing.assert_array_equal(poses[f], o.pose_matrix.numpy())
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(results, ranks[1]["sweep"]):
        np.testing.assert_array_equal(a[0], b[0])


def test_backend_is_an_argument(monkeypatch):
    """`init_mesh` takes the backend it is given and never switches: NCCL
    with two ranks on one card raises, as does NCCL on the CPU, an unknown
    backend, and a rank on the card without CUDA."""
    from kinfu_tpu_torch.parallel.mesh import init_mesh

    store = "file:///nonexistent/store"
    with pytest.raises(ValueError, match="gloo' or 'nccl"):
        init_mesh("mpi", 0, 2, store, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA devices"):
        init_mesh("nccl", 0, 2, store, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_mesh("gloo", 0, 2, store)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="a card per rank: 2 ranks, 1 cards"):
        init_mesh("nccl", 1, 2, store)


def _same_state(got: dict, want: dict, tag: str) -> None:
    for key in ("tsdf", "weight", "color", "pose", "frame_count"):
        np.testing.assert_array_equal(np.asarray(got[key]), want[key], err_msg=f"{tag} {key}")
    for key in ("model_vmaps", "model_nmaps"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"{tag} {key}")


@pytest.mark.parametrize("shard_dim", [0, 1], ids=["z", "y"])
def test_shard_state_roundtrip(run, shard_dim):
    """`shard_state` then `unshard_state` on two ranks gives the whole state
    back, int16 bits included."""
    ranks, _ = run
    for r in ranks:
        _same_state(r["roundtrip"][shard_dim], _random_state(), f"rank {r}")


@pytest.mark.parametrize("shard_dim", [0, 1], ids=["z", "y"])
def test_shard_state_takes_either_package(shard_dim):
    """`shard_state` cuts the same slab from a JAX `KinFuState`, a port
    `KinFuState` and their numpy fields, built from one seed."""
    import jax.numpy as jnp

    from kinfu_tpu.geometry.se3 import pose_from_matrix as jpose
    from kinfu_tpu.pipeline.state import KinFuState as JState
    from kinfu_tpu.volume.tsdf import TSDFVolume as JVol

    d = _random_state()
    jax_state = JState(
        vol=JVol(*(jnp.asarray(d[k]) for k in ("tsdf", "weight", "color"))),
        pose=jpose(jnp.asarray(d["pose"])),
        model_vmaps=tuple(jnp.asarray(m) for m in d["model_vmaps"]),
        model_nmaps=tuple(jnp.asarray(m) for m in d["model_nmaps"]),
        frame_count=jnp.asarray(d["frame_count"]))
    port_state = state_from_numpy(d, device="cpu")
    for r in range(RANKS):
        mesh = Mesh(world=RANKS, rank=r, device=torch.device("cpu"), backend="gloo",
                    shard_dim=shard_dim)
        Ll = d["tsdf"].shape[shard_dim] // RANKS
        want = dict(d, **{k: np.take(d[k], range(r * Ll, (r + 1) * Ll), axis=shard_dim)
                          for k in ("tsdf", "weight", "color")})
        for name, state in (("jax", jax_state), ("port", port_state), ("numpy", d)):
            got = shard_state(state, mesh)
            host = dict(tsdf=got.vol.tsdf.numpy(), weight=got.vol.weight.numpy(),
                        color=got.vol.color.numpy(),
                        pose=torch.cat([torch.cat([got.pose.R, got.pose.t[:, None]], 1),
                                        torch.tensor([[0.0, 0.0, 0.0, 1.0]])]).numpy(),
                        model_vmaps=[m.numpy() for m in got.model_vmaps],
                        model_nmaps=[m.numpy() for m in got.model_nmaps],
                        frame_count=got.frame_count.numpy())
            _same_state(host, want, f"{name} rank {r}")
