"""The per-ray properties that the march kernels rely on, on the plain
twins (kinfu_tpu_torch/volume/raycast.py).

M1 (`march_rays`, csrc/march_rays.cu) and M2 (`march_hier_rays`,
csrc/march_hier.cu) run one thread per ray, each looping until its own
stop, where the twins (`march`, `march_hier`) and the JAX package loop over
all rays in lockstep until none is alive. The two give the same events only
if a ray's events depend on nothing but its own inputs and its own step
count. These tests hold that property on the twins, bit for bit, at the
64^3 / 96x72 and 128^3 / 160x120 scales of tests/test_torch_volume.py:
  - a subset of rays (random pixels drawn with numpy, plus grazing,
    axis-parallel and gated rays), marched alone, gives the events those
    rays have in the full image; for `march`, `march_hier` and the Z-slab
    form (a halo-padded slab with per-ray k_start and t_end), from a camera
    outside the volume and one inside it;
  - the same with an iteration bound small enough to cut rays;
  - `march`'s default bound reads no tensor (`Tensor.tolist` raising) and
    gives the events of the explicit `march_steps_bound`;
  - the work counts behind the kernels' bounds in chip_smoke.py
    (`march_work`, `march_hier_work`): a ray subset and the rest add up to
    the full set's iterations and read sets, the read set is all that the
    events depend on (every other voxel and cell redrawn, the same events
    bit for bit), and a ray in an empty volume steps exactly as far as its
    t_end.
The events of the twins against JAX's are tests/test_torch_volume.py's;
the kernels against the twins are chip_smoke.py phase 4e's.
"""

import numpy as np
import pytest
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix
from kinfu_tpu_torch.parallel.sharded import HALO, _local_t_interval
from kinfu_tpu_torch.tools.sanitize import padded_slab
from kinfu_tpu_torch.volume import raycast as rc
from kinfu_tpu_torch.volume.integrate import integrate
from kinfu_tpu_torch.volume.tsdf import create_volume

torch.set_num_threads(2)

CPU = torch.device("cpu")
#: (volume side, range in metres, frame width, height, focal)
SCALES = {"64": (64, 2.0, 96, 72, 78.75), "128": (128, 3.0, 160, 120, 140.0)}
#: pixels drawn at random for the subsets
N_PICK = 400
#: ranks of the slab form and the interior slab taken
RANKS, SLAB = 4, 1


def _setup(scale: str):
    dim, rng_m, w, h, f = SCALES[scale]
    params = KinFuParams(volume_dims=(dim,) * 3, volume_range=(rng_m,) * 3, pyramid_height=1,
                         icp_iters=(3,))
    intr = Intrinsics(width=w, height=h, fx=f, fy=f, cx=w / 2 - 0.5, cy=h / 2 - 0.5)
    return params, intr


@pytest.fixture(scope="module", params=sorted(SCALES))
def fused(request):
    """(params, intr, tsdf): three orbit frames fused by the gather integrate."""
    params, intr = _setup(request.param)
    scene = default_test_scene()
    volp = pose_from_matrix(torch.as_tensor(params.volume_pose))
    vol = create_volume(params.volume_dims, device="cpu")
    for T in make_orbit_trajectory(3, angle_step_deg=3.0):
        d, c = scene.render_frame(T, intr)
        cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32))
        integrate(vol, torch.as_tensor(d * np.float32(params.depth_scale)), torch.as_tensor(c),
                  compose(inverse(cam), volp), intr, params)
    return params, intr, vol.tsdf


#: camera positions in the world: the orbit's start, in front of the volume
#: (z = 0 < its origin's 0.5), and a point inside it
CAMERAS = {"outside": (0.0, 0.0, 0.0), "inside": (0.1, -0.05, 1.2)}
#: extra rays beside the pixels: axis-parallel (exact unit axes), grazing
#: (a component of 1e-13, below the AABB's 1e-12 guard) and oblique
EXTRA_DIRS = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0],
                       [1, 1e-13, 1e-13], [1e-13, 0.6, 0.8], [0.7071068, 0, 0.7071068],
                       [-0.3, 0.2, 0.9327379]], np.float32)


def _rays(params, intr, where: str):
    """(org [3], dirs [N, 3], t_start [N], t_end [N]) of every pixel of a
    camera at CAMERAS[where] (the orbit's rotation), then EXTRA_DIRS; the
    dispatcher's AABB clip, and every 7th pixel gated (t_end -1e30)."""
    T = make_orbit_trajectory(2, angle_step_deg=3.0)[1].copy()
    T[:3, 3] = CAMERAS[where]
    volp = pose_from_matrix(torch.as_tensor(params.volume_pose))
    cam = pose_from_matrix(torch.as_tensor(T, dtype=torch.float32))
    org, dirs = rc.camera_rays(compose(inverse(volp), cam), intr)
    extra = torch.as_tensor(EXTRA_DIRS / np.linalg.norm(EXTRA_DIRS, axis=1, keepdims=True))
    dirs = torch.cat([dirs.reshape(-1, 3), extra.float()])
    step = params.raycast_step_voxels * params.voxel_size[0]
    tnear, tfar = rc.ray_aabb(org, dirs, rc.f32_constant(tuple(params.volume_range), CPU))
    t_start = torch.clamp(tnear, min=0.0) + step
    n_pix = intr.width * intr.height
    gated = torch.zeros(dirs.shape[0], dtype=torch.bool)
    gated[:n_pix:7] = True
    return org.contiguous(), dirs, t_start, torch.where(gated, -1e30, tfar)


def _pick(n_rays: int, n_extra: int, seed: int) -> np.ndarray:
    """N_PICK random pixels (numpy, seeded) and every extra ray, in order."""
    rng = np.random.default_rng(seed)
    pix = rng.choice(n_rays - n_extra, N_PICK, replace=False)
    return np.sort(np.concatenate([pix, np.arange(n_rays - n_extra, n_rays)]))


def _march_fn(kind: str, params, tsdf, bound=None):
    """march(org, dirs, t_start, t_end, k_start) for `kind`: "march", "hier"
    or "slab" (SLAB of RANKS, padded with HALO rows; `k_start` and t_end
    from _local_t_interval on the ray subset given)."""
    vs = params.voxel_size
    step = params.raycast_step_voxels * vs[0]
    inv_vs = rc.inv_voxel_size(vs, CPU)
    dims = tuple(tsdf.shape)
    if kind == "march":
        return lambda o, d, ts, te: rc.march(tsdf, dims, 0, o, d, ts, te, step, inv_vs,
                                             max_steps=bound)
    if kind == "hier":
        occ = rc.build_occupancy(tsdf)
        return lambda o, d, ts, te: rc.march_hier(tsdf, occ, o, d, ts, te, step, inv_vs,
                                                  max_iters=bound)
    Zl = dims[0] // RANKS
    padded = padded_slab(tsdf, 0, SLAB, RANKS, HALO)
    z_lo = float(np.float32(SLAB * Zl) * np.float32(vs[2]))
    z_hi = float(np.float32((SLAB + 1) * Zl) * np.float32(vs[2]))

    def slab(o, d, ts, te):
        k_lo, t_hi = _local_t_interval(o[2], d[..., 2], z_lo, z_hi, ts, te, step)
        return rc.march(padded, dims, SLAB * Zl - HALO, o, d, ts, t_hi, step, inv_vs,
                        k_start=k_lo, max_steps=bound)

    return slab


def _hits(res) -> int:
    return int(((res.hit_t < res.back_t) & (res.hit_t < 1e30)).sum())


def _check_subsets(fn, params, intr, seed: int):
    """The events of each camera's ray subset marched alone equal those
    rays' events in the full set, bit for bit; returns the full sets'
    results."""
    out = []
    for k, where in enumerate(sorted(CAMERAS)):
        org, dirs, ts, te = _rays(params, intr, where)
        full = fn(org, dirs, ts, te)
        idx = torch.as_tensor(_pick(ts.numel(), len(EXTRA_DIRS), seed + k))
        part = fn(org, dirs[idx].contiguous(), ts[idx], te[idx])
        for a, b, name in zip(part, full, ("hit_t", "back_t")):
            np.testing.assert_array_equal(a.numpy(), b[idx].numpy(), err_msg=f"{where} {name}")
        assert _hits(part) > 20, where
        out.append(full)
    return out


@pytest.mark.parametrize("kind", ["march", "hier", "slab"])
def test_subset_marched_alone_gives_full_image_events(fused, kind):
    params, intr, tsdf = fused
    _check_subsets(_march_fn(kind, params, tsdf), params, intr, seed=11)


@pytest.mark.parametrize("kind", ["march", "hier"])
def test_cut_rays_keep_their_events_alone(fused, kind):
    """With a bound that cuts rays short, the subsets still give the full
    set's events; the bound does cut (fewer hits than without it)."""
    params, intr, tsdf = fused
    dim = tsdf.shape[0]
    bound = dim // 2 if kind == "march" else dim // 4
    cut = _check_subsets(_march_fn(kind, params, tsdf, bound), params, intr, seed=23)
    org, dirs, ts, te = _rays(params, intr, "inside")
    whole = _march_fn(kind, params, tsdf)(org, dirs, ts, te)
    assert _hits(cut[0]) < _hits(whole)
    assert not torch.equal(cut[0].hit_t, whole.hit_t)


def test_default_max_steps_reads_no_tensor(fused, monkeypatch):
    """march's default, no bound (as JAX's), reads no tensor: with
    Tensor.tolist raising, it gives the events of the explicit
    march_steps_bound, which no ray outlasts."""
    params, intr, tsdf = fused
    vs = params.voxel_size
    step = params.raycast_step_voxels * vs[0]
    inv_vs = rc.inv_voxel_size(vs, CPU)
    dims = tuple(tsdf.shape)
    org, dirs, ts, te = _rays(params, intr, "inside")
    want = rc.march(tsdf, dims, 0, org, dirs, ts, te, step, inv_vs,
                    max_steps=rc.march_steps_bound(dims, vs, step))

    def no_tolist(self):
        raise AssertionError("march read a tensor to find its bound")

    monkeypatch.setattr(torch.Tensor, "tolist", no_tolist)
    got = rc.march(tsdf, dims, 0, org, dirs, ts, te, step, inv_vs, max_steps=None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert _hits(want) > 100


def test_wrappers_take_the_twins_on_the_cpu(fused):
    """A CPU tensor takes the plain twin: march_rays is march and
    march_hier_rays is march_hier, bit for bit, the slab form included."""
    params, intr, tsdf = fused
    vs = params.voxel_size
    step = params.raycast_step_voxels * vs[0]
    inv_vs = rc.inv_voxel_size(vs, CPU)
    dims = tuple(tsdf.shape)
    org, dirs, ts, te = _rays(params, intr, "outside")
    occ = rc.build_occupancy(tsdf)
    k = torch.full(ts.shape, 3, dtype=torch.int32)
    pairs = [
        (rc.march_rays(tsdf, dims, 0, org, dirs, ts, te, step, inv_vs, k_start=k),
         rc.march(tsdf, dims, 0, org, dirs, ts, te, step, inv_vs, k_start=k)),
        (rc.march_hier_rays(tsdf, occ, org, dirs, ts, te, step, inv_vs),
         rc.march_hier(tsdf, occ, org, dirs, ts, te, step, inv_vs)),
    ]
    for got, want in pairs:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def _work_fn(kind: str, params, tsdf, occ=None):
    """(events fn, work fn) of `kind` ("march", "hier" or "slab") on `tsdf`
    (and `occ` for "hier"), each taking (org, dirs, t_start, t_end): the
    work fn returns (read flags, counts) as `march_work` /
    `march_hier_work` fill them."""
    vs = params.voxel_size
    step = params.raycast_step_voxels * vs[0]
    inv_vs = rc.inv_voxel_size(vs, CPU)
    dims = tuple(tsdf.shape)
    if kind == "hier":
        occ = rc.build_occupancy(tsdf) if occ is None else occ

        def run(o, d, ts, te, work=None):
            return rc.march_hier(tsdf, occ, o, d, ts, te, step, inv_vs, work=work)
        n_read = tsdf.numel() + occ.numel()
    elif kind == "march":
        def run(o, d, ts, te, work=None):
            return rc.march(tsdf, dims, 0, o, d, ts, te, step, inv_vs, work=work)
        n_read = tsdf.numel()
    else:
        Zl = dims[0] // RANKS
        padded = padded_slab(tsdf, 0, SLAB, RANKS, HALO)
        z_lo = float(np.float32(SLAB * Zl) * np.float32(vs[2]))
        z_hi = float(np.float32((SLAB + 1) * Zl) * np.float32(vs[2]))

        def run(o, d, ts, te, work=None):
            k_lo, t_hi = _local_t_interval(o[2], d[..., 2], z_lo, z_hi, ts, te, step)
            return rc.march(padded, dims, SLAB * Zl - HALO, o, d, ts, t_hi, step, inv_vs,
                            k_start=k_lo, work=work)
        n_read = padded.numel()

    def work(o, d, ts, te):
        w = rc._new_work(n_read, CPU)
        run(o, d, ts, te, w)
        return w.read, w.counts

    return run, work


@pytest.mark.parametrize("kind", ["march", "hier", "slab"])
def test_work_counts_add_over_ray_subsets(fused, kind):
    """A random subset of rays and the rest count the full set's
    iterations between them, and their read sets join to the full set's:
    each ray's work is its own, as its events are."""
    params, intr, tsdf = fused
    _, work = _work_fn(kind, params, tsdf)
    org, dirs, ts, te = _rays(params, intr, "inside")
    idx = torch.as_tensor(_pick(ts.numel(), len(EXTRA_DIRS), 31))
    rest = torch.ones(ts.numel(), dtype=torch.bool)
    rest[idx] = False
    read, counts = work(org, dirs, ts, te)
    read_a, counts_a = work(org, dirs[idx].contiguous(), ts[idx], te[idx])
    read_b, counts_b = work(org, dirs[rest].contiguous(), ts[rest], te[rest])
    assert torch.equal(counts, counts_a + counts_b)
    assert torch.equal(read, read_a | read_b)
    n_iter = int(counts[0] + counts[2])
    assert 0 < int(counts[1]) <= int(counts[0])
    assert 0 < int(read.sum()) <= n_iter + ts.numel()


@pytest.mark.parametrize("kind", ["march", "hier"])
def test_events_depend_on_the_read_set_only(fused, kind):
    """Every voxel (and occupancy cell) outside the read set redrawn at
    random (numpy, seeded): the same events bit for bit, so the read set
    is what the kernel's byte bound must count."""
    params, intr, tsdf = fused
    occ = rc.build_occupancy(tsdf)
    run, work = _work_fn(kind, params, tsdf, occ)
    org, dirs, ts, te = _rays(params, intr, "outside")
    want = run(org, dirs, ts, te)
    read, _ = work(org, dirs, ts, te)
    rng = np.random.default_rng(5)
    n = tsdf.numel()
    noise = torch.as_tensor(rng.integers(-32767, 32768, n, dtype=np.int16))
    redrawn = torch.where(read[:n], tsdf.reshape(-1), noise).reshape(tsdf.shape)
    cells = torch.as_tensor(rng.random(occ.numel()) < 0.5)
    occ2 = torch.where(read[n:], occ.reshape(-1), cells).reshape(occ.shape) if kind == "hier" \
        else occ
    again, _ = _work_fn(kind, params, redrawn, occ2)
    got = again(org, dirs, ts, te)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not torch.equal(redrawn, tsdf)
    assert _hits(want) > 100


def test_work_steps_to_t_end_in_an_empty_volume(fused):
    """In a volume with no surface, a ray with t_end = t_start + (n + 0.5)
    step takes n + 1 iterations (the last one finds t_end passed); gated
    rays take none; and only valid samples are read."""
    params, intr, tsdf = fused
    empty = torch.full_like(tsdf, 32767)
    _, work = _work_fn("march", params, empty)
    org, dirs, ts, te = _rays(params, intr, "inside")
    step = params.raycast_step_voxels * params.voxel_size[0]
    gated = te < -1e29
    n = torch.as_tensor(np.random.default_rng(3).integers(0, 8, ts.numel()))
    te2 = torch.where(gated, te, ts + (n.float() + 0.5) * step)
    read, counts = work(org, dirs, ts, te2)
    assert int(counts[0]) == int((n + 1)[~gated].sum())
    assert int(counts[1]) <= int(counts[0]) and int(counts[2]) == 0
    assert 0 < int(read.sum()) <= int(counts[0]) + int((~gated).sum())
