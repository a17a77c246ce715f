"""JAX references for the port's parity tests, evaluated without fused
multiply-adds in a child process.

XLA:CPU contracts `a * b + c` into one fused multiply-add wherever the
host CPU has FMA3, and so rounds once where the JAX program as written,
the port's plain PyTorch versions and its CUDA kernels (built with
-fmad=false) round twice. A `rint` of such a result can then pick another
voxel or face pixel, which rules out bit-exact comparisons. `run` evaluates
reference functions of this module in a child process started with
`--xla_cpu_max_isa=AVX` (no FMA instructions), so both sides evaluate the
same float32 operations in the same order. Pallas kernels run in interpret
mode, as the JAX package's own tests run them.

Every reference takes and returns plain Python values and numpy arrays.
`run([(name, kwargs), ...])` returns their results in order, from one
child process: the JAX import and the compiles are paid once per call.
`start` launches the child and returns at once, so that a test can run
the port meanwhile; `Job.result()` waits for it. The child keeps XLA on
one thread: the test workers already share the cores.

XLA's algebraic simplifier also rewrites `a / sqrt(b)` into
`a * rsqrt(b)`. With AVX, XLA:CPU computes rsqrt from the processor's
reciprocal square root estimate and one Newton step, which is off by an
ulp on ~20% of inputs and is not reproducible elsewhere; with at most
SSE4.2 it computes 1 / sqrt(b), rounding twice. A reference whose result
hangs on such a quotient runs with `isa="SSE4_2"`.

    python tests/torch_jaxref.py DIR   # the child: DIR/in.pkl -> DIR/out.pkl
"""

from __future__ import annotations

import functools
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
XLA_FLAGS = "--xla_cpu_max_isa={isa} --xla_cpu_multi_thread_eigen=false"


class Job:
    """A running child process evaluating a list of references."""

    def __init__(self, calls, isa: str = "AVX"):
        env = dict(os.environ, XLA_FLAGS=XLA_FLAGS.format(isa=isa), JAX_PLATFORMS="cpu")
        self._dir = tempfile.TemporaryDirectory()
        with open(Path(self._dir.name) / "in.pkl", "wb") as f:
            pickle.dump(list(calls), f)
        self._proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), self._dir.name],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def result(self, timeout: float = 900.0):
        try:
            _, err = self._proc.communicate(timeout=timeout)
            if self._proc.returncode != 0:
                raise RuntimeError(f"JAX reference process failed:\n{err[-4000:]}")
            with open(Path(self._dir.name) / "out.pkl", "rb") as f:
                return pickle.load(f)
        finally:
            if self._proc.poll() is None:
                self._proc.kill()
                self._proc.wait()
            self._dir.cleanup()


def start(calls, isa: str = "AVX") -> Job:
    """Start evaluating [(reference name, kwargs), ...] in a child process
    whose XLA emits no FMA and uses at most the instruction set `isa`."""
    return Job(calls, isa)


def run(calls, timeout: float = 900.0, isa: str = "AVX"):
    """[(reference name, kwargs), ...] -> [result, ...]."""
    return start(calls, isa).result(timeout)


# ---- references (run in the child) ---------------------------------------


def _intr(i):
    from kinfu_tpu.geometry.intrinsics import Intrinsics

    return Intrinsics(*i)


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _build_face_fn(intr, spec):
    import jax

    from kinfu_tpu.ops import facewarp

    fs = facewarp.FaceSpec(*spec)
    return jax.jit(lambda d, c, a: facewarp._build_face_jnp(d, c, a, _intr(intr), fs))


def build_face_jnp(depth_m, col_packed, A, intr, spec):
    """facewarp._build_face_jnp: (range_mm i16, colour i32) stacks."""
    return _np(_build_face_fn(tuple(intr), tuple(spec))(depth_m, col_packed, A))


@functools.lru_cache(maxsize=None)
def _integrate_fn(intr, params_kw, spec, faces):
    import jax

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.geometry.se3 import Pose
    from kinfu_tpu.ops.facewarp import FaceSpec
    from kinfu_tpu.ops.pallas_integrate import integrate_warped
    from kinfu_tpu.volume.tsdf import TSDFVolume

    params = KinFuParams(**dict(params_kw))

    def fn(tsdf, weight, color, depth_m, color_rgb, R, t):
        vol = integrate_warped(TSDFVolume(tsdf, weight, color), depth_m, color_rgb,
                               Pose(R, t), _intr(intr), params, spec=FaceSpec(*spec),
                               interpret=True, faces=faces)
        return vol.tsdf, vol.weight, vol.color

    return jax.jit(fn)


def integrate_warped(vol, depth_m, color_rgb, R, t, intr, params_kw, spec, faces):
    """pallas_integrate.integrate_warped (interpret): (tsdf, weight, colour)."""
    fn = _integrate_fn(tuple(intr), tuple(params_kw), tuple(spec), faces)
    return _np(fn(*vol, depth_m, color_rgb, R, t))


def faces_needed(R, t, intr):
    """pallas_integrate.faces_needed: {face name: bool}."""
    import jax.numpy as jnp

    from kinfu_tpu.geometry.se3 import Pose
    from kinfu_tpu.ops.pallas_integrate import faces_needed as fn

    return {k: bool(v) for k, v in fn(Pose(jnp.asarray(R), jnp.asarray(t)),
                                      _intr(intr)).items()}


@functools.lru_cache(maxsize=None)
def _sweep_fn(vs_p, spec):
    import jax

    from kinfu_tpu.ops.pallas_raycast import RaySpec, _sweep_face_rays

    return jax.jit(lambda tp, o: _sweep_face_rays(tp, o, vs_p, RaySpec(*spec), True))


def sweep_face_rays(tsdf_p, origin_p, vs_p, spec):
    """pallas_raycast._sweep_face_rays (interpret): (hit, back) [F, F]."""
    return _np(_sweep_fn(tuple(vs_p), tuple(spec))(tsdf_p, origin_p))


@functools.lru_cache(maxsize=None)
def _sweep_shard_fn(vs_p, spec, dims_global):
    import jax

    from kinfu_tpu.ops.pallas_raycast import RaySpec, _sweep_face_rays

    return jax.jit(lambda tp, o, p0, r0: _sweep_face_rays(
        tp, o, vs_p, RaySpec(*spec), True, dims_global=dims_global, plane0=p0, row0=r0))


def sweep_face_rays_shard(tsdf_p, origin_p, vs_p, spec, dims_global, plane0, row0):
    """pallas_raycast._sweep_face_rays (interpret) on a slab of a primed
    volume of `dims_global`, starting at global plane `plane0` / row
    `row0`: (hit, back) [F, F]."""
    return _np(_sweep_shard_fn(tuple(vs_p), tuple(spec), tuple(dims_global))(
        tsdf_p, origin_p, plane0, row0))


def integrate_shard(tsdf, weight, color, depth_m, color_rgb, R, t, intr, params_kw, z_offset,
                    shard_dim, spec=None):
    """volume.integrate.integrate (the dispatcher, its mode from the
    configuration) on a slab whose first voxel along `shard_dim` is global
    index `z_offset`, jitted: (tsdf, weight, colour). In warped mode, with
    `spec`, the face spec of its sweeps (the dispatcher's own call passes
    none)."""
    from unittest import mock

    import jax

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.geometry.se3 import Pose
    from kinfu_tpu.ops import pallas_integrate
    from kinfu_tpu.ops.facewarp import FaceSpec
    from kinfu_tpu.volume.integrate import integrate as fn
    from kinfu_tpu.volume.tsdf import TSDFVolume

    params = KinFuParams(**dict(params_kw))
    warped = pallas_integrate.integrate_warped
    with mock.patch.object(pallas_integrate, "integrate_warped", lambda *a, **k: warped(
            *a, **k, interpret=True, **({} if spec is None else {"spec": FaceSpec(*spec)}))):
        v = jax.jit(lambda *a: fn(TSDFVolume(*a[:3]), a[3], a[4], Pose(a[5], a[6]), _intr(intr),
                                  params, z_offset=z_offset, shard_dim=shard_dim))(
            tsdf, weight, color, depth_m, color_rgb, R, t)
    return _np((v.tsdf, v.weight, v.color))


@functools.lru_cache(maxsize=None)
def _face_fields_fn(spec):
    import jax

    from kinfu_tpu.ops.pallas_raycast import RaySpec, _face_fields

    return jax.jit(lambda h, b, o: _face_fields(h, b, o, RaySpec(*spec)))


def face_fields(hit, back, origin_p, spec):
    """pallas_raycast._face_fields: (t, normal', valid) on the face grid."""
    return _np(_face_fields_fn(tuple(spec))(hit, back, origin_p))


@functools.lru_cache(maxsize=None)
def _resample_fn(intr, spec):
    import jax

    from kinfu_tpu.ops.pallas_raycast import RaySpec, _resample_face

    return jax.jit(lambda t, n, a: _resample_face(t, n, a, _intr(intr), RaySpec(*spec), True))


def resample_face(t_f, n_f, A, intr, spec):
    """pallas_raycast._resample_face (interpret): camera-grid (t, normal')."""
    return _np(_resample_fn(tuple(intr), tuple(spec))(t_f, n_f, A))


def face_pass_parts(tsdf_p, origin_p, vs_p, A, intr, spec, face=None, R=None, t=None,
                    params_kw=None):
    """One face of pallas_raycast._face_pass, stage by stage: the sweep
    (interpret), `_face_fields` on its events and `_resample_face`
    (interpret) on those fields. With `face` (a face frame's name), the
    camera pose (R, t) and the configuration, also `_face_pass` itself on
    those stages' results (its sweep and resample return them instead of
    running again): camera-grid p_v, n_v (volume frame), ok and own."""
    hit, back = sweep_face_rays(tsdf_p, origin_p, vs_p, spec)
    t_f, n_f, ok = face_fields(hit, back, origin_p, spec)
    t_cam, n_cam = resample_face(t_f, n_f, A, intr, spec)
    out = dict(hit=hit, back=back, t_f=t_f, n_f=n_f, ok=ok, t_cam=t_cam, n_cam=n_cam)
    if face is not None:
        from unittest import mock

        import jax.numpy as jnp

        from kinfu_tpu.config import KinFuParams
        from kinfu_tpu.geometry.se3 import Pose
        from kinfu_tpu.ops import pallas_raycast as pr
        from kinfu_tpu.ops.facewarp import face_frames

        frame = {fr.name: fr for fr in face_frames()}[face]
        dims = KinFuParams(**dict(params_kw)).volume_dims
        with mock.patch.object(pr, "_sweep_face_rays", lambda *a: (hit, back)), \
                mock.patch.object(pr, "_resample_face", lambda *a: (t_cam, n_cam)):
            p_v, n_v, ok_cam, own = pr._face_pass(
                jnp.zeros(tuple(reversed(dims)), jnp.int16), frame,
                Pose(jnp.asarray(R), jnp.asarray(t)), _intr(intr),
                KinFuParams(**dict(params_kw)), pr.RaySpec(*spec), True)
        out.update(_np(dict(p_v=p_v, n_v=n_v, ok_cam=ok_cam, own=own)))
    return out


@functools.lru_cache(maxsize=None)
def _icp_warped_fn(intr, dist, sin):
    import jax

    from kinfu_tpu.geometry.se3 import Pose
    from kinfu_tpu.ops.pallas_icp import icp_normal_eqs_warped

    return jax.jit(lambda R, t, cv, cn, pv, pn: icp_normal_eqs_warped(
        Pose(R, t), cv, cn, pv, pn, _intr(intr), dist, sin, interpret=True))


def icp_normal_eqs_warped(R, t, cur_vmap, cur_nmap, pre_vmap, pre_nmap, intr, dist, sin):
    """pallas_icp.icp_normal_eqs_warped (interpret): (A, b, inliers)."""
    A, b, n = _icp_warped_fn(tuple(intr), dist, sin)(R, t, cur_vmap, cur_nmap, pre_vmap,
                                                     pre_nmap)
    return np.asarray(A), np.asarray(b), int(n)


def rigid_icp(cur_vmaps, cur_nmaps, pre_vmaps, pre_nmaps, intr, params_kw):
    """tracking.icp.rigid_icp: (R, t, ok, inliers) of the increment."""
    import jax

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.tracking.icp import rigid_icp as fn

    params = KinFuParams(**dict(params_kw))
    res = jax.jit(lambda *m: fn(*m, _intr(intr), params))(
        list(cur_vmaps), list(cur_nmaps), list(pre_vmaps), list(pre_nmaps))
    return (np.asarray(res.pose.R), np.asarray(res.pose.t), bool(res.ok),
            int(res.num_inliers))


def render(eye_t, vmap, nmap):
    """pipeline.render, jitted as the session runs it: (phong, normals)."""
    import jax

    from kinfu_tpu.pipeline.render import render_normals, render_phong

    return _np((jax.jit(render_phong)(eye_t, vmap, nmap), jax.jit(render_normals)(nmap)))


def extract(tsdf, weight, color, params_kw, max_points):
    """volume.extract at the default volume pose, jitted as the session runs
    it: ((points, count), (points, rgb, count))."""
    import jax

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.pipeline.kinfu import _volume_pose
    from kinfu_tpu.volume.extract import extract_points, extract_points_colored
    from kinfu_tpu.volume.tsdf import TSDFVolume

    params = KinFuParams(**dict(params_kw))
    vol = TSDFVolume(tsdf, weight, color)
    plain = jax.jit(lambda v: extract_points(v, _volume_pose(params), params, max_points))
    colored = jax.jit(
        lambda v: extract_points_colored(v, _volume_pose(params), params, max_points))
    return _np((plain(vol), colored(vol)))


def _state_np(st, o=None):
    """A JAX KinFuState (and StepOutput) as the numpy fields of
    `state_from_numpy` / `state_to_numpy`."""
    from kinfu_tpu.geometry.se3 import pose_matrix

    d = dict(
        tsdf=np.asarray(st.vol.tsdf), weight=np.asarray(st.vol.weight),
        color=np.asarray(st.vol.color), pose=np.asarray(pose_matrix(st.pose)),
        model_vmaps=[np.asarray(m) for m in st.model_vmaps],
        model_nmaps=[np.asarray(m) for m in st.model_nmaps],
        frame_count=np.asarray(st.frame_count),
    )
    if o is not None:
        d.update(pose_matrix=np.asarray(o.pose_matrix), tracking_ok=bool(o.tracking_ok),
                 icp_inliers=int(o.icp_inliers))
    return d


def _state_jax(d):
    """The inverse of `_state_np`."""
    import jax.numpy as jnp

    from kinfu_tpu.geometry.se3 import pose_from_matrix
    from kinfu_tpu.pipeline.state import KinFuState
    from kinfu_tpu.volume.tsdf import TSDFVolume

    return KinFuState(
        vol=TSDFVolume(jnp.asarray(d["tsdf"]), jnp.asarray(d["weight"]),
                       jnp.asarray(d["color"])),
        pose=pose_from_matrix(jnp.asarray(d["pose"], jnp.float32)),
        model_vmaps=tuple(jnp.asarray(m) for m in d["model_vmaps"]),
        model_nmaps=tuple(jnp.asarray(m) for m in d["model_nmaps"]),
        frame_count=jnp.asarray(d["frame_count"], jnp.int32),
    )


def kinfu_track(params_kw, intr, sequences, auto_reset=True):
    """pipeline.kinfu: init_state + one jitted step over each frame sequence;
    returns, per sequence and frame, the state as numpy fields and the
    step's outputs."""
    import jax.numpy as jnp

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.pipeline.kinfu import init_state, make_step_fn

    params = KinFuParams(**dict(params_kw))
    step = make_step_fn(params, _intr(intr), donate=False, auto_reset=auto_reset)
    out = []
    for frames in sequences:
        st, seq = init_state(params, _intr(intr)), []
        for d, c in frames:
            st, o = step(st, jnp.asarray(d), jnp.asarray(c))
            seq.append(_state_np(st, o))
        out.append(seq)
    return out


def streaming_track(params_kw, intr, frames, margin_frac=0.25):
    """pipeline.streaming: init_streaming_state + the jitted streaming step
    over the frames; returns, per frame, the state as numpy fields (with
    "origin_vox") and the step's outputs."""
    import jax.numpy as jnp

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.pipeline.streaming import init_streaming_state, make_streaming_step_fn

    params = KinFuParams(**dict(params_kw))
    step = make_streaming_step_fn(params, _intr(intr), donate=False, margin_frac=margin_frac)
    st, out = init_streaming_state(params, _intr(intr)), []
    for d, c in frames:
        st, o = step(st, jnp.asarray(d), jnp.asarray(c))
        out.append(dict(_state_np(st.kinfu, o), origin_vox=np.asarray(st.origin_vox)))
    return out


def relocalize_step(state, depth, color, seed_pose, params_kw, intr):
    """pipeline.kinfu.relocalize_step, jitted as the session runs it, on a
    state given as numpy fields: (state', outputs) as numpy fields."""
    import functools

    import jax
    import jax.numpy as jnp

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.pipeline.kinfu import relocalize_step as fn

    params = KinFuParams(**dict(params_kw))
    step = jax.jit(functools.partial(fn, params=params, intr=_intr(intr)))
    st, o = step(_state_jax(state), jnp.asarray(depth), jnp.asarray(color),
                 jnp.asarray(seed_pose, jnp.float32))
    return _state_np(st, o)


def integrate(tsdf, weight, color, depth_m, color_rgb, R, t, intr, params_kw):
    """volume.integrate.integrate (the dispatcher; gather off the TPU),
    jitted: (tsdf, weight, colour)."""
    import jax

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.geometry.se3 import Pose
    from kinfu_tpu.volume.integrate import integrate as fn
    from kinfu_tpu.volume.tsdf import TSDFVolume

    params = KinFuParams(**dict(params_kw))
    v = jax.jit(lambda *a: fn(TSDFVolume(*a[:3]), a[3], a[4], Pose(a[5], a[6]),
                              _intr(intr), params))(
        tsdf, weight, color, depth_m, color_rgb, R, t)
    return _np((v.tsdf, v.weight, v.color))


def raycast(tsdf, R, t, intr, params_kw):
    """volume.raycast.raycast (the dispatcher), jitted: (vmap, nmap)."""
    import jax

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.geometry.se3 import Pose
    from kinfu_tpu.volume.raycast import raycast as fn
    from kinfu_tpu.volume.tsdf import TSDFVolume

    params = KinFuParams(**dict(params_kw))
    return _np(jax.jit(lambda a, R, t: fn(TSDFVolume(a, a, a), Pose(R, t), _intr(intr),
                                          params))(tsdf, R, t))


def raycast_parts(tsdf, R, t, intr, params_kw, max_steps, chunk):
    """The pieces of volume/raycast.py, each jitted on its own, for the
    camera pose (R, t): camera_rays, ray_aabb, build_occupancy, march,
    march_hier, march_chunked (`max_steps`, `chunk`), shade on the march's
    hits, and trilinear at the hits' vertices."""
    import jax
    import jax.numpy as jnp

    import importlib

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.geometry.se3 import Pose

    # the package's __init__ binds the name `raycast` to the function
    rc = importlib.import_module("kinfu_tpu.volume.raycast")
    params = KinFuParams(**dict(params_kw))
    dims = tsdf.shape
    vsx, vsy, vsz = params.voxel_size
    step = params.raycast_step_voxels * vsx
    inv_vs = jnp.array([1.0 / vsx, 1.0 / vsy, 1.0 / vsz], dtype=jnp.float32)
    org, dirs = jax.jit(lambda R, t: rc.camera_rays(Pose(R, t), _intr(intr)))(R, t)
    box_max = jnp.array(params.volume_range, dtype=jnp.float32)
    tnear, tfar = jax.jit(rc.ray_aabb)(org, dirs, box_max)
    t_start = jnp.maximum(tnear, 0.0) + step
    occ = jax.jit(rc.build_occupancy)(tsdf)
    m = jax.jit(lambda a, o, d, s, e: rc.march(a, dims, 0, o, d, s, e, step, inv_vs))(
        tsdf, org, dirs, t_start, tfar)
    h = jax.jit(lambda a, c, o, d, s, e: rc.march_hier(a, c, o, d, s, e, step, inv_vs))(
        tsdf, occ, org, dirs, t_start, tfar)
    c = jax.jit(lambda a, o, d, s, e: rc.march_chunked(a, dims, 0, o, d, s, e, step, inv_vs,
                                                       max_steps, chunk))(
        tsdf, org, dirs, t_start, tfar)
    hit = (m.hit_t < m.back_t) & (m.hit_t < rc._INF)
    vertex, n, valid = jax.jit(lambda a, o, d, ht, hm: rc.shade(
        a, dims, 0, o, d, ht, hm, params.voxel_size))(tsdf, org, dirs, m.hit_t, hit)
    tri = jax.jit(lambda a, p: rc.trilinear(a.reshape(-1), dims, 0, dims[0], p))(
        tsdf, vertex * inv_vs)
    return _np(dict(org=org, dirs=dirs, tnear=tnear, tfar=tfar, t_start=t_start, occ=occ,
                    march=tuple(m), hier=tuple(h), chunked=tuple(c), vertex=vertex,
                    normal=n, valid=valid, tri=tri))


def faces_needed_cam2vol(rotations, intr):
    """pallas_raycast._faces_needed of each cam2vol rotation, jitted:
    [n, 6] bool in face_frames() order."""
    import jax
    import jax.numpy as jnp

    from kinfu_tpu.geometry.se3 import Pose
    from kinfu_tpu.ops.facewarp import face_frames
    from kinfu_tpu.ops.pallas_raycast import _faces_needed

    names = [fr.name for fr in face_frames()]
    fn = jax.jit(lambda R: jnp.stack([
        v for _, v in sorted(_faces_needed(Pose(R, jnp.zeros(3)), _intr(intr)).items(),
                             key=lambda kv: names.index(kv[0]))]))
    return np.stack([np.asarray(fn(jnp.asarray(R, jnp.float32))) for R in rotations])


def raycast_warped(tsdf, R, t, intr, params_kw, faces):
    """pallas_raycast.raycast_warped (interpret), jitted: (vmap, nmap)."""
    import jax

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.geometry.se3 import Pose
    from kinfu_tpu.ops.pallas_raycast import raycast_warped as fn
    from kinfu_tpu.volume.tsdf import TSDFVolume

    params = KinFuParams(**dict(params_kw))
    return _np(jax.jit(lambda a, R, t: fn(TSDFVolume(a, a, a), Pose(R, t), _intr(intr),
                                          params, interpret=True, faces=faces))(tsdf, R, t))


def _child(d: str) -> None:
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    this = sys.modules[__name__]
    with open(Path(d) / "in.pkl", "rb") as f:
        calls = pickle.load(f)
    out = [getattr(this, name)(**kw) for name, kw in calls]
    with open(Path(d) / "out.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _child(sys.argv[1])
