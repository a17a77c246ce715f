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
XLA_FLAGS = "--xla_cpu_max_isa=AVX --xla_cpu_multi_thread_eigen=false"


class Job:
    """A running child process evaluating a list of references."""

    def __init__(self, calls):
        env = dict(os.environ, XLA_FLAGS=XLA_FLAGS, JAX_PLATFORMS="cpu")
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


def start(calls) -> Job:
    """Start evaluating [(reference name, kwargs), ...] in a child process
    whose XLA emits no FMA."""
    return Job(calls)


def run(calls, timeout: float = 900.0):
    """[(reference name, kwargs), ...] -> [result, ...]."""
    return start(calls).result(timeout)


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


def face_pass_parts(tsdf_p, origin_p, vs_p, A, intr, spec):
    """One face of pallas_raycast._face_pass, stage by stage: the sweep
    (interpret), `_face_fields` on its events and `_resample_face`
    (interpret) on those fields."""
    hit, back = sweep_face_rays(tsdf_p, origin_p, vs_p, spec)
    t_f, n_f, ok = face_fields(hit, back, origin_p, spec)
    t_cam, n_cam = resample_face(t_f, n_f, A, intr, spec)
    return dict(hit=hit, back=back, t_f=t_f, n_f=n_f, ok=ok, t_cam=t_cam, n_cam=n_cam)


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


def kinfu_track(params_kw, intr, sequences):
    """pipeline.kinfu: init_state + one jitted step over each frame sequence;
    returns, per sequence and frame, the state as numpy fields and the
    step's outputs."""
    import jax.numpy as jnp

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.geometry.se3 import pose_matrix
    from kinfu_tpu.pipeline.kinfu import init_state, make_step_fn

    params = KinFuParams(**dict(params_kw))
    step = make_step_fn(params, _intr(intr), donate=False)
    out = []
    for frames in sequences:
        st, seq = init_state(params, _intr(intr)), []
        for d, c in frames:
            st, o = step(st, jnp.asarray(d), jnp.asarray(c))
            seq.append(dict(
                tsdf=np.asarray(st.vol.tsdf), weight=np.asarray(st.vol.weight),
                color=np.asarray(st.vol.color), pose=np.asarray(pose_matrix(st.pose)),
                model_vmaps=[np.asarray(m) for m in st.model_vmaps],
                model_nmaps=[np.asarray(m) for m in st.model_nmaps],
                frame_count=np.asarray(st.frame_count),
                pose_matrix=np.asarray(o.pose_matrix), tracking_ok=bool(o.tracking_ok),
                icp_inliers=int(o.icp_inliers),
            ))
        out.append(seq)
    return out


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
