"""The port's tools (kinfu_tpu_torch/tools/) on the CPU at test scale:

  - trace_step: the profile of the step's frames returns its rows sorted by
    time with their counts, and the command line prints them;
  - accuracy_run: at 128^3 / 160x120 / 2 levels its JSON line's ATE is
    `eval.ate.ate_rmse` of its poses, and the JAX package's
    `read_poses_reference_format` reads its poses file back;
  - raycast_parity_probe: the warped raycast against the unit-step march
    on one fused frame at 128^3 / 160x120 gives the hit fractions of the
    same computation on the JAX package (`raycast_warped` and the "step"
    `raycast`, through tests/torch_jaxref.py), and the medians within
    1e-3. The port's face flags gate +z alone at that pose, so the JAX
    sweep runs pinned to +z (its "auto" compiles every face's branch in
    interpret mode, ~70 s; the flags' parity is
    tests/test_torch_volume.py::test_faces_needed_cam2vol_matches_jax).
"""

import json

import numpy as np
import pytest
import torch

import torch_jaxref
from kinfu_tpu.io.poses import read_poses_reference_format as read_poses_jax
from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.eval.ate import ate_rmse
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.ops.face_raycast import faces_needed_cam2vol
from kinfu_tpu_torch.tools import accuracy_run, raycast_parity_probe, trace_step

torch.set_num_threads(2)

CPU = torch.device("cpu")
INTR_T = (160, 120, 140.0, 140.0, 79.5, 59.5)
INTR = Intrinsics(*INTR_T)
#: the warped raycast at 128^3 wants a 256 px face (tests/test_torch_volume.py)
PARITY_CFG = dict(volume_dims=(128, 128, 128), raycast_face=(256, 104.0))


def test_trace_step_rows_sorted_with_counts(capsys):
    params, intr = trace_step.workload(128, 160, 120)
    frames, _ = trace_step.orbit(3, intr)
    prof, state = trace_step.trace_steps(frames, params, intr, CPU)
    assert prof.calls == 1 and prof.launches == []
    times = [ms for _, ms, _ in prof.rows]
    assert times == sorted(times, reverse=True) and times[0] > 0
    assert all(n >= 1 for _, _, n in prof.rows)
    names = {name for name, _, _ in prof.rows}
    assert "aten::index" in names and prof.busy_ms > 0
    assert tuple(state.vol.tsdf.shape) == (128, 128, 128)
    trace_step.main(["--device", "cpu", "--dim", "64", "--width", "80", "--height", "64",
                     "--frames", "3", "--top", "5"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cpu: cpu operators' self time")
    assert len(lines) == 2 + 5 and all(ln.split()[1].isdigit() for ln in lines[2:])


def test_accuracy_run_cpu(tmp_path, capsys):
    out = tmp_path / "poses.txt"
    accuracy_run.main(["--device", "cpu", "--dim", "128", "--levels", "2", "--icp-iters",
                       "3,4", "--width", "160", "--height", "120", "--frames", "4",
                       "--out", str(out)])
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    params, intr = accuracy_run.configure(128, 160, 120, 2, (3, 4), "auto")
    frames, gt = trace_step.orbit(4, intr)
    poses, oks = accuracy_run.track(frames, params, intr, CPU)
    assert oks.all() and res["frames"] == 4
    assert res["ate_rmse_m"] == ate_rmse(list(poses), gt)
    assert res["ate_rmse_m"] < 5e-3
    back = read_poses_jax(str(out))
    assert len(back) == 4
    # the reference's format keeps 8 significant digits
    np.testing.assert_allclose(np.stack(back), poses, rtol=0, atol=1e-6)
    assert abs(ate_rmse(back, gt) - res["ate_rmse_m"]) < 1e-6


def test_raycast_parity_probe_matches_jax():
    params = KinFuParams(**PARITY_CFG)
    vol, cam2vol = raycast_parity_probe.fused_view(params, INTR, CPU)
    tsdf = vol.tsdf.numpy()
    R, t = cam2vol.R.numpy(), cam2vol.t.numpy()
    job = torch_jaxref.start([
        ("raycast_warped", dict(tsdf=tsdf, R=R, t=t, intr=INTR_T,
                                params_kw=tuple(PARITY_CFG.items()), faces=("+z",))),
        ("raycast", dict(tsdf=tsdf, R=R, t=t, intr=INTR_T,
                         params_kw=tuple({**PARITY_CFG, "raycast_mode": "step"}.items())))])
    assert faces_needed_cam2vol(cam2vol, INTR).tolist() == [True] + [False] * 5  # +z alone
    (vm_w, nm_w), (vm_r, nm_r) = raycast_parity_probe.raycasts(vol, cam2vol, INTR, params)
    got = raycast_parity_probe.parity_stats(vm_w, nm_w, vm_r, nm_r)
    (jvm_w, jnm_w), (jvm_r, jnm_r) = job.result()
    want = raycast_parity_probe.parity_stats(jvm_w, jnm_w, jvm_r, jnm_r)
    for key in ("agree", "march_hits_sweep_misses", "sweep_hits_march_misses"):
        assert got[key] == want[key], (key, got, want)
    for key in ("dv_med_mm", "nang_med_deg"):
        assert got[key] == pytest.approx(want[key], abs=1e-3), (key, got, want)
    assert got["agree"] > 0.8
