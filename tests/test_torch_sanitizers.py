"""The port's sanitizer pass on the CPU, the counterpart of
tests/test_sanitizers.py: the step under
kinfu_tpu_torch/tools/sanitize.py::IndexChecks, a TorchDispatchMode that
raises before any indexing, gather or scatter op runs with an index outside
[0, size) and before an integer division by zero, as `checkify`'s index and
division checks do for the JAX step.

  - the non-fused step at test_sanitizers.py's settings (tiny_params(dim=32,
    levels=2), ICP (2, 2), gather integrate and ICP, the "step" raycast,
    fused off, 80x64, two orbit frames), and the fused step on the plain
    versions of K1-K5 at 128^3 / 160x120 (tests/test_torch_step.py's
    configuration with the warped ICP), both tracking;
  - two negative cases, a negative index and an integer division by zero,
    which the mode must refuse (it raises its own IndexCheckError before
    PyTorch's own check could), to show that it is live;
  - the repeat-launch check (`sanitize.repeat`, the stand-in for
    racecheck and initcheck that chip_smoke.py phase 7b runs on the card)
    on forms made to fail: an output left half unwritten, a ticket left
    set, another result on the second grid, one iteration's count off on
    K1's second grid; and a clean form, which it must pass.

Not mirrored: test_sweep_alias_on_off_bit_identical. KINFU_DISABLE_ALIAS
switches the Pallas sweep's input/output aliasing, a lever of the TPU
kernel with no counterpart here: K3 updates the volume in place in every
build. The kernels themselves are checked on the card: chip_smoke.py
phase 7 runs every form of K1-K5, K3's in-place launches among them, in
the bounds-checked build (tools/sanitize.py).
"""

import numpy as np
import pytest
import torch

from kinfu_tpu_torch.config import KinFuParams, tiny_params
from kinfu_tpu_torch.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.pipeline.kinfu import init_state, kinfu_step
from kinfu_tpu_torch.tools import sanitize
from kinfu_tpu_torch.tools.sanitize import Form, IndexCheckError, IndexChecks

torch.set_num_threads(2)

INTR = Intrinsics(width=80, height=64, fx=70.0, fy=70.0, cx=39.5, cy=31.5)
#: tests/test_torch_step.py's fused configuration, K1 on its plain version
FUSED = KinFuParams(pyramid_height=2, icp_iters=(3, 4), volume_dims=(128, 128, 128),
                    integrate_mode="warped", raycast_mode="warped", icp_mode="warped",
                    fused_mode="on", raycast_face=(256, 104.0))
INTR_FUSED = Intrinsics(160, 120, 140.0, 140.0, 79.5, 59.5)


def _config(name):
    if name == "fused":
        return FUSED, INTR_FUSED
    return tiny_params(dim=32, levels=2).replace(
        icp_iters=(2, 2), integrate_mode="gather", raycast_mode="step", icp_mode="gather",
        fused_mode="off"), INTR


@pytest.mark.parametrize("name", ["non_fused", "fused"])
def test_step_passes_index_and_div_checks(name):
    params, intr = _config(name)
    scene = default_test_scene()
    frames = [scene.render_frame(T, intr) for T in make_orbit_trajectory(2, angle_step_deg=0.3)]
    state = init_state(params, intr, device="cpu")
    with IndexChecks():
        for depth, color in frames:
            state, out = kinfu_step(state, torch.as_tensor(depth), torch.as_tensor(color),
                                    params, intr)
    assert bool(out.tracking_ok)


@pytest.mark.parametrize("case", ["negative_index", "int_division_by_zero"])
def test_index_checks_are_live(case):
    a = torch.arange(12).reshape(3, 4)
    with IndexChecks():
        if case == "negative_index":
            with pytest.raises(IndexCheckError, match=r"aten\.index\."):
                a[torch.tensor([0, -1])]
            with pytest.raises(IndexCheckError, match="gather"):
                torch.gather(a, 1, torch.tensor([[0], [4], [1]]))
            # inside the bounds nothing is raised
            assert a[torch.tensor([2])].tolist() == [[8, 9, 10, 11]]
        else:
            with pytest.raises(IndexCheckError, match="floor_divide"):
                a // torch.tensor(0)
            with pytest.raises(IndexCheckError, match="remainder"):
                torch.remainder(a, 0)
            # a float division by zero is no fault
            assert torch.isinf(a.float() / 0.0).any()
    # outside the mode PyTorch wraps a negative index silently
    assert a[torch.tensor([-1])].tolist() == [[8, 9, 10, 11]]
    np.testing.assert_array_equal(a.numpy()[-1], [8, 9, 10, 11])


def _repeat_case(case):
    """(form, what its record must show) of a case of the repeat check."""
    ticket = torch.zeros(1, dtype=torch.int32)

    def half_written(grid):
        out = torch.empty(8)  # the sentinel fills it
        out[:4] = 1.0
        return (out,)

    def leaves_ticket(grid):
        ticket.fill_(1)
        return (torch.ones(2),)

    def grid_dependent(grid):
        return (torch.full((3,), 0.0 if grid is None else 1.0),)

    def k1_count_off(grid):
        n = 100 if grid is None else 101
        return torch.eye(6), torch.ones(6), torch.tensor(n, dtype=torch.int32)

    def clean(grid):
        out = torch.empty(4)
        out.copy_(torch.arange(4.0))
        return out, torch.empty_like(out).fill_(2.0)

    return {"unwritten": (Form("half", half_written), "differ"),
            "ticket": (Form("ticket", leaves_ticket, zero=(ticket,)), "not_zero"),
            "grid": (Form("grid", grid_dependent, grid2=5), "grid2_ok"),
            "k1_count": (Form("k1", k1_count_off, grid2=5, tol=sanitize.k1_close), "grid2_ok"),
            "clean": (Form("clean", clean, grid2=5), None)}[case]


@pytest.mark.parametrize("case", ["unwritten", "ticket", "grid", "k1_count", "clean"])
def test_repeat_check_is_live(case):
    form, shows = _repeat_case(case)
    empty, empty_like = torch.empty, torch.empty_like
    rec = sanitize.repeat(form, 4)
    # the sentinel allocators are gone after each launch
    assert torch.empty is empty and torch.empty_like is empty_like
    assert rec["launches"] == (8 if form.grid2 else 4)
    if shows is None:
        assert rec["ok"] and rec["differ"] == 0 and rec["grid2_ok"], rec
        return
    assert not rec["ok"], rec
    if shows == "grid2_ok":
        assert rec["grid2_ok"] is False and rec["differ"] == rec["differ_grid2"] == 0
    else:
        # every launch after the first differs; the ticket is left set by each
        assert rec[shows] == (4 if shows == "not_zero" else 3), rec
