"""The reader `metrics/stream.moved_share.py`: None where the program has
no shift counter (a program before it) or counted no call, and the share
of calls that moved voxels from a planted counter."""

import pytest
import torch

from kfbench import harness
from kinfu_tpu_torch.volume import stream


def test_no_counter(monkeypatch):
    monkeypatch.delattr(stream, "SHIFT_COUNTS")
    assert harness.read_metric("stream.moved_share", {}) is None


def test_no_calls(monkeypatch):
    monkeypatch.setattr(stream, "SHIFT_COUNTS", {})
    assert harness.read_metric("stream.moved_share", {}) is None
    monkeypatch.setattr(stream, "SHIFT_COUNTS",
                        {torch.device("cpu"): torch.zeros(2, dtype=torch.int64)})
    assert harness.read_metric("stream.moved_share", {}) is None


@pytest.mark.parametrize("counts, want", [
    ([[8, 6]], 75.0),
    ([[4, 0]], 0.0),
    ([[3, 1], [1, 1]], 50.0),
], ids=["share", "none_moved", "two_devices"])
def test_planted_counter(monkeypatch, counts, want):
    planted = {torch.device("cpu", k): torch.tensor(c, dtype=torch.int64)
               for k, c in enumerate(counts)}
    monkeypatch.setattr(stream, "SHIFT_COUNTS", planted)
    assert harness.read_metric("stream.moved_share", {}) == pytest.approx(want)


def test_counts_a_streaming_step():
    """`shift_volume_` adds to its device's counter in SHIFT_COUNTS, which
    the reader reads."""
    from kinfu_tpu_torch.volume.tsdf import TSDFVolume

    vol = TSDFVolume(torch.ones((4, 4, 4), dtype=torch.int16),
                     torch.ones((4, 4, 4), dtype=torch.int16),
                     torch.ones((4, 4, 4), dtype=torch.int32))
    before = stream.shift_counts("cpu").clone()
    for s in ((0, 0, 0), (0, 1, 0), (0, 0, 0), (2, 0, 0)):
        stream.shift_volume_(vol, torch.tensor(s, dtype=torch.int32))
    calls, moved = (stream.shift_counts("cpu") - before).tolist()
    assert (calls, moved) == (4, 2)
    share = harness.read_metric("stream.moved_share", {})
    total = stream.shift_counts("cpu").tolist()
    assert share == pytest.approx(100.0 * total[1] / total[0])
