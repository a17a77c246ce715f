"""raycast.ms: the device time a frame of the operations launched inside
the program's span `kinfu.step.raycast` (`ops/face_raycast.py`, K4-K5),
in ms, matched by the trace's correlation ids (`spans.py`)."""

from kfbench import spans


def read(ctx):
    return spans.span_value(ctx, ["kinfu.step.raycast"], "device_ms", device=True)
