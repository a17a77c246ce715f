"""icp.ms: the device time a frame of the operations launched inside the
program's span `kinfu.step.icp` (`tracking/icp.py`, K1), in ms, matched by
the trace's correlation ids (`spans.py`)."""

from kfbench import spans


def read(ctx):
    return spans.span_value(ctx, ["kinfu.step.icp"], "device_ms", device=True)
