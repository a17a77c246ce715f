"""fusion.ms: the device time a frame of the operations launched inside the
program's spans `kinfu.step.integrate` and `kinfu.step.reset`
(`ops/face_integrate.py`, K2-K3, and the failure reset), in ms, matched by
the trace's correlation ids (`spans.py`)."""

from kfbench import spans


def read(ctx):
    return spans.span_value(ctx, ["kinfu.step.integrate", "kinfu.step.reset"], "device_ms",
                            device=True)
