"""stream.shift_ms: the device time a frame of the operations launched
inside the program's span `kinfu.step.shift` (`volume/stream.py`, the
streaming grid's shift; absent on a fixed grid), in ms, matched by the
trace's correlation ids (`spans.py`)."""

from kfbench import spans


def read(ctx):
    return spans.span_value(ctx, ["kinfu.step.shift"], "device_ms", device=True)
