"""step.enqueue_ms: the host's time a frame in the program's span
`kinfu.session.step` (`pipeline/session.py`: the step's enqueue), in ms,
from the traced run's Chrome trace (`spans.py`). A host time under the
profiler, which about doubles a frame's host time: compare it with traced
readings only."""

from kfbench import spans


def read(ctx):
    return spans.span_value(ctx, ["kinfu.session.step"], "host_ms")
