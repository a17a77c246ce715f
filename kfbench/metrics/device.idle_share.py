"""device.idle_share: the share (%) of the traced window (first frame's
start to last frame's end, the trace's own clock) in which no operation
ran on the device."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("busy_s") or not tr.get("window_s"):
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100.0
