"""device.busy_ms: the union of the device's operations over the traced
frames, ms a frame (torch.profiler)."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("frames") or not tr.get("busy_s"):
        return None
    return tr["busy_s"] / tr["frames"] * 1e3
