"""kernels.roofline: the traced frames' least device time for their ICP,
fusion and raycast work (`work.py`: bytes over the HBM peak or float32
operations over the float32 peak, whichever is larger, a frame at a
time) over all the device's busy time in those frames, in %."""


def read(ctx):
    tr = ctx.get("trace") or {}
    work = tr.get("work") or []
    if not work or not tr.get("busy_s"):
        return None
    return sum(w["least_s"] for w in work) / tr["busy_s"] * 100.0
