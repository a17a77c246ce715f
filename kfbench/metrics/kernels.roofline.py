"""kernels.roofline: the traced frames' least device time for their ICP,
fusion and raycast work (`work.py`: bytes over the HBM peak or float32
operations over the float32 peak, whichever is larger, a frame at a
time) over all the device's busy time in those frames, in %. On a sharded
run, the work of every rank (`work.frame_work` of its part) over the busy
time of the same ranks."""


def read(ctx):
    traces = [ctx.get("trace") or {}] + list(ctx.get("rank_traces") or [])
    work = [w for tr in traces for w in tr.get("work") or []]
    busy = sum(tr.get("busy_s") or 0 for tr in traces)
    if not work or not busy:
        return None
    return sum(w["least_s"] for w in work) / busy * 100.0
