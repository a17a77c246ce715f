"""step.launches: device kernel launches a frame over the traced frames
(torch.profiler's kernel events; copies and sets not counted)."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("frames") or not tr.get("busy_s"):
        return None
    return tr["launches"] / tr["frames"]
