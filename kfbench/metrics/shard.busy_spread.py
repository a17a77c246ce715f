"""shard.busy_spread: the balance of the ranks' work, the largest over the
smallest rank's own device time a frame: its device busy time over the
traced frames (`trace.reduce`'s union of device operations, `ctx["trace"]`
for rank 0 and `ctx["rank_traces"]` for the others) less its time in the
collectives, over its traced frames. A rank that waits for a slower one
spins in a collective's kernel, so that time is not its own work. The
time in the collectives is read from the ten largest device operations
a rank's trace keeps: the larger of the `nccl:*` ranges that torch marks
on the device's timeline around each collective and the `nccl*` kernels
inside them (the two cover the same time). 1 where every rank works
alike. None unless rank 0's trace holds the sharded step's span
`kinfu.shard.step`, or where a rank has no device time (gloo on the
CPU)."""

from kfbench import shard_spans


def own_ms(tr: dict):
    """A rank's device ms a frame outside the collectives."""
    busy, frames = tr.get("busy_s") or 0.0, tr.get("frames") or 0
    ops = (tr.get("breakdown") or {}).get("device_ops") or []
    marked = sum(s for name, s in ops if name.startswith("nccl:"))
    kernels = sum(s for name, s in ops if name.startswith("nccl") and
                  not name.startswith("nccl:"))
    own = busy - max(marked, kernels)
    return own / frames * 1e3 if frames and own > 0 else None


def read(ctx):
    if shard_spans.read(ctx) is None:
        return None
    ranks = [own_ms(tr) for tr in [ctx["trace"]] + list(ctx.get("rank_traces") or [])]
    if len(ranks) < 2 or None in ranks:
        return None
    return max(ranks) / min(ranks)
