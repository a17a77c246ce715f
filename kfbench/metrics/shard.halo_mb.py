"""shard.halo_mb: the MB (10^6 B) a frame that rank 0's halo exchange
reduces (`parallel/mesh.py::halo_exchange`, the buffer of every rank's two
boundary slots): the bytes a call from the program's counter
(`mesh.COLLECTIVES`, "halo_bytes" over "halo", counted in rank 0's
process, the harness's own) times the `kinfu.shard.halo` spans a frame of
rank 0's trace. The halo's `kinfu.shard.collective` span carries the
same bytes as its args, which a trace shows only where it records
shapes; the harness's does not."""

from kfbench import shard_spans


def read(ctx):
    t = shard_spans.read(ctx)
    if t is None or shard_spans.HALO not in t["spans"]:
        return None
    from kinfu_tpu_torch.parallel import mesh

    calls = mesh.COLLECTIVES["halo"]
    if not calls:
        return None
    return mesh.COLLECTIVES["halo_bytes"] / calls * t["spans"][shard_spans.HALO]["count"] / 1e6
