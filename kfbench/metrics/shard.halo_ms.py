"""shard.halo_ms: rank 0's device time a frame of the operations launched
inside the program's span `kinfu.shard.halo` (`parallel/mesh.py::
halo_exchange`: the zero-filled buffer, its all-reduce and the padded copy
of the slab), in ms, on a sharded cell (`shard_spans.py`)."""

from kfbench import shard_spans


def read(ctx):
    return shard_spans.device_ms(ctx, shard_spans.HALO)
