"""shard.collective_ms: rank 0's device time a frame of the operations
launched inside the program's spans `kinfu.shard.collective`
(`parallel/mesh.py`: every all-reduce of the sharded step, the halo's
among them; on NCCL a collective's kernel also runs while it waits for the
slowest rank), in ms, on a sharded cell (`shard_spans.py`)."""

from kfbench import shard_spans


def read(ctx):
    return shard_spans.device_ms(ctx, shard_spans.COLLECTIVE)
