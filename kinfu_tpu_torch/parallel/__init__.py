"""The sharded step, its mesh and collectives, and the replica sweep (port of
kinfu_tpu/parallel/)."""
