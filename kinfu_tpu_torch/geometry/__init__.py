"""geometry (port of kinfu_tpu/geometry/)."""
