"""ops (port of kinfu_tpu/ops/)."""
