"""utils (port of kinfu_tpu/utils/)."""
