"""data (port of kinfu_tpu/data/)."""
