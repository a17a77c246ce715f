"""io (port of kinfu_tpu/io/)."""
