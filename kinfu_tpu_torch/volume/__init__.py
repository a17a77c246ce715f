"""volume (port of kinfu_tpu/volume/)."""
