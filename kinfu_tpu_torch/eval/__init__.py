"""eval (port of kinfu_tpu/eval/)."""
