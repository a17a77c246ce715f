"""tracking (port of kinfu_tpu/tracking/)."""
