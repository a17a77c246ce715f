"""pipeline (port of kinfu_tpu/pipeline/)."""
