"""frontend (port of kinfu_tpu/frontend/)."""
