"""Command-line tools of the port: `python -m kinfu_tpu_torch.tools.<name>`
(sanitize, trace_step, raycast_parity_probe, accuracy_run)."""
