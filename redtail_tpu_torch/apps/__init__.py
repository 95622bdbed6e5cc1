"""Command-line applications (`python -m redtail_tpu_torch.apps.<name>`)."""
