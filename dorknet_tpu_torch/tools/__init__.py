"""Command-line tools of the port (``python -m dorknet_tpu_torch.tools.<name>``)."""
