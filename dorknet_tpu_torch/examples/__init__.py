"""Runnable examples of the port (``python -m dorknet_tpu_torch.examples.<name>``)."""
