"""Runnable examples of the port (``python -m distlearn_tpu_torch.examples.<name>``)."""
