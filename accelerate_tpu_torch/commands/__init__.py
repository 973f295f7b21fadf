"""Command-line surfaces of the port (``python -m accelerate_tpu_torch.commands.<name>``)."""
