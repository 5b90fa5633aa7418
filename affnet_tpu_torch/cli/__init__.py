"""Command-line programs of the port (``python -m affnet_tpu_torch.cli.<name>``)."""
