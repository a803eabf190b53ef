"""Command-line apps of the port (``python -m xivo_tpu_torch.apps.vio``)."""
