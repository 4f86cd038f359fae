"""Loss hooks of the PyTorch port (port of neurosis_tpu/hooks)."""
