"""modules of the PyTorch port."""
