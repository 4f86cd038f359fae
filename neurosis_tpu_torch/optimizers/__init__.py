"""optimizers of the PyTorch port."""
