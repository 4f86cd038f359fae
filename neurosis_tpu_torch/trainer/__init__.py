"""trainer of the PyTorch port."""
