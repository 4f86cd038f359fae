"""sampling of the PyTorch port."""
