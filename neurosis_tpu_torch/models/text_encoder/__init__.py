"""Text encoders of the PyTorch port."""
