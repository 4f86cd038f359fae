"""Conditioning embedders of the PyTorch port."""
