"""Losses of the VAE-GAN trainer (port of neurosis_tpu/losses)."""
