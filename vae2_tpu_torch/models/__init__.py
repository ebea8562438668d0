"""The VAE² HRNet family (encoder-dual-decoder)."""
