"""Spectrum constant of the PyTorch port."""
