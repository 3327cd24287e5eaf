"""Spectrum kernels of the PyTorch port: CUDA wrappers and their plain versions."""
