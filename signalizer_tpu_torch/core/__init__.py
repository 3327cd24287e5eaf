"""Core of the PyTorch port: enums, windows, scaling, the Spectrum constant."""
