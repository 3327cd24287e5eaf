"""Host-side utilities of the PyTorch port (so far: key colours)."""
