"""Developer tools of the PyTorch port (run on a machine with a GPU)."""
