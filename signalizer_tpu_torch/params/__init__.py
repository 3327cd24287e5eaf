"""Parameter-layer pieces of the PyTorch port (so far: ``TimeMode``)."""
