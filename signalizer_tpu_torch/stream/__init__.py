"""Host-side streaming of the PyTorch port: ring buffer, frame batcher, device-resident ring."""
