"""Host-side utilities of the PyTorch port: colours, axes, diagnostics, the
exception log."""
