"""Stateful view processors of the PyTorch port."""
