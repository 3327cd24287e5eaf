"""The benchmark of signalizer_tpu_torch on an NVIDIA H100: see README.md."""
