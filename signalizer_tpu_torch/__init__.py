"""signalizer_tpu_torch — the PyTorch / CUDA port of signalizer_tpu.

A second package beside the JAX one: the same Spectrum view, on tensors on
one explicit device, with the Spectrum step's two stages carried by CUDA
kernels written for Hopper (``csrc/``) and plain PyTorch versions beside
them. It imports no jax; from the JAX package it uses only the jax-free
``core.config`` (enums), ``core.windows`` and ``core.scaling``.

Layout mirrors :mod:`signalizer_tpu`:

* :mod:`signalizer_tpu_torch.core.constant`    — SpectrumConstant, remap-plan functions
* :mod:`signalizer_tpu_torch.kernels.spectrum` — analyze_frames and its stages
* :mod:`signalizer_tpu_torch.kernels.window_fft_mag` — kernel A wrapper
* :mod:`signalizer_tpu_torch.kernels.display_map`    — kernel B wrapper
* :mod:`signalizer_tpu_torch.kernels.peak_decay`     — the decay loop
* :mod:`signalizer_tpu_torch.views.spectrum`   — SpectrumProcessor

Importing builds nothing: the kernels compile with ``nvcc`` on first launch.
"""

from signalizer_tpu.core.config import (  # noqa: F401
    BinInterpolation,
    DisplayMode,
    SpectrumChannels,
    TransformAlgorithm,
    ViewScaling,
)
from signalizer_tpu_torch.views.spectrum import SpectrumProcessor  # noqa: F401
