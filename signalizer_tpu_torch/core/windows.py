"""DSP window family of the port.

The port's own copy of the window generation of
:mod:`signalizer_tpu.core.windows` (ref:
cpl::ParameterWindowDesignValue::generateWindow, used at
Source/Spectrum/TransformConstant.h:104-107), arithmetic unchanged: host
numpy in float64, computed when a view's constant is rebuilt and uploaded
with it. Tests hold the kernels bit-equal to the JAX package's.

Scaling convention: ``generate_window`` returns ``(kernel, scale)`` where
``scale = N / sum(kernel)`` is the reciprocal coherent gain. The spectrum
normalizes by ``invSize = scale / (windowSize * 0.5)`` (ref:
TransformDSP.inl:540) so a full-scale sinusoid on an exact bin reads 1.0
(0 dBFS) for every window.
"""

from __future__ import annotations

import enum
from typing import Dict, Tuple

import numpy as np
from scipy import special as _special


class WindowType(enum.IntEnum):
    """Window shapes. The first group ("finite DFT windows") are pure
    cosine sums (ref: SpectrumController.cpp:136-169 restricts the RSNT
    algorithm to these); the rest are FFT-only."""

    RECTANGULAR = 0
    HANN = 1
    HAMMING = 2
    BLACKMAN = 3
    EXACT_BLACKMAN = 4
    NUTTALL = 5
    BLACKMAN_NUTTALL = 6
    BLACKMAN_HARRIS = 7
    FLAT_TOP = 8
    # --- not expressible as a short cosine sum (FFT path only) ---
    TRIANGULAR = 9
    PARZEN = 10
    WELCH = 11
    LANCZOS = 12
    GAUSSIAN = 13  # uses `alpha` (reciprocal std dev)
    KAISER = 14  # uses `beta`
    SLEPIAN = 15  # DPSS, uses `alpha` as half-bandwidth parameter


# a0, a1, a2, ... for w[n] = sum_k (-1)^k a_k cos(2 pi k n / (N-1))
_COSINE_COEFFS: Dict[WindowType, Tuple[float, ...]] = {
    WindowType.RECTANGULAR: (1.0,),
    WindowType.HANN: (0.5, 0.5),
    WindowType.HAMMING: (0.54, 0.46),
    WindowType.BLACKMAN: (0.42, 0.5, 0.08),
    WindowType.EXACT_BLACKMAN: (7938 / 18608, 9240 / 18608, 1430 / 18608),
    WindowType.NUTTALL: (0.355768, 0.487396, 0.144232, 0.012604),
    WindowType.BLACKMAN_NUTTALL: (0.3635819, 0.4891775, 0.1365995, 0.0106411),
    WindowType.BLACKMAN_HARRIS: (0.35875, 0.48829, 0.14128, 0.01168),
    WindowType.FLAT_TOP: (
        0.21557895,
        0.41663158,
        0.277263158,
        0.083578947,
        0.006947368,
    ),
}

FINITE_DFT_WINDOWS = tuple(_COSINE_COEFFS.keys())


def window_coefficients(wtype: WindowType) -> Tuple[float, ...]:
    """Cosine-sum coefficients (ref: cpl dsp::windowCoefficients usage at
    Source/Spectrum/Spectrum.cpp:593). Only defined for finite-DFT windows."""
    return _COSINE_COEFFS[wtype]


def generate_window(
    wtype: WindowType,
    size: int,
    *,
    symmetric: bool = True,
    alpha: float = 2.5,
    beta: float = 8.0,
    dtype=np.float64,
) -> Tuple[np.ndarray, float]:
    """Build a window kernel and its normalization scale.

    Returns ``(kernel[size], scale)`` with ``scale = size / sum(kernel)``
    (reciprocal coherent gain; see module docstring). ``symmetric=True``
    matches the reference's default analysis usage; ``symmetric=False``
    gives the DFT-periodic variant.
    """
    if size < 1:
        raise ValueError("window size must be >= 1")
    if size == 1:
        return np.ones(1, dtype=dtype), 1.0

    denom = (size - 1) if symmetric else size
    n = np.arange(size, dtype=np.float64)

    if wtype in _COSINE_COEFFS:
        coeffs = _COSINE_COEFFS[wtype]
        w = np.zeros(size, dtype=np.float64)
        for k, a in enumerate(coeffs):
            w += ((-1.0) ** k) * a * np.cos(2.0 * np.pi * k * n / denom)
    elif wtype == WindowType.TRIANGULAR:
        w = 1.0 - np.abs(2.0 * n / denom - 1.0)
    elif wtype == WindowType.WELCH:
        w = 1.0 - (2.0 * n / denom - 1.0) ** 2
    elif wtype == WindowType.PARZEN:
        # classical de la Vallee Poussin window: |t| normalized by N (not
        # N-1), periodic variant = symmetric of length N+1 truncated
        m = size if symmetric else size + 1
        x = np.abs(2.0 * n - (m - 1)) / m  # |t| in [0, 1)
        w = np.where(x <= 0.5, 1.0 - 6.0 * x**2 + 6.0 * x**3, 2.0 * (1.0 - x) ** 3)
    elif wtype == WindowType.LANCZOS:
        w = np.sinc(2.0 * n / denom - 1.0)
    elif wtype == WindowType.GAUSSIAN:
        w = np.exp(-0.5 * (alpha * (2.0 * n / denom - 1.0)) ** 2)
    elif wtype == WindowType.KAISER:
        w = _special.i0(beta * np.sqrt(np.clip(1.0 - (2.0 * n / denom - 1.0) ** 2, 0.0, 1.0)))
        w = w / _special.i0(beta)
    elif wtype == WindowType.SLEPIAN:
        from scipy.signal import windows as _sw

        w = _sw.dpss(size, alpha, sym=symmetric).astype(np.float64)
        w = w / w.max()
    else:  # pragma: no cover
        raise ValueError(f"unknown window type {wtype!r}")

    total = float(w.sum())
    scale = size / total if total != 0.0 else 1.0
    return w.astype(dtype), scale


def window_scale(wtype: WindowType, size: int, **kw) -> float:
    """Just the normalization scale (reciprocal coherent gain)."""
    return generate_window(wtype, size, **kw)[1]


def window_dtft_gain(kernel: np.ndarray, bin_offset: float) -> float:
    """Normalized DTFT magnitude of a window at a fractional bin offset:
    ``|sum w[n] e^{-i 2 pi f n / N}| / sum w[n]``."""
    size = len(kernel)
    n = np.arange(size)
    z = np.sum(kernel * np.exp(-2j * np.pi * bin_offset * n / size))
    return float(np.abs(z) / np.sum(kernel))
