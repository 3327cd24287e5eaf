"""Scalar scaling helpers of the port.

The port's own copy of what it calls from :mod:`signalizer_tpu.core.scaling`
(ref: cpl Mathext helpers as used throughout Source/), arithmetic unchanged;
tests hold it bit-equal to the JAX package's.
"""

from __future__ import annotations


def peak_decay_pole(decay_seconds: float, frames_per_second: float, fraction: float = 0.1) -> float:
    """One-pole peak-decay coefficient.

    Designed so the filter output decays to ``fraction`` of its value in
    ``decay_seconds`` at the given frame rate (ref: cpl CPeakFilter
    setSampleRate/setDecayAsFraction usage at Source/Spectrum/Spectrum.cpp:392-393;
    cpl sources absent, semantics defined here: pole = fraction^(1/(t*fps))).
    """
    if decay_seconds <= 0.0 or frames_per_second <= 0.0:
        return 0.0
    return float(fraction ** (1.0 / (decay_seconds * frames_per_second)))
