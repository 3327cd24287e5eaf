"""Axis compilation: grid line placement for frequency and dB meters.

Equivalent of cpl's AxisTools (ref: cpl/special/AxisTools.h —
FrequencyAxis, DBMeterAxis, SuitableAxisDivision; consumed at
Source/Spectrum/SpectrumRendering.cpp:899-974 renderLineGrid and the
oscilloscope's 1-2-5-10 time grid, OscilloscopeRendering.cpp:439-549).
Produces arrays of (position, value, label) for renderers.

The port's own copy of :mod:`signalizer_tpu.utils.axis`, arithmetic and names unchanged;
tests/test_torch_params_state.py holds the two equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np


def suitable_axis_division(value_range: float, max_divisions: int) -> float:
    """Largest 1-2-5-10 step giving at most ``max_divisions`` divisions
    (ref: SuitableAxisDivision)."""
    if value_range <= 0 or max_divisions <= 0:
        return 1.0
    raw = value_range / max_divisions
    mag = 10.0 ** math.floor(math.log10(raw))
    for mult in (1.0, 2.0, 5.0, 10.0):
        if mag * mult >= raw:
            return mag * mult
    return mag * 10.0


@dataclass
class AxisLine:
    position: float  # normalized [0, 1] along the axis
    value: float
    label: str


def db_meter_axis(low_dbs: float, high_dbs: float, max_divisions: int = 10) -> List[AxisLine]:
    """dB grid with 1-2-5-10 quantized steps (ref: DBMeterAxis).

    Supports inverted bounds (high < low: the axis renders reversed, the
    line graph flood-fills the other way); a degenerate equal-bounds pair
    (both knobs automated to the same value) yields no grid lines rather
    than dividing by zero."""
    if high_dbs == low_dbs:
        return []
    inverted = high_dbs < low_dbs
    lo, hi = (high_dbs, low_dbs) if inverted else (low_dbs, high_dbs)
    step = suitable_axis_division(hi - lo, max_divisions)
    first = math.ceil(lo / step) * step
    lines = []
    v = first
    while v <= hi + 1e-9:
        pos = (v - low_dbs) / (high_dbs - low_dbs)
        lines.append(AxisLine(pos, v, f"{v:g} dB"))
        v += step
    return lines


def frequency_axis(
    mapped_frequencies: np.ndarray, max_divisions: int = 12
) -> List[AxisLine]:
    """Frequency grid lines against an arbitrary pixel->frequency map
    (ref: FrequencyAxis compiled against mappedFrequencies). For log maps
    this yields the familiar 10-20-50-100... ladder."""
    f = np.asarray(mapped_frequencies, np.float64)
    lo, hi = float(f[0]), float(f[-1])
    if hi <= lo:
        return []
    lines: List[AxisLine] = []
    # a LINEAR pixel->frequency map gets evenly spaced 1-2-5 divisions
    # (ref: FrequencyAxis under setScaling(Linear), Spectrum.cpp:541) —
    # the decade ladder would bunch sub-hertz lines at pixel 0
    if np.max(np.abs(f - np.linspace(lo, hi, len(f)))) <= 1e-6 * max(hi - lo, 1.0):
        step = suitable_axis_division(hi - lo, max_divisions)
        v = math.ceil(lo / step) * step
        while v <= hi + 1e-9:
            label = f"{v/1000:g} kHz" if v >= 1000 else f"{v:g} Hz"
            lines.append(AxisLine((v - lo) / (hi - lo), v, label))
            v += step
        return lines
    # log maps: decade ladder with 1-2-5 subdivisions
    decade = 10.0 ** math.floor(math.log10(max(lo, 1e-3)))
    candidates = []
    while decade <= hi:
        for mult in (1.0, 2.0, 5.0):
            v = decade * mult
            if lo <= v <= hi:
                candidates.append(v)
        decade *= 10.0
    if len(candidates) > max_divisions:
        candidates = candidates[:: max(1, len(candidates) // max_divisions)]
    p = len(f) - 1
    for v in candidates:
        # invert the pixel->frequency map numerically
        idx = int(np.searchsorted(f, v))
        if 0 < idx <= p:
            f0, f1 = f[idx - 1], f[idx]
            frac = (v - f0) / (f1 - f0) if f1 > f0 else 0.0
            pos = (idx - 1 + frac) / p
        else:
            pos = 0.0 if idx == 0 else 1.0
        label = f"{v/1000:g} kHz" if v >= 1000 else f"{v:g} Hz"
        lines.append(AxisLine(float(pos), v, label))
    return lines


def time_axis(
    window_seconds: float, max_divisions: int = 10, unit: str = "ms"
) -> List[AxisLine]:
    """Time-division grid (ref: oscilloscope time grid with 1-2-5-10
    scaling, OscilloscopeRendering.cpp:439-549)."""
    span = window_seconds * (1000.0 if unit == "ms" else 1.0)
    step = suitable_axis_division(span, max_divisions)
    lines = []
    v = 0.0
    while v <= span + 1e-9:
        lines.append(AxisLine(v / span if span else 0.0, v, f"{v:g} {unit}"))
        v += step
    return lines


def cursor_readout(
    y_value: float,
    time_fraction: float,
    window_seconds: float,
    sample_rate: float,
    *,
    trigger_centered: bool = False,
) -> dict:
    """Oscilloscope cursor tracker readout (ref: cursor text box,
    OscilloscopeRendering.cpp:157-235): amplitude, dB, time in ms and
    samples at the cursor position.

    ``trigger_centered``: in the triggering modes the reference centers
    the time axis on the trigger — it subtracts half the
    (effectiveWindowSize - 1)-sample window so mid-screen reads 0
    (:205-212). Samples use the (N - 1) fence convention throughout."""
    dbs = 20.0 * math.log10(abs(y_value)) if y_value != 0 else float("-inf")
    total = max(window_seconds * sample_rate - 1.0, 0.0)  # N - 1 intervals
    smp = time_fraction * total
    if trigger_centered:
        smp -= total * 0.5
    t = smp / sample_rate if sample_rate else 0.0
    return {
        "amplitude": y_value,
        "dbs": dbs,
        "time_ms": t * 1e3,
        "samples": smp,
        "text": f"y: {y_value:+.4f} ({dbs:+.1f} dB)  t: {t*1e3:.2f} ms ({smp:.0f} smps)",
    }
