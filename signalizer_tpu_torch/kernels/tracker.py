"""Frequency tracker: peak search, parabolic refinement, semitone display.

Equivalent of the reference's cursor frequency tracker
(ref: Source/Spectrum/SpectrumRendering.cpp:377-470 drawFrequencyTracking —
nearest-peak search within a +-3% window with boundary ascent, parabolic
log-domain 3-point interpolation per JOS/PARSHL, scalloping-loss estimate
via SpectrumDSP.cpp:258-318; frequencyToSemitone :59-73; peak smoothing
SmoothedPeakState, Spectrum.h:405-459).

Host-side numpy: the tracker runs once per UI frame on one row of bins —
there is nothing to batch. Kept beside the kernels because its math must
agree with the device pipeline's scaling conventions.

The port's own copy of :mod:`signalizer_tpu.kernels.tracker`, arithmetic and names unchanged;
tests/test_torch_params_state.py holds the two equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

SEMITONE_NAMES = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")


@dataclass
class PeakResult:
    fraction: float  # peak position as fraction of the half spectrum
    frequency: float  # Hz
    dbs: float  # parabolic-refined magnitude in dB
    bin_index: int


def track_peak(
    magnitudes: np.ndarray,
    sample_rate: float,
    cursor_fraction: float,
    *,
    inv_size: float = 1.0,
    search_tolerance: float = 0.03,
) -> PeakResult:
    """Find the spectral peak nearest the cursor.

    ``magnitudes``: linear bin magnitudes [N/2+1] (pre inv_size scaling);
    ``cursor_fraction``: cursor position in [0, 1] over the half spectrum.
    Search window is +-``search_tolerance`` of the spectrum around the
    cursor (ref: the +-3%% window), with boundary ascent: when the max sits
    on the window edge, walk outward uphill so a nearby larger peak is not
    cut in half (ref: SpectrumRendering.cpp:395-424).
    """
    mags = np.asarray(magnitudes, np.float64)
    n = len(mags)
    # clamp the cursor into the view: dragging past either edge must
    # search the edge window, not slice an empty (or wrapped) range
    center = int(round(min(max(cursor_fraction, 0.0), 1.0) * (n - 1)))
    half_window = max(1, int(round(search_tolerance * n)))
    lo = max(0, min(center - half_window, n - 1))
    hi = min(n, max(center + half_window + 1, lo + 1))

    peak = lo + int(np.argmax(mags[lo:hi] ** 2))
    if peak == lo:
        while peak > 0 and mags[peak - 1] ** 2 >= mags[peak] ** 2:
            peak -= 1
    elif peak == hi - 1:
        while peak < n - 1 and mags[peak + 1] ** 2 >= mags[peak] ** 2:
            peak += 1

    # parabolic refinement in dB domain (JOS/PARSHL)
    def db_at(i: int) -> float:
        v = abs(mags[min(max(i, 0), n - 1)]) * inv_size
        return 20.0 * math.log10(v) if v > 0 else -400.0

    alpha = db_at(peak - 1)
    beta = db_at(peak)
    gamma = db_at(peak + 1)
    denom = alpha - 2.0 * beta + gamma
    phi = 0.5 * (alpha - gamma) / denom if denom != 0 and math.isfinite(denom) else 0.0
    if not math.isfinite(phi):
        phi = 0.0
    fraction = (peak + phi) / (n - 1)
    peak_dbs = beta - 0.25 * (alpha - gamma) * phi
    if not math.isfinite(peak_dbs):
        peak_dbs = beta
    return PeakResult(
        fraction=fraction,
        frequency=fraction * sample_rate * 0.5,
        dbs=peak_dbs,
        bin_index=peak,
    )


def frequency_to_semitone(frequency: float, a4_reference: float = 440.0) -> str:
    """Note name + octave + cents detune (ref: frequencyToSemitone,
    SpectrumRendering.cpp:59-73; expressed in the standard MIDI note
    convention — A4 = 69 — rather than the reference's piano-key math)."""
    if not math.isfinite(frequency) or frequency <= 0:
        return "nan"
    midi = 69.0 + 12.0 * math.log2(abs(frequency / a4_reference))
    rounded = round(midi)
    semitone_index = rounded % 12
    octave = rounded // 12 - 1
    detune_cents = round(1000 * (midi - rounded)) * 0.1
    return f"{SEMITONE_NAMES[semitone_index]}{octave}{detune_cents:+.1f}c"


def scalloping_loss_at(
    window_kernel: np.ndarray, bin_fraction: float
) -> float:
    """Scalloping loss (linear gain) at a fractional bin offset
    (ref: getScallopingLossAtCoordinate, SpectrumDSP.cpp:258-318 — the
    tracker corrects displayed magnitudes for the window's off-center
    attenuation)."""
    from signalizer_tpu_torch.core.windows import window_dtft_gain

    frac = bin_fraction - math.floor(bin_fraction + 0.5)
    return window_dtft_gain(np.asarray(window_kernel, np.float64), abs(frac))


class SmoothedPeakState:
    """Peak display smoothing (ref: SmoothedPeakState, Spectrum.h:405-459).

    Reference semantics: a held linear peak decays with a slow pole
    (designed over ``smoothing_ms * 10``); a new louder peak *captures* the
    display (its frequency/dB become the targets, the hold level jumps to
    1.2x); the displayed frequency/dB lag their targets with a fast pole
    (``smoothing_ms / 5``). Deviation: poles are the standard
    ``exp(-1/(ms * 1e-3 * rate))`` one-pole design rather than cpl's
    SmoothedParameterState<_, 8> 8-section design (same time constant,
    slightly softer knee).
    """

    def __init__(self, smoothing_ms: float = 100.0, frame_rate: float = 60.0):
        self.design(smoothing_ms, frame_rate)
        self._held_peak = 0.0
        self._target_freq: Optional[float] = None
        self._target_dbs = 0.0
        self._freq: Optional[float] = None
        self._dbs: Optional[float] = None

    @staticmethod
    def _pole(ms: float, rate: float) -> float:
        n = max(ms * 1e-3 * rate, 1e-9)
        return math.exp(-1.0 / n)

    def design(self, smoothing_ms: float, frame_rate: float) -> None:
        """ref: design(ms*10, rate) hold pole, design(ms/5, rate) lag pole."""
        self.smoothing_ms = float(smoothing_ms)
        if smoothing_ms <= 0:
            self.peak_pole = 0.0
            self.filter_pole = 0.0
            return
        self.peak_pole = self._pole(smoothing_ms * 10.0, frame_rate)
        self.filter_pole = self._pole(smoothing_ms / 5.0, frame_rate)

    def update(self, peak: PeakResult) -> Tuple[float, float]:
        linear = 10.0 ** (peak.dbs / 20.0)
        self._held_peak *= self.peak_pole
        if linear > self._held_peak or self._target_freq is None:
            self._held_peak = 1.2 * (linear / max(self.peak_pole, 1e-9))
            self._target_freq = peak.frequency
            self._target_dbs = peak.dbs
        if self._freq is None:
            self._freq, self._dbs = self._target_freq, self._target_dbs
        else:
            self._freq = self._target_freq + self.filter_pole * (self._freq - self._target_freq)
            self._dbs = self._target_dbs + self.filter_pole * (self._dbs - self._target_dbs)
        return self._freq, self._dbs

    def reset(self) -> None:
        self._freq = self._dbs = None
        self._target_freq = None
        self._held_peak = 0.0


class FrequencyTracker:
    """Cursor frequency tracker facade: peak search + smoothing + note
    readout with the view's knobs applied (ref: drawFrequencyTracking,
    SpectrumRendering.cpp:377-470 — consumes trackerSmoothing and the
    reference tuning)."""

    def __init__(
        self,
        sample_rate: float = 48_000.0,
        *,
        a4_reference: float = 440.0,
        smoothing_ms: float = 0.0,
        frame_rate: float = 60.0,
        window_kernel: Optional[np.ndarray] = None,
        source: str = "transform",
    ):
        self.sample_rate = float(sample_rate)
        self.a4_reference = float(a4_reference)
        self.window_kernel = window_kernel
        # what the tracker evaluates (ref: frequencyTrackingGraph,
        # Spectrum.cpp:368): "transform" = raw FFT bins, "graphK" = the
        # decayed display row of line graph K
        self.source = source
        self.smoother = SmoothedPeakState(smoothing_ms, frame_rate)

    def update(
        self,
        magnitudes: np.ndarray,
        cursor_fraction: float,
        *,
        inv_size: float = 1.0,
    ) -> dict:
        """One UI tick: returns dict(frequency, dbs, note, scalloping_dbs)."""
        peak = track_peak(
            magnitudes, self.sample_rate, cursor_fraction, inv_size=inv_size
        )
        if self.smoother.smoothing_ms > 0:
            freq, dbs = self.smoother.update(peak)
        else:
            freq, dbs = peak.frequency, peak.dbs
        out = dict(
            frequency=freq,
            dbs=dbs,
            note=frequency_to_semitone(freq, self.a4_reference),
            source=self.source,
        )
        if self.window_kernel is not None:
            n_bins = len(magnitudes) - 1
            loss = scalloping_loss_at(
                self.window_kernel, peak.fraction * n_bins
            )
            out["scalloping_dbs"] = 20.0 * math.log10(max(loss, 1e-12))
        return out

    def update_display(
        self,
        row: np.ndarray,
        mapped_frequencies: np.ndarray,
        cursor_fraction: float,
        *,
        low_dbs: float = -96.0,
        high_dbs: float = 0.0,
    ) -> dict:
        """One UI tick over a *display-space* line-graph row (FTracker =
        Main/Aux graph): peak in pixel space, frequency from the
        pixel->frequency map."""
        peak = track_display_peak(
            row, mapped_frequencies, cursor_fraction,
            low_dbs=low_dbs, high_dbs=high_dbs,
        )
        if self.smoother.smoothing_ms > 0:
            freq, dbs = self.smoother.update(peak)
        else:
            freq, dbs = peak.frequency, peak.dbs
        return dict(
            frequency=freq,
            dbs=dbs,
            note=frequency_to_semitone(freq, self.a4_reference),
            source=self.source,
        )


def track_display_peak(
    row: np.ndarray,
    mapped_frequencies: np.ndarray,
    cursor_fraction: float,
    *,
    low_dbs: float = -96.0,
    high_dbs: float = 0.0,
    search_tolerance: float = 0.03,
) -> PeakResult:
    """Peak search over a *display-space* line-graph row (the reference
    tracks the selected graph's results, not the raw transform, when
    FTracker = Main/Aux graph; ref: SpectrumRendering.cpp:185-240).

    ``row``: [P] normalized display values; frequency comes from the
    pixel->frequency map, dBs from denormalizing the display value.
    """
    row = np.asarray(row, np.float64)
    p = len(row)
    # clamp the cursor into the view (see track_peak)
    center = int(round(min(max(cursor_fraction, 0.0), 1.0) * (p - 1)))
    half = max(1, int(round(search_tolerance * p)))
    lo = max(0, min(center - half, p - 1))
    hi = min(p, max(center + half + 1, lo + 1))
    peak = lo + int(np.argmax(row[lo:hi]))
    if peak == lo:
        while peak > 0 and row[peak - 1] >= row[peak]:
            peak -= 1
    elif peak == hi - 1:
        while peak < p - 1 and row[peak + 1] >= row[peak]:
            peak += 1
    f = np.asarray(mapped_frequencies, np.float64)
    return PeakResult(
        fraction=peak / (p - 1),
        frequency=float(f[peak]),
        dbs=low_dbs + float(np.clip(row[peak], 0, 1)) * (high_dbs - low_dbs),
        bin_index=peak,
    )
