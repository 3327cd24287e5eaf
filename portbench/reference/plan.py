"""The reference's own design of a Spectrum view: window, pixel frequencies,
the bin-to-pixel plan, the decay poles and the dB map's constants.

A frozen copy of the numpy plan builders of the program under test
(``remap_frequencies``, ``build_remap_plan``, the cosine-sum windows,
``peak_decay_pole``; ref: Signalizer v0.4.3 TransformConstant.h:84-186,
TransformDSP.inl:540-639, Spectrum.cpp:392-393), kept here so that the
benchmark's reference takes nothing from the program: later changes to the
program's builders do not move the yardstick. Everything is float64 numpy;
:mod:`portbench.reference.spectrum` rounds it to the precision it computes in.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# ref: SpectrumParameters.h:78-80
MIN_DBS = -24.0 * 16
LANCZOS_FILTER_SIZE = 5  # ref: TransformDSP.inl:514
LN10_OVER_20 = 0.11512925464970229

# the Spectrum's channel modes (ref: CommonSignalizer.h:495-539), by name
CHANNEL_MODES = ("LEFT", "RIGHT", "MERGE", "SIDE", "PHASE", "SEPARATE", "MIDSIDE", "COMPLEX")
# w[n] = sum_k (-1)^k a_k cos(2 pi k n / (N - 1))
COSINE_WINDOWS = {
    "RECTANGULAR": (1.0,),
    "HANN": (0.5, 0.5),
    "HAMMING": (0.54, 0.46),
    "BLACKMAN": (0.42, 0.5, 0.08),
    "BLACKMAN_HARRIS": (0.35875, 0.48829, 0.14128, 0.01168),
}


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << int(n - 1).bit_length()


def cosine_window(name: str, size: int, symmetric: bool = True):
    """``(kernel[size], scale)`` with ``scale = size / sum(kernel)``."""
    coeffs = COSINE_WINDOWS[name]
    denom = (size - 1) if symmetric else size
    n = np.arange(size, dtype=np.float64)
    w = np.zeros(size, dtype=np.float64)
    for k, a in enumerate(coeffs):
        w += ((-1.0) ** k) * a * np.cos(2.0 * np.pi * k * n / denom)
    total = float(w.sum())
    return w, (size / total if total != 0.0 else 1.0)


def remap_frequencies(axis_points: int, sample_rate: float, logarithmic: bool, *,
                      min_freq: float = 10.0, view_left: float = 0.0, view_right: float = 1.0,
                      full_circle: bool = False) -> np.ndarray:
    """Pixel -> frequency (ref: TransformConstant.h:125-180)."""
    view_size = view_right - view_left
    half_rate = sample_rate * 0.5
    i = np.arange(axis_points, dtype=np.float64)
    if not logarithmic:
        factor = 2.0 if full_circle else 1.0
        return factor * (view_left * half_rate + view_size * i * (half_rate / (axis_points - 1)))
    arg = view_left + view_size * i / (axis_points - 1)
    if not full_circle:
        return min_freq * np.power(half_rate / min_freq, arg)
    lower = min_freq * np.power(half_rate / min_freq, arg * 2.0)
    upper = half_rate + (half_rate - min_freq * np.power(half_rate / min_freq, 1.0 - (arg - 0.5) * 2.0))
    return np.where(arg < 0.5, lower, upper)


@dataclasses.dataclass(frozen=True)
class RemapPlan:
    """Pixels ``[0, interp_break)`` interpolate taps; the rest take the max
    of a contiguous chunk of bins, or one bin where the chunk is empty."""

    interp_indices: np.ndarray  # [P, taps]
    interp_weights: np.ndarray  # [P, taps]
    interp_mask: np.ndarray  # [P]
    single_bin: np.ndarray  # [P]
    single_mask: np.ndarray  # [P]
    band_lo: np.ndarray  # [P]
    band_len: np.ndarray  # [P]
    n_values: int


def _reflect(idx: np.ndarray, n: int) -> np.ndarray:
    period = max(2 * (n - 1), 1)
    idx = np.abs(idx) % period
    return np.where(idx > n - 1, period - idx, idx)


def build_remap_plan(freqs: np.ndarray, sample_rate: float, transform_size: int, interpolation: str,
                     *, full_circle: bool = False) -> RemapPlan:
    """The reference's interpolate-vs-binmax pixel walk
    (ref: TransformDSP.inl:562-639) as tables."""
    p = len(freqs)
    num_bins = transform_size // 2
    top = sample_rate / 2.0
    n_values = transform_size if full_circle else num_bins + 1
    fft_bandwidth = 1.0 / (num_bins * 2) if full_circle else 1.0 / num_bins
    f = np.asarray(freqs, dtype=np.float64)
    bw = np.empty(p, dtype=np.float64)
    bw[: p - 1] = (f[1:] - f[:-1]) / top
    bw[p - 1] = np.inf
    over = np.nonzero(bw > fft_bandwidth)[0]
    interp_break = int(over[0]) if len(over) else p - 1
    pos = f * (num_bins / top)
    if interpolation == "NONE":
        idx = np.clip((pos + 0.5).astype(np.int64), 0, n_values - 1)[:, None]
        wts = np.ones((p, 1), dtype=np.float64)
    elif interpolation == "LINEAR":
        i0 = np.floor(pos).astype(np.int64)
        frac = pos - i0
        idx = np.stack([i0, i0 + 1], axis=1)
        wts = np.stack([1.0 - frac, frac], axis=1)
    elif interpolation == "LANCZOS":
        a = LANCZOS_FILTER_SIZE
        i0 = np.floor(pos).astype(np.int64)
        idx = i0[:, None] + np.arange(-a + 1, a + 1)[None, :]
        t = pos[:, None] - idx
        wts = np.where(np.abs(t) < a, np.sinc(t) * np.sinc(t / a), 0.0)
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    idx = idx % n_values if full_circle else _reflect(idx, n_values)
    interp_mask = np.zeros(p, dtype=bool)
    interp_mask[:interp_break] = True
    single_bin = np.zeros(p, dtype=np.int64)
    single_mask = np.zeros(p, dtype=bool)
    band_lo = np.zeros(p, dtype=np.int64)
    band_len = np.zeros(p, dtype=np.int64)
    old_bin = int(pos[interp_break])
    for x in range(interp_break, p):
        b = min(int(pos[x]), n_values - 1)
        if b - old_bin <= 0:
            single_bin[x] = b
            single_mask[x] = True
        else:
            lo = min(old_bin + 1, n_values - 1)
            band_lo[x] = lo
            band_len[x] = min(b, n_values - 1) - lo + 1
        old_bin = b
    return RemapPlan(idx, wts, interp_mask, single_bin, single_mask, band_lo, band_len, n_values)


def peak_decay_pole(decay_seconds: float, frames_per_second: float, fraction: float = 0.1) -> float:
    """pole = fraction^(1 / (t * fps)): the peak falls to ``fraction`` in
    ``decay_seconds`` (ref: Spectrum.cpp:392-393)."""
    if decay_seconds <= 0.0 or frames_per_second <= 0.0:
        return 0.0
    return float(fraction ** (1.0 / (decay_seconds * frames_per_second)))


@dataclasses.dataclass(frozen=True)
class ViewDesign:
    """Every number the reference needs for one Spectrum view, float64."""

    mode: str
    window: np.ndarray  # [W]
    transform_size: int
    inv_size: float
    plan: RemapPlan
    slope: np.ndarray  # [P]
    poles: np.ndarray  # [K]
    lower: float
    delta_y_recip: float
    clip_db: float

    @property
    def rows(self) -> int:
        return 1 if self.mode in ("LEFT", "RIGHT", "MERGE", "SIDE") else 2


def design(view: dict) -> ViewDesign:
    """The design of the view a configuration file states (its ``view``
    object: ``window_size``, ``sample_rate``, ``axis_points``, ``channels``,
    ``interpolation``, ``axis``, and optionally ``window``, ``low_dbs``,
    ``high_dbs``, ``decay_seconds``, ``frames_per_second``, ``slope_a``,
    ``slope_b``, ``min_freq``)."""
    mode = view["channels"]
    if mode not in CHANNEL_MODES or mode in ("PHASE", "COMPLEX"):
        raise ValueError(f"the reference covers the magnitude modes with a half spectrum, not {mode!r}")
    w_size, fs = int(view["window_size"]), float(view["sample_rate"])
    window, scale = cosine_window(view.get("window", "HANN"), w_size)
    n = max(32, next_pow2(w_size))
    freqs = remap_frequencies(int(view["axis_points"]), fs, view["axis"] == "LOGARITHMIC",
                              min_freq=float(view.get("min_freq", 10.0)))
    plan = build_remap_plan(freqs, fs, n, view["interpolation"])
    low, high = float(view.get("low_dbs", -96.0)), float(view.get("high_dbs", 0.0))
    if high - low < 0.1:
        high = low + 0.1
    lower = np.exp(low * LN10_OVER_20)
    upper = np.exp(high * LN10_OVER_20)
    decays = view.get("decay_seconds", [0.1, 1.0])
    fps = float(view.get("frames_per_second", 60.0))
    k = int(view.get("line_graphs", 2))
    poles = np.array([peak_decay_pole(decays[min(i, len(decays) - 1)], fps) for i in range(k)])
    slope = float(view.get("slope_b", 1.0)) * np.power(np.maximum(freqs, 1e-30), float(view.get("slope_a", 0.0)))
    return ViewDesign(
        mode=mode, window=window, transform_size=n, inv_size=scale / (w_size * 0.5), plan=plan,
        slope=slope, poles=poles, lower=float(lower), delta_y_recip=float(1.0 / np.log(upper / lower)),
        clip_db=float(view.get("clip_db", MIN_DBS)),
    )
