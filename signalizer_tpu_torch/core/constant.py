"""SpectrumConstant for the PyTorch port: the immutable per-reconfiguration
data bundle of the Spectrum view.

Counterpart of :mod:`signalizer_tpu.core.constant` (ref:
Source/Spectrum/TransformConstant.h:44-241). The numpy remap-plan functions
(:func:`build_remap_plan`, :func:`remap_frequencies`) are copied here with
their arithmetic unchanged (the port imports nothing of the JAX package);
tests hold the copies bit-equal to the originals.

The constant is a frozen dataclass: static fields are plain Python values,
array fields are tensors on one explicit ``device``. It drops the JAX
package's TPU routing fields (``fft_backend``, ``remap_mode``,
``fft_precision``, ``interp_dense``) and adds what the port's hand
kernels read:

* ``chunk_lo`` / ``chunk_len`` [P] int32 — each bin-max pixel's contiguous
  chunk ``[lo, lo + len)``, the ranges ``band_idx[:, 0]`` and
  ``band_mask.sum(1)`` already encode (0-length for other pixels);
* ``fft_twiddles`` [N, 2] f32 — every radix-2 stage's twiddles in stage
  order (see :func:`fft_twiddles`), computed in float64 on the host and
  rounded once, for the FFT kernel;
* ``host_frequencies`` [P] float64 numpy — the pixel frequencies as they
  were designed, before their rounding to f32, for host-side design that
  starts from them (the resonator bank);
* ``display_scalars`` [4] f32 (derived) — ``inv_size``, the dB map's
  ``lower`` and ``1/log(upper/lower)`` computed in f32 exactly as the dB map
  computes them, and ``clip_db``, so the display kernel reads them on the
  device with no host readback.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from signalizer_tpu_torch.core.config import (
    BinInterpolation,
    DisplayMode,
    SpectrumChannels,
    TransformAlgorithm,
    ViewScaling,
    next_pow2,
)
from signalizer_tpu_torch.core.scaling import peak_decay_pole
from signalizer_tpu_torch.core.windows import WindowType, generate_window

# ref: SpectrumParameters.h:48-51 — LineMain + LineSecond.
NUM_LINE_GRAPHS = 2
# ref: SpectrumParameters.h:78-80.
MIN_DBS = -24.0 * 16
MAX_DBS = 24.0 * 4
LANCZOS_FILTER_SIZE = 5  # ref: TransformDSP.inl:514
LN10_OVER_20 = 0.11512925464970229


@dataclasses.dataclass(frozen=True)
class RemapPlan:
    """Precomputed pixel<-bin mapping (host numpy; becomes device tensors).

    ``n_values`` spectrum values feed ``axis_points`` display pixels.
    Pixels ``[0, interp_break)`` use tap interpolation; the rest use
    chunked bin-max (ref: TransformDSP.inl:567-639 loop structure).
    """

    # [P, taps] gather indices into the spectrum value array, reflected at
    # the edges (|X| is even-symmetric around DC/Nyquist for real inputs).
    interp_indices: np.ndarray
    # [P, taps] interpolation weights (None: one-hot; Linear: 2 taps;
    # Lanczos: 2*a taps).
    interp_weights: np.ndarray
    # [P] True where the pixel uses interpolation, False where bin-max.
    interp_mask: np.ndarray
    # [n_values] bin -> pixel id for multi-bin chunks (== P for bins not
    # owned by any pixel). Chunks {oldBin+1 .. bin} are disjoint.
    segment_ids: np.ndarray
    # [P] the single bin sampled when a bin-max pixel's chunk is empty
    # (diff == 0 case in the reference loop).
    single_bin: np.ndarray
    # [P] True where the bin-max pixel has an empty chunk.
    single_mask: np.ndarray
    # [P, maxband] banded view of the same chunks: each bin-max pixel's
    # chunk {oldBin+1 .. bin} is CONTIGUOUS. Interp/single pixels get
    # all-masked rows.
    band_idx: np.ndarray
    band_mask: np.ndarray
    n_values: int
    interp_break: int


def _lanczos_kernel(t: np.ndarray, a: int) -> np.ndarray:
    out = np.sinc(t) * np.sinc(t / a)
    return np.where(np.abs(t) < a, out, 0.0)


def _reflect_indices(idx: np.ndarray, n: int) -> np.ndarray:
    """Reflect indices into [0, n-1] (even symmetry at both ends)."""
    period = max(2 * (n - 1), 1)
    idx = np.abs(idx) % period
    return np.where(idx > n - 1, period - idx, idx)


def build_remap_plan(
    mapped_frequencies: np.ndarray,
    sample_rate: float,
    transform_size: int,
    interpolation: BinInterpolation,
    *,
    full_circle: bool = False,
) -> RemapPlan:
    """Replicates the reference's interpolate-vs-binmax pixel walk
    (ref: TransformDSP.inl:562-639) as static gather/segment tables.

    ``full_circle=True`` is the Complex channel mode, where pixels map the
    whole 0..fs circle of an N-point complex FFT; otherwise values are the
    ``N/2 + 1`` bins of a real FFT.
    """
    P = len(mapped_frequencies)
    N = transform_size
    num_bins = N // 2
    top_frequency = sample_rate / 2.0
    freq_to_bin = num_bins / top_frequency
    n_values = N if full_circle else num_bins + 1
    # Complex (full-circle) mode switches to bin-max at TWICE the pixel
    # density: fftBandwidth = 1/(numBins*2) (ref: TransformDSP.inl:995,
    # vs 1/numBins in the half-spectrum paths :562/875)
    fft_bandwidth = 1.0 / (num_bins * 2) if full_circle else 1.0 / num_bins

    f = np.asarray(mapped_frequencies, dtype=np.float64)

    # --- find the interpolation break point --------------------------------
    # for x in [0, P-1): interpolate while pixel bandwidth <= fft bandwidth.
    # The final pixel always falls through to the bin-max loop
    # (ref loop bound `x < axisPoints - 1`, TransformDSP.inl:568).
    bw = np.empty(P, dtype=np.float64)
    bw[: P - 1] = (f[1:] - f[:-1]) / top_frequency
    bw[P - 1] = np.inf
    over = np.nonzero(bw > fft_bandwidth)[0]
    interp_break = int(over[0]) if len(over) else P - 1

    # --- interpolation taps -------------------------------------------------
    pos = f * freq_to_bin  # fractional bin position per pixel
    if interpolation == BinInterpolation.NONE:
        # +0.5 centering, clamped (ref: TransformDSP.inl:577)
        idx = np.clip((pos + 0.5).astype(np.int64), 0, n_values - 1)[:, None]
        wts = np.ones((P, 1), dtype=np.float64)
    elif interpolation == BinInterpolation.LINEAR:
        i0 = np.floor(pos).astype(np.int64)
        frac = pos - i0
        idx = np.stack([i0, i0 + 1], axis=1)
        wts = np.stack([1.0 - frac, frac], axis=1)
    elif interpolation == BinInterpolation.LANCZOS:
        a = LANCZOS_FILTER_SIZE
        i0 = np.floor(pos).astype(np.int64)
        offs = np.arange(-a + 1, a + 1)
        idx = i0[:, None] + offs[None, :]
        wts = _lanczos_kernel(pos[:, None] - idx, a)
    else:  # pragma: no cover
        raise ValueError(interpolation)

    if full_circle:
        idx = idx % n_values
    else:
        idx = _reflect_indices(idx, n_values)

    interp_mask = np.zeros(P, dtype=bool)
    interp_mask[:interp_break] = True

    # --- bin-max chunks ------------------------------------------------------
    segment_ids = np.full(n_values, P, dtype=np.int64)
    single_bin = np.zeros(P, dtype=np.int64)
    single_mask = np.zeros(P, dtype=bool)

    band_lo = np.zeros(P, dtype=np.int64)
    band_len = np.zeros(P, dtype=np.int64)

    old_bin = int(pos[interp_break])  # truncation, ref :606
    for x in range(interp_break, P):
        b = int(pos[x])
        b = min(b, n_values - 1)
        diff = b - old_bin
        if diff <= 0:
            single_bin[x] = b
            single_mask[x] = True
        else:
            lo = min(old_bin + 1, n_values - 1)
            hi = min(b, n_values - 1)
            segment_ids[lo : hi + 1] = x
            band_lo[x] = lo
            band_len[x] = hi - lo + 1
        old_bin = b

    maxband = max(int(band_len.max()), 1)
    j = np.arange(maxband)[None, :]
    band_idx = np.clip(band_lo[:, None] + j, 0, n_values - 1)
    band_mask = j < band_len[:, None]

    return RemapPlan(
        interp_indices=idx.astype(np.int32),
        interp_weights=wts,
        interp_mask=interp_mask,
        segment_ids=segment_ids.astype(np.int32),
        single_bin=single_bin.astype(np.int32),
        single_mask=single_mask,
        band_idx=band_idx.astype(np.int32),
        band_mask=band_mask,
        n_values=n_values,
        interp_break=interp_break,
    )


def remap_frequencies(
    axis_points: int,
    sample_rate: float,
    scaling: ViewScaling,
    *,
    view_left: float = 0.0,
    view_right: float = 1.0,
    min_freq: float = 10.0,
    configuration: SpectrumChannels = SpectrumChannels.LEFT,
) -> np.ndarray:
    """Pixel -> frequency map (ref: TransformConstant.h:125-180).

    Linear: evenly spaced across the (zoomed) view; Complex mode doubles the
    span to cover 0..fs. Logarithmic: exponential from ``min_freq`` to
    Nyquist; Complex mode mirrors the log curve around Nyquist.
    """
    view_size = view_right - view_left
    half_rate = sample_rate * 0.5
    i = np.arange(axis_points, dtype=np.float64)

    if scaling == ViewScaling.LINEAR:
        complex_factor = 2.0 if configuration == SpectrumChannels.COMPLEX else 1.0
        freq_per_pixel = half_rate / (axis_points - 1)
        return complex_factor * (view_left * half_rate + view_size * i * freq_per_pixel)

    # logarithmic
    end = half_rate
    arg = view_left + view_size * i / (axis_points - 1)
    if configuration != SpectrumChannels.COMPLEX:
        return min_freq * np.power(end / min_freq, arg)
    lower = min_freq * np.power(end / min_freq, arg * 2.0)
    upper = end + (end - min_freq * np.power(end / min_freq, 1.0 - (arg - 0.5) * 2.0))
    return np.where(arg < 0.5, lower, upper)


def chunk_ranges(band_idx: np.ndarray, band_mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(chunk_lo, chunk_len)`` int32 [P] from the banded chunk tables: a
    bin-max pixel's chunk is the contiguous range ``[lo, lo + len)``."""
    band_idx = np.asarray(band_idx)
    band_mask = np.asarray(band_mask, dtype=bool)
    return (
        band_idx[:, 0].astype(np.int32),
        band_mask.sum(axis=1).astype(np.int32),
    )


def fft_twiddles(transform_size: int) -> np.ndarray:
    """[N, 2] f32 ``(cos, sin)`` twiddles of an N-point radix-2 transform in
    stage order: entry ``half + pos`` (``half`` = 1, 2, .., N/2; ``pos`` <
    ``half``) is ``exp(-2*pi*i*pos / (2*half))``; entry 0 is unused (1, 0).
    Float64 on the host, rounded once (the display floor is -96 dB, so no
    fast-math sines). The first N/2 entries are the same table for an
    N/2-point transform, and the last N/2 are ``exp(-2*pi*i*k/N)``: a packed
    real transform takes its core's stages from the former and its split
    factors from the latter. The long form of the FFT kernel reads its
    four-step twiddles exp(-2*pi*i*j/L) (L the core's length) from stage
    L/2's entries, negated for j >= L/2."""
    out = np.empty((transform_size, 2), np.float64)
    out[0] = (1.0, 0.0)
    half = 1
    while half < transform_size:
        ang = -2.0 * np.pi * np.arange(half, dtype=np.float64) / (2 * half)
        out[half : 2 * half, 0] = np.cos(ang)
        out[half : 2 * half, 1] = np.sin(ang)
        half *= 2
    return out.astype(np.float32)


STATIC_FIELDS = (
    "axis_points",
    "window_size",
    "transform_size",
    "configuration",
    "bin_interpolation",
    "view_scaling",
    "algo",
    "display_mode",
    "sample_rate",
    "num_line_graphs",
    "interp_taps",
    "n_spectrum_values",
)
# tensor fields shared with the JAX constant, with the dtype each carries
ARRAY_FIELDS = {
    "window_kernel": torch.float32,
    "inv_size": torch.float32,
    "mapped_frequencies": torch.float32,
    "slope_map": torch.float32,
    "low_dbs": torch.float32,
    "high_dbs": torch.float32,
    "clip_db": torch.float32,
    "decay_poles": torch.float32,
    "interp_indices": torch.int32,
    "interp_weights": torch.float32,
    "interp_mask": torch.bool,
    "single_bin": torch.int32,
    "single_mask": torch.bool,
    "band_idx": torch.int32,
    "band_mask": torch.bool,
}


def db_constants(low_dbs: torch.Tensor, high_dbs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lower, 1/log(upper/lower))`` of the normalized dB map, in the
    tensors' dtype and in the order the JAX ``_db_map`` evaluates them."""
    lower = torch.exp(low_dbs * LN10_OVER_20)
    upper = torch.exp(high_dbs * LN10_OVER_20)
    return lower, 1.0 / torch.log(upper / lower)


@dataclasses.dataclass(frozen=True, eq=False)
class SpectrumConstant:
    """Immutable spectrum configuration: static Python fields plus tensors
    on one device. Built via :func:`make_spectrum_constant` or
    :func:`constant_from_arrays`; moved with :meth:`to`."""

    # --- static -------------------------------------------------------------
    axis_points: int
    window_size: int
    transform_size: int
    configuration: SpectrumChannels
    bin_interpolation: BinInterpolation
    view_scaling: ViewScaling
    algo: TransformAlgorithm
    display_mode: DisplayMode
    sample_rate: float
    num_line_graphs: int
    interp_taps: int
    n_spectrum_values: int

    # --- tensors ------------------------------------------------------------
    window_kernel: torch.Tensor  # [window_size] f32
    inv_size: torch.Tensor  # 0-d f32: windowKernelScale/(windowSize*0.5)
    mapped_frequencies: torch.Tensor  # [P] f32
    slope_map: torch.Tensor  # [P] f32 — b * f^a power slope
    low_dbs: torch.Tensor  # 0-d f32
    high_dbs: torch.Tensor  # 0-d f32
    clip_db: torch.Tensor  # 0-d f32
    decay_poles: torch.Tensor  # [num_line_graphs] f32 per-frame decay
    interp_indices: torch.Tensor  # [P, taps] i32
    interp_weights: torch.Tensor  # [P, taps] f32
    interp_mask: torch.Tensor  # [P] bool
    single_bin: torch.Tensor  # [P] i32
    single_mask: torch.Tensor  # [P] bool
    band_idx: torch.Tensor  # [P, maxband] i32
    band_mask: torch.Tensor  # [P, maxband] bool
    chunk_lo: torch.Tensor  # [P] i32
    chunk_len: torch.Tensor  # [P] i32
    fft_twiddles: torch.Tensor  # [N, 2] f32, stage order
    # [P] float64 on the host: the design-time pixel frequencies before
    # their rounding to f32 (the resonator bank is designed from them)
    host_frequencies: np.ndarray = dataclasses.field(repr=False)
    # design-time host copies of the fields a host consumer reads every
    # tick (render feed, tracker): see :func:`host_view`. Kept by :meth:`to`
    host_data: Dict[str, object] = dataclasses.field(default=None, repr=False)
    # [4] f32: inv_size, lower, 1/log(upper/lower), clip_db — derived from
    # the fields above whenever the constant is built or replaced
    display_scalars: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        lower, dyr = db_constants(self.low_dbs, self.high_dbs)
        scalars = torch.stack([self.inv_size, lower, dyr, self.clip_db])
        object.__setattr__(self, "display_scalars", scalars)

    @property
    def device(self) -> torch.device:
        return self.window_kernel.device

    @property
    def num_bins(self) -> int:
        return self.transform_size // 2

    @property
    def state_channels(self) -> int:
        """Result rows (ref: TransformConstant.h:183-186)."""
        return self.configuration.state_channels

    def to(self, device) -> "SpectrumConstant":
        """The same constant with every tensor on ``device``."""
        device = torch.device(device)
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if f.init and isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **moved)


def check_device(device) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device on a machine
    without one (the port never carries on on the CPU instead)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is False")
    return device


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device=None`` means the GPU
    (``cuda``), anything else is taken as given. Either way a CUDA device
    on a machine without one raises (:func:`check_device`); the CPU is used
    only when the caller asks for it."""
    return check_device("cuda" if device is None else device)


def constant_from_arrays(
    static: Dict[str, object], arrays: Dict[str, np.ndarray], device=None
) -> SpectrumConstant:
    """Build the port's constant from a constant's static fields and its
    array fields given as numpy arrays (e.g. a JAX ``SpectrumConstant`` read
    with ``np.asarray``). The kernel tables (``chunk_lo``, ``chunk_len``,
    ``fft_twiddles``) are derived on the host. ``device=None`` is the GPU."""
    device = resolve_device(device)
    tensors = {
        name: torch.tensor(np.asarray(arrays[name])).to(device=device, dtype=dtype)
        for name, dtype in ARRAY_FIELDS.items()
    }
    chunk_lo, chunk_len = chunk_ranges(arrays["band_idx"], arrays["band_mask"])
    tensors["chunk_lo"] = torch.from_numpy(chunk_lo).to(device)
    tensors["chunk_len"] = torch.from_numpy(chunk_len).to(device)
    tensors["fft_twiddles"] = torch.from_numpy(fft_twiddles(int(static["transform_size"]))).to(device)
    host_frequencies = np.array(arrays["mapped_frequencies"], dtype=np.float64)
    host_data = {"mapped_frequencies": host_frequencies}
    for name in ("inv_size", "low_dbs", "high_dbs"):
        host_data[name] = np.float64(np.ravel(np.asarray(arrays[name], dtype=np.float64))[0])
    return SpectrumConstant(
        axis_points=int(static["axis_points"]),
        window_size=int(static["window_size"]),
        transform_size=int(static["transform_size"]),
        configuration=SpectrumChannels(static["configuration"]),
        bin_interpolation=BinInterpolation(static["bin_interpolation"]),
        view_scaling=ViewScaling(static["view_scaling"]),
        algo=TransformAlgorithm(static["algo"]),
        display_mode=DisplayMode(static["display_mode"]),
        sample_rate=float(static["sample_rate"]),
        num_line_graphs=int(static["num_line_graphs"]),
        interp_taps=int(static["interp_taps"]),
        n_spectrum_values=int(static["n_spectrum_values"]),
        host_frequencies=host_frequencies,
        host_data=host_data,
        **tensors,
    )


def host_view(constant: SpectrumConstant, name: str):
    """Host copy of a constant field, made when the constant was built
    (float64 design values; ``inv_size``, ``low_dbs`` and ``high_dbs`` as
    0-d float64). Never reads a device tensor: a per-tick consumer on the
    host (render feed, frequency tracker) would otherwise synchronize with
    the device once per field per tick. Raises ``KeyError`` for a field
    without a host copy."""
    data = constant.host_data
    if data is None or name not in data:
        raise KeyError(f"SpectrumConstant has no host copy of {name!r}")
    return data[name]


def make_spectrum_constant(
    *,
    axis_points: int,
    window_size: int,
    device=None,
    sample_rate: float = 48_000.0,
    configuration: SpectrumChannels = SpectrumChannels.LEFT,
    bin_interpolation: BinInterpolation = BinInterpolation.LINEAR,
    view_scaling: ViewScaling = ViewScaling.LINEAR,
    algo: TransformAlgorithm = TransformAlgorithm.FFT,
    display_mode: DisplayMode = DisplayMode.LINE_GRAPH,
    window_type: WindowType = WindowType.HANN,
    window_symmetric: bool = True,
    window_alpha: float = 2.5,
    window_beta: float = 8.0,
    view_left: float = 0.0,
    view_right: float = 1.0,
    min_freq: float = 10.0,
    low_dbs: float = -96.0,
    high_dbs: float = 0.0,
    clip_db: float = MIN_DBS,
    slope_a: float = 0.0,
    slope_b: float = 1.0,
    decay_seconds: Tuple[float, ...] = (0.1, 1.0),
    frames_per_second: float = 60.0,
    num_line_graphs: int = NUM_LINE_GRAPHS,
    mapped_frequencies: Optional[np.ndarray] = None,
) -> SpectrumConstant:
    """Build a :class:`SpectrumConstant` on ``device`` (host precompute,
    then one upload); ``device=None`` is the GPU, and raises without one.

    Mirrors the reference's reconfiguration cascade
    (ref: Spectrum.cpp:351-616 handleFlagUpdates): window regeneration,
    frequency remap, slope map, decay pole design — all folded into one
    constructor since the result is immutable. Takes the JAX constant's
    design keywords; its TPU routing keywords stay behind.
    """
    transform_size = max(32, next_pow2(window_size))  # ref: TransformConstant.h:84

    # a zero dB range divides by log(upper/lower) = 0; the reference
    # enforces a small minimum (its CHANGELOG 0.4.0 fixes the zero-range
    # display glitch)
    if high_dbs - low_dbs < 0.1:
        high_dbs = low_dbs + 0.1

    kernel, scale = generate_window(
        window_type,
        window_size,
        symmetric=window_symmetric,
        alpha=window_alpha,
        beta=window_beta,
    )
    # ref: TransformDSP.inl:540 — normalization making a full-scale sine 0 dB.
    inv_size = scale / (window_size * 0.5)

    if mapped_frequencies is None:
        mapped_frequencies = remap_frequencies(
            axis_points,
            sample_rate,
            view_scaling,
            view_left=view_left,
            view_right=view_right,
            min_freq=min_freq,
            configuration=configuration,
        )
    mapped_frequencies = np.asarray(mapped_frequencies, dtype=np.float64)

    plan = build_remap_plan(
        mapped_frequencies,
        sample_rate,
        transform_size,
        bin_interpolation,
        full_circle=(configuration == SpectrumChannels.COMPLEX),
    )

    # ref: TransformConstant.h:109-118 — slopeMap[i] = b * f[i]^a.
    slope_map = slope_b * np.power(np.maximum(mapped_frequencies, 1e-30), slope_a)

    poles = [
        peak_decay_pole(decay_seconds[min(i, len(decay_seconds) - 1)], frames_per_second)
        for i in range(num_line_graphs)
    ]

    static = dict(
        axis_points=axis_points,
        window_size=window_size,
        transform_size=transform_size,
        configuration=configuration,
        bin_interpolation=bin_interpolation,
        view_scaling=view_scaling,
        algo=algo,
        display_mode=display_mode,
        sample_rate=sample_rate,
        num_line_graphs=num_line_graphs,
        interp_taps=plan.interp_indices.shape[1],
        n_spectrum_values=plan.n_values,
    )
    arrays = dict(
        window_kernel=kernel,
        inv_size=np.float64(inv_size),
        mapped_frequencies=mapped_frequencies,
        slope_map=slope_map,
        low_dbs=np.float64(low_dbs),
        high_dbs=np.float64(high_dbs),
        clip_db=np.float64(clip_db),
        decay_poles=np.asarray(poles, dtype=np.float64),
        interp_indices=plan.interp_indices,
        interp_weights=plan.interp_weights,
        interp_mask=plan.interp_mask,
        single_bin=plan.single_bin,
        single_mask=plan.single_mask,
        band_idx=plan.band_idx,
        band_mask=plan.band_mask,
    )
    return constant_from_arrays(static, arrays, device)
