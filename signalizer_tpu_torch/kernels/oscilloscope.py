"""Oscilloscope kernels: triggers, spectral fundamental, resampling.

Counterpart of :mod:`signalizer_tpu.kernels.oscilloscope` (ref:
Source/Oscilloscope/OscilloscopeDSP.inl:61-308 spectral trigger,
StreamPreprocessing.h:270-349 peak-hold / zero-crossing processors,
OscilloscopeRendering.cpp:790-891 windowed-sinc pixel resampling), with the
same shapes and semantics, on tensors on any device.

* Every Lanczos, linear and nearest resample goes to kernel C
  (:mod:`signalizer_tpu_torch.kernels.banded_resample`): its CUDA kernel
  for a CUDA tensor, its plain per-tap version for a CPU one. Positions
  shared by a pair's rows are formed inside the kernel from the pair's
  start and step; any other broadcast hands it a position tensor. The JAX
  package's TPU routing (the ``covers`` check, the XLA band widths) has no
  counterpart.
* The zero-crossing trigger finds each crossing's segment end and the next
  hot sample with reversed running minima (exact booleans).
* The envelope-hold trigger is kernel D
  (:mod:`signalizer_tpu_torch.kernels.peak_hold`): its CUDA scan for a
  CUDA tensor, its plain loop over the consumed samples for a CPU one.
* The colour track is kernel E
  (:mod:`signalizer_tpu_torch.kernels.colour_track`): its CUDA chunked scans
  for a CUDA tensor, its plain doubling scans for a CPU one.
* The spectral fundamental walk is kernel F
  (:mod:`signalizer_tpu_torch.kernels.spectral_walk`): on a CUDA tensor its
  CUDA walk reads the rfft itself (one launch after the rfft, no host
  sync); on a CPU one its plain version, the magnitudes and offsets by
  torch operations and the loop from acceptance to acceptance.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from signalizer_tpu_torch.core.constant import resolve_device
from signalizer_tpu_torch.kernels.banded_resample import (
    affine_positions,
    banded_resample,
    banded_resample_affine,
)
from signalizer_tpu_torch.kernels import colour_track
from signalizer_tpu_torch.kernels.peak_hold import peak_hold_triggers  # noqa: F401 — the views import it here
from signalizer_tpu_torch.kernels.spectral_walk import (  # noqa: F401 — the views and tests import them here
    MAX_WALK_ITERATIONS,
    MEDIAN_FILTER_SIZE,
    BinRecord,
    _quad_delta,
    median_record_filter,
    spectral_walk_spectrum,
)

LOOKAHEAD_SIZE = 8192  # ref: OscilloscopeParameters.h:46
INTERPOLATION_KERNEL_SIZE = 10  # ref: OscilloscopeParameters.h:47

# passes of the last spectral_fundamental call on CPU tensors (the plain
# loop's iterations); on CUDA tensors the passes stay on the device
# (spectral_walk.last_passes)
walk_iterations = 0


# ---------------------------------------------------------------------------
# triggers
# ---------------------------------------------------------------------------


def _reverse_cummin(v: torch.Tensor) -> torch.Tensor:
    """Running minimum from the end of the last axis."""
    return torch.flip(torch.cummin(torch.flip(v, [-1]), dim=-1).values, [-1])


def zero_crossing_triggers(x: torch.Tensor, threshold) -> torch.Tensor:
    """Rising-zero-crossing trigger events (ref: ZeroCrossingProcessor,
    StreamPreprocessing.h:315-349).

    x [..., W] -> bool [..., W]: True at each crossing origin that fires (a
    sample of its segment [origin, next origin) exceeds ``threshold``).
    Sample 0 can never be a crossing.
    """
    w = x.shape[-1]
    crossing = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    crossing[..., 1:] = (x[..., 1:] > 0) & (x[..., :-1] < 0)
    hot = x > threshold
    idx = torch.arange(w, device=x.device).expand(x.shape)
    big = torch.full_like(idx, w)
    next_hot = _reverse_cummin(torch.where(hot, idx, big))  # first hot at or after i
    next_cross = _reverse_cummin(torch.where(crossing, idx, big))  # first crossing at or after i
    seg_end = torch.cat([next_cross[..., 1:], big[..., :1]], dim=-1)  # first crossing after i
    return crossing & (next_hot < seg_end)


def last_zero_crossing_trigger(x: torch.Tensor, threshold) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index of the most recent firing crossing in the frame, and whether
    one exists. x [..., W] -> (int32 [...], bool [...])."""
    fires = zero_crossing_triggers(x, threshold)
    idx = torch.arange(x.shape[-1], dtype=torch.int32, device=x.device)
    last = torch.amax(torch.where(fires, idx, -1), dim=-1)
    return torch.clamp(last, min=0), last >= 0


# ---------------------------------------------------------------------------
# spectral trigger
# ---------------------------------------------------------------------------


def spectral_bins(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bins entries' inputs: the rfft's magnitudes and quadratic peak
    offsets of x [..., N], each [..., N/2 + 1] (the spectrum entries form
    them from the rfft inside kernel F)."""
    spec = torch.fft.rfft(x, dim=-1)
    return spec.abs(), _quad_delta(spec)


def spectral_fundamental(
    x: torch.Tensor,
    sample_rate: float,
    *,
    threshold=0.0,
    hysteresis=0.0,
) -> Tuple[torch.Tensor, torch.Tensor, BinRecord]:
    """Estimate the dominant fundamental of a lookahead buffer
    (ref: calculateFundamentalPeriod, OscilloscopeDSP.inl:80-225).

    x [..., N] real. Returns (fundamental_hz [...], cycle_samples [...],
    BinRecord). The candidate walk on the rfft is
    :func:`~signalizer_tpu_torch.kernels.spectral_walk.spectral_walk_spectrum`
    (kernel F on CUDA tensors, which forms the magnitudes and offsets).
    """
    global walk_iterations
    n = x.shape[-1]
    record, passes = spectral_walk_spectrum(torch.fft.rfft(x, dim=-1), n, threshold, hysteresis)
    if passes.device.type == "cpu":
        walk_iterations = int(passes.max()) if passes.numel() else 1
    fundamental = sample_rate * record.omega() / n
    fundamental = torch.clamp(fundamental, min=5.0)  # ref: :221 floor at 5 Hz
    cycle_samples = sample_rate / fundamental
    return fundamental, cycle_samples, record


def goertzel(x: torch.Tensor, radians: torch.Tensor) -> torch.Tensor:
    """Single-frequency DFT correlate: sum x[n] e^{-i r n}
    (ref: cpl dsp::goertzel usage at OscilloscopeDSP.inl:277). The phases
    are formed in f32 and only then made complex64, as the JAX code forms
    them."""
    n = x.shape[-1]
    k = torch.arange(n, dtype=x.dtype, device=x.device)
    phases = radians[..., None] * k
    return torch.sum(x * torch.exp(-1j * phases.to(torch.complex64)), dim=-1)


def trigger_phase_offset(
    lookahead: torch.Tensor,
    omega: torch.Tensor,
    cycle_samples: torch.Tensor,
    effective_window,
    sample_rate: float,
    fundamental: torch.Tensor,
    bin_offset: torch.Tensor,
    phase_offset_degrees=0.0,
) -> torch.Tensor:
    """Phase-lock sample offset via Goertzel + DFT shift theorem
    (ref: calculateTriggeringOffset, OscilloscopeDSP.inl:230-308), anchored
    at exactly -N like the JAX code (its docstring has the derivation).

    lookahead [..., N]: the most recent N samples (newest last). Returns
    the fractional sample offset that phase-locks the waveform on screen.
    """
    n = lookahead.shape[-1]
    tau = 2.0 * math.pi
    radians = tau * omega / n
    sample_difference = float(n) - (effective_window + cycle_samples)

    z = goertzel(lookahead, radians)
    rotation = -sample_difference * radians
    z = z * torch.exp(-1j * rotation.to(torch.complex64))

    phase = tau - torch.angle(z)
    phase = phase + bin_offset * tau
    phase = phase - tau / 4.0
    phase = phase + tau * phase_offset_degrees / 360.0
    phase = torch.remainder(torch.remainder(phase, tau) + tau, tau)
    cycles = phase / tau
    return cycles * sample_rate / fundamental - 1.0


# ---------------------------------------------------------------------------
# display resampling
# ---------------------------------------------------------------------------


def _resample(
    x: torch.Tensor, start, step, num_out: int, lo: float, hi: float,
    a: int, kind: str, with_nearest: bool = False,
):
    """Resample x [..., W] at ``clip(start[..., None] + p * step[..., None],
    lo, hi)``, p = 0..num_out-1, through kernel C -> [..., num_out].

    A tensor ``start [..., 1]`` (with a host ``step``, or a tensor
    ``step [..., 1]``) does not vary along x's last batch axis: that axis is
    kernel C's R, the axes before it its B, and the kernel forms the
    positions itself (the oscilloscope step's case: rows [pairs, rows, H],
    start [pairs, 1]). Any other broadcast builds the position tensor and
    takes the kernel's ``pos`` entry, every batch row its own pair (R = 1).
    """
    w = x.shape[-1]

    def per_pair(v):
        return isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[-1] == 1 and v.ndim < x.ndim

    if per_pair(start) and (per_pair(step) or not isinstance(step, torch.Tensor)):
        rows = x.shape[-2]
        outer = torch.broadcast_shapes(
            x.shape[:-2], start.shape[:-1], step.shape[:-1] if per_pair(step) else ()
        )

        def flat(v):
            return v.to(torch.float32).expand(outer + (1,)).reshape(-1).contiguous()

        res = banded_resample_affine(
            x.expand(outer + (rows, w)).reshape((-1, rows, w)).contiguous(),
            flat(start), flat(step) if per_pair(step) else step, num_out, lo, hi,
            a=a, kind=kind, with_nearest=with_nearest,
        )
        shape = outer + (rows, num_out)
    else:
        pos = affine_positions(x, start, step, num_out, lo, hi)
        lead = torch.broadcast_shapes(x.shape[:-1], pos.shape[:-1])
        res = banded_resample(
            x.expand(lead + (w,)).reshape((-1, 1, w)).contiguous(),
            pos.expand(lead + (num_out,)).reshape((-1, num_out)).contiguous(),
            a=a, kind=kind, with_nearest=with_nearest,
        )
        shape = lead + (num_out,)
    if with_nearest:
        return res[0].reshape(shape), res[1].reshape(shape)
    return res.reshape(shape)


def sinc_resample(
    x: torch.Tensor,
    start,
    step,
    num_out: int,
    kernel_size: int = INTERPOLATION_KERNEL_SIZE,
) -> torch.Tensor:
    """Windowed-sinc (Lanczos) fractional resampling to pixel space
    (ref: drawWavePlot Lanczos path, OscilloscopeRendering.cpp:854-888).

    x [..., W]; output pixel p samples position start + p*step, clipped to
    a kernel radius outside the frame. Edge taps clamp. Returns [..., num_out].
    """
    a = kernel_size
    w = x.shape[-1]
    return _resample(x, start, step, num_out, -(a + 1.0), w - 1.0 + a, a, "lanczos")


def sinc_resample_with_nearest(
    x: torch.Tensor,
    start,
    step,
    num_out: int,
    kernel_size: int = INTERPOLATION_KERNEL_SIZE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lanczos wave + nearest-sample pick at the SAME pixel positions, in
    one kernel-C pass (the oscilloscope step's envelope source when
    ``env_os == 1``). Positions are clipped to the Lanczos range, as the
    JAX fused call clips them."""
    a = kernel_size
    w = x.shape[-1]
    return _resample(x, start, step, num_out, -(a + 1.0), w - 1.0 + a, a, "lanczos", with_nearest=True)


def linear_resample(x: torch.Tensor, start, step, num_out: int) -> torch.Tensor:
    """2-tap linear variant (ref: SubSampleInterpolation::Linear path)."""
    return _resample(x, start, step, num_out, -2.0, x.shape[-1] * 1.0, 1, "linear")


def nearest_resample(x: torch.Tensor, start, step, num_out: int) -> torch.Tensor:
    """Nearest-sample pick (ref: SubSampleInterpolation::None /
    Rectangular); exact .5 ties resolve upward (floor(pos + 0.5))."""
    return _resample(x, start, step, num_out, -1.0, x.shape[-1] * 1.0, 1, "nearest")


def minmax_decimate(x: torch.Tensor, num_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-max peak decimation: x [..., W] -> (mins, maxs) each
    [..., num_out], pixel p reducing samples [p*W/P, (p+1)*W/P); a W that
    num_out does not divide is edge-padded to the next multiple."""
    w = x.shape[-1]
    k = -(-w // num_out)
    pad = k * num_out - w
    if pad:
        x = torch.cat([x, x[..., -1:].expand(x.shape[:-1] + (pad,))], dim=-1)
    r = x.reshape(x.shape[:-1] + (num_out, k))
    return r.amin(-1), r.amax(-1)


# ---------------------------------------------------------------------------
# spectral colouring
# ---------------------------------------------------------------------------


def spectral_colour_track(
    bands: torch.Tensor,
    smooth_pole,
    band_colours: torch.Tensor,
    key_colour: torch.Tensor,
    blend,
    smooth_state: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample 3-band energy colouring (ref: OscilloscopeDSP.inl:460-494
    filterStates/accumulateColour).

    bands [..., 3, W]; band_colours [3, 3] rgb rows for low/mid/high;
    key_colour [..., 3]; blend in [0, 1]. Per sample: smoothed band energy,
    rgb = sum_b s[b] * colour[b] (three products and sums, no matmul, so no
    TF32), normalized so max(r, g, b) = 1, then lerped toward the key
    colour. Returns (colours [..., W, 3], final smooth state [..., 3]).
    CPU tensors take the plain version
    (:func:`signalizer_tpu_torch.kernels.colour_track.spectral_colour_track_plain`);
    CUDA tensors launch kernel E (:mod:`signalizer_tpu_torch.kernels.colour_track`)
    or raise, the colours then a view of its channel-major output.
    """
    return colour_track.spectral_colour_track(bands, smooth_pole, band_colours, key_colour, blend, smooth_state)


def sinc_resample_matrix(
    window: int,
    start: float,
    step: float,
    num_out: int,
    kernel_size: int = INTERPOLATION_KERNEL_SIZE,
    device=None,
) -> torch.Tensor:
    """The resample for *static* positions as a dense [window, num_out]
    f32 matrix, built on the host once per configuration and uploaded to
    ``device`` (``None``: the GPU, raising without one)."""
    a = kernel_size
    pos = start + np.arange(num_out) * step
    i0 = np.floor(pos)
    offs = np.arange(-a + 1, a + 1)
    taps = i0[:, None] + offs[None, :]
    t = pos[:, None] - taps
    wts = np.sinc(t) * np.sinc(t / a)
    wts = np.where(np.abs(t) < a, wts, 0.0)
    idx = np.clip(taps.astype(np.int64), 0, window - 1)
    mat = np.zeros((window, num_out), np.float32)
    for p in range(num_out):
        for k in range(2 * a):
            mat[idx[p, k], p] += wts[p, k]
    return torch.from_numpy(mat).to(resolve_device(device))


def sinc_resample_static(x: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Apply a precomputed resample matrix: x [..., W] @ [W, P] -> [..., P].
    The leading axes fold into one, so the product is a single 2-D
    ``torch.mm`` (a batched product of a strided view runs as one-row
    products on a GPU). Full f32 needs torch's default matmul precision
    there (``torch.backends.cuda.matmul.allow_tf32`` False)."""
    w, p = matrix.shape
    return torch.mm(x.reshape(-1, w), matrix).reshape(x.shape[:-1] + (p,))
