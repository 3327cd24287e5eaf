"""The plain reference of the Spectrum's PHASE view, in any precision.

Frames ``[pairs, T, 2, W]`` -> both channels windowed -> radix-2 FFT -> the
half spectra with DC and Nyquist halved -> per pixel the mid magnitude and
the phase cancellation ``1 - |L + R| / (|L| + |R|)`` -> the mid row's peak
decay and the phase row's one-pole smoothing -> normalized dB (ref:
Signalizer v0.4.3 Source/Spectrum/SpectrumParameters.h, the Phase channel
configuration; TransformDSP.inl:671-850, the complex interpolation and the
first-maximum bin a chunk; :1395-1419, the smoothing with ``pole^0.3`` and
the mid row's ``consts::half`` at :1407). Written from that description with
plain torch operations on real tensors: a complex value is a ``(re, im)``
pair, so one code runs in float64 (the reference) and in bfloat16 (the
control; torch has no bfloat16 complex type), every operation rounded to
``dtype``. It imports nothing of the program.

Its design is the SEPARATE view's (:func:`phase_design`): the two modes
share the window, the bin-to-pixel plan, the poles and the dB map (only
COMPLEX changes the axis). The window, FFT, packing and dB map are
:mod:`portbench.reference.spectrum`'s.

Departures from the source:

* the precision: float64 or bfloat16, where the source computes in float32;
* a pixel whose denominator ``|L| + |R|`` is 0 (silence) takes a
  cancellation of 1; its mid is 0 there too, so the dB map clips both rows
  whatever the cancellation;
* the interpolated mid is the taps' weighted sum of ``|L|`` and ``|R|``
  with no ``|.|`` after it, where the magnitude modes rectify theirs: with
  the LANCZOS kernel's negative lobes it can come out negative, and the dB
  map clips it;
* the decay and the smoothing step once an analysis frame, as the batched
  program does; the source steps them once a display frame, which is the
  same at a hop of ``sample_rate / frames_per_second`` (800 at 48 kHz and
  60 fps).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference.plan import ViewDesign, design
from portbench.reference.spectrum import Tables, db_map, fft, pack

# the phase smoothing's pole is the line graph's decay pole to this power
# (ref: TransformDSP.inl:1395-1419)
PHASE_POLE_POWER = 0.3


def phase_design(view: dict) -> ViewDesign:
    """The PHASE view's design: the SEPARATE view's with the mode set to
    PHASE."""
    return dataclasses.replace(design({**view, "channels": "SEPARATE"}), mode="PHASE")


def half_spectra(tables: Tables, frames: torch.Tensor):
    """frames [..., 2, W] -> ``(re, im)`` of both channels' windowed half
    spectra [..., 2, N/2 + 1], DC and Nyquist halved (ref:
    TransformDSP.inl:551-554)."""
    rows = pack(tables, frames)  # both channels windowed, as SEPARATE packs them
    n = tables.design.transform_size
    pad = n - rows.shape[-1]
    re = torch.nn.functional.pad(rows, (0, pad)) if pad else rows
    re, im = fft(tables, re, torch.zeros_like(re))
    half = torch.ones(n // 2 + 1, dtype=re.dtype, device=re.device)
    half[0] = half[-1] = 0.5
    return re[..., : n // 2 + 1] * half, im[..., : n // 2 + 1] * half


def modulus(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(re * re + im * im)


def cancellation(lre, lim, rre, rim) -> torch.Tensor:
    """``1 - |L + R| / (|L| + |R|)``: 0 where the channels agree in phase,
    1 where they cancel; 1 where ``|L| + |R|`` is 0."""
    den = modulus(lre, lim) + modulus(rre, rim)
    num = modulus(lre + rre, lim + rim)
    return 1.0 - torch.where(den > 0, num / torch.where(den > 0, den, torch.ones_like(den)), 0.0)


def first_max_bin(tables: Tables, power: torch.Tensor) -> torch.Tensor:
    """Per pixel, the first bin of its chunk at which ``power`` [..., nv]
    reaches the chunk's maximum (ref: TransformDSP.inl:826-838, a
    strictly-greater update), or the pixel's single bin where its chunk is
    empty -> int64 [..., P]."""
    g = torch.where(tables.band_mask, power[..., tables.band_idx], -math.inf)  # [..., P, width]
    width = g.shape[-1]
    j = torch.arange(width, device=g.device)
    first = torch.where(g == g.amax(-1, keepdim=True), j, width).amin(-1)
    return torch.where(tables.single_mask, tables.single_bin, tables.band_idx[:, 0] + first)


def interpolate(tables: Tables, x: torch.Tensor) -> torch.Tensor:
    """The taps' weighted sum [..., nv] -> [..., P]."""
    return (x[..., tables.interp_idx] * tables.interp_w).sum(-1)


def phase_values(tables: Tables, frames: torch.Tensor):
    """frames [..., 2, W] -> ``(mid, cancel)`` [..., P]: below the plan's
    break the taps interpolate L and R as complex values (the cancellation)
    and their magnitudes (the mid); above it, at the first bin of each chunk
    where ``max(|L|, |R|)`` peaks, ``mid = |L| + |R|`` and the cancellation
    of L and R there. The mid carries ``inv_size`` (ref:
    TransformDSP.inl:671-850)."""
    re, im = half_spectra(tables, frames)
    mag = modulus(re, im)
    lre, lim, rre, rim = re[..., 0, :], im[..., 0, :], re[..., 1, :], im[..., 1, :]
    mid_i = interpolate(tables, mag[..., 0, :]) + interpolate(tables, mag[..., 1, :])
    cancel_i = cancellation(*(interpolate(tables, x) for x in (lre, lim, rre, rim)))
    b = first_max_bin(tables, torch.maximum(mag[..., 0, :], mag[..., 1, :]))
    at = lambda x: torch.gather(x, -1, b)  # noqa: E731
    mid_b = at(mag[..., 0, :]) + at(mag[..., 1, :])
    cancel_b = cancellation(at(lre), at(lim), at(rre), at(rim))
    mid = tables.inv_size * torch.where(tables.interp_mask, mid_i, mid_b)
    return mid, torch.where(tables.interp_mask, cancel_i, cancel_b)


class PhaseReference:
    """The whole PHASE display path with its carried states, from zero: the
    magnitude state ``[pairs, K, 2, P]`` (row 0 the mid's decayed peak,
    ``max(pole * state, mid / 2)``; row 1 is never written) and the phase
    state ``[pairs, K, P]``, smoothed toward ``cancel * mid / 2`` with
    ``pole^0.3`` (ref: TransformDSP.inl:1336-1341, :1395-1419)."""

    def __init__(self, d: ViewDesign, pairs: int, dtype: torch.dtype, device):
        self.tables = Tables(d, dtype, device)
        k, p = len(d.poles), len(d.slope)
        self.state = torch.zeros((pairs, k, 2, p), dtype=dtype, device=device)
        self.phase = torch.zeros((pairs, k, p), dtype=dtype, device=device)
        # designed in float64, then rounded to dtype
        self.phase_poles = torch.tensor(d.poles ** PHASE_POLE_POWER, dtype=dtype, device=device)[:, None]

    def process(self, frames: torch.Tensor, block: int = 16) -> torch.Tensor:
        """frames [pairs, T, 2, W] -> display values [pairs, T, K, 2, P],
        ``block`` frames at a time so that the float64 temporaries fit."""
        t = self.tables
        poles, pp = t.poles[:, None], self.phase_poles
        out = []
        for b in range(0, frames.shape[1], block):
            mid, cancel = phase_values(t, frames[:, b : b + block])  # [pairs, block, P]
            half = mid * 0.5  # ref: consts::half at TransformDSP.inl:1407
            for i in range(half.shape[1]):
                h = half[:, i, None]  # [pairs, 1, P]
                self.state[:, :, 0] = torch.maximum(poles * self.state[:, :, 0], h)
                self.phase = pp * self.phase + (1.0 - pp) * (cancel[:, i, None] * h)
                out.append(torch.stack([db_map(t, self.state[:, :, 0]), db_map(t, self.phase)], dim=-2))
        return torch.stack(out, dim=1)
