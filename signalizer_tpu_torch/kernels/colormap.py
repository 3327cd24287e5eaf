"""Spectrogram colour mapping and multi-pair blending.

Counterpart of :mod:`signalizer_tpu.kernels.colormap` (ref:
Source/Spectrum/SpectrumDSP.cpp:110-206 blendAndDispatchSpectrums), in plain
PyTorch on the tensors' device:

* the per-pixel gradient-segment walk is a ``searchsorted`` over the
  segment boundaries, and the two stops of a pixel's segment are read from
  the 6-entry table by index;
* the sequential per-pair blend ``acc += (1 - acc) * src``
  (GL_ONE_MINUS_SRC_COLOR accumulation) telescopes to the closed form
  ``1 - prod_i(1 - src_i)`` — one product over the pair axis instead of an
  ordered loop (the recurrence is symmetric in its inputs).

:func:`spectrogram_columns`, the whole column pipeline, launches one kernel
on a GPU, ``csrc/colormap.cu`` (no TPU kernel's port: the JAX package maps
with plain ``jnp``); :func:`spectrogram_columns_plain` is its plain version,
the three functions above in turn, which the CPU runs and the kernel is held
to.
"""

from __future__ import annotations

import numpy as np
import torch

from signalizer_tpu_torch.kernels import _build
from signalizer_tpu_torch.utils.diagnostics import count, span

NUM_SPECTRUM_COLOURS = 5  # ref: SpectrumParameters.h:77
# the gradient stops the kernel holds (csrc/colormap.cu kMaxStops); the
# program's gradients have NUM_SPECTRUM_COLOURS + 1
MAX_STOPS = 16
# kernel launches count in the diagnostics registry as colormap.launches


def normalize_ratios(ratios) -> np.ndarray:
    """Normalize gradient segment widths to sum to 1 (the reference's
    normalizedSpecRatios; first entry is the background stop at 0)."""
    r = np.asarray(ratios, np.float64)
    total = r[1:].sum()
    out = np.zeros(len(r))
    out[1:] = r[1:] / (total if total > 0 else 1.0)
    return out


def gradient_bounds(ratios: torch.Tensor) -> torch.Tensor:
    """Segment boundaries: the running sum of the ratios, added one by one
    in order in the ratios' precision (``bounds[0] == 0``)."""
    bounds = ratios.clone()
    for i in range(1, ratios.shape[0]):
        bounds[i] = bounds[i - 1] + ratios[i]
    return bounds


def gradient_map(
    intensity: torch.Tensor, colours: torch.Tensor, ratios: torch.Tensor, bounds: torch.Tensor = None
) -> torch.Tensor:
    """Map normalized intensities through a piecewise-linear colour gradient
    (ref: renderSf, SpectrumDSP.cpp:119-169).

    intensity [..., P] in display space (values < 0 map to black — callers
    typically feed the dB-mapped results where below-range pixels are
    negative); colours [6, 3] gradient stops (stop 0 = background), or
    [B, 6, 3], one table for each of the intensity's leading B; ratios [6]
    normalized segment widths (ratios[0] ignored); ``bounds``: the ratios'
    :func:`gradient_bounds`, for a caller that keeps them. Returns rgb
    [..., P, 3].
    """
    if colours.ndim not in (2, 3):
        raise ValueError("gradient_map takes one [stops, 3] table or a batch [B, stops, 3]")
    if bounds is None:
        bounds = gradient_bounds(ratios)  # [6]; bounds[0] == 0
    x = torch.clamp(intensity, 0.0, 1.0)
    # segment c such that bounds[c-1] < x <= bounds[c]
    seg = torch.searchsorted(bounds, x.contiguous(), right=False)
    seg = torch.clamp(seg, 1, ratios.shape[0] - 1)
    lo = bounds[seg - 1]
    hi = bounds[seg]
    mix = torch.where(hi > lo, (x - lo) / torch.clamp(hi - lo, min=1e-20), 1.0)
    if colours.ndim == 2:
        c_lo, c_hi, last = colours[seg - 1], colours[seg], colours[-1]
    else:
        if intensity.ndim < 2 or intensity.shape[0] != colours.shape[0]:
            raise ValueError("a batch of colour tables needs intensity [B, ..., P]")
        flat = seg.reshape(seg.shape[0], -1)  # [B, n]
        rows = torch.arange(flat.shape[0], device=seg.device)[:, None]
        c_lo = colours[rows, flat - 1].reshape(seg.shape + (3,))
        c_hi = colours[rows, flat].reshape(seg.shape + (3,))
        last = colours[:, -1].reshape((colours.shape[0],) + (1,) * (seg.ndim - 1) + (3,))
    rgb = c_lo * (1.0 - mix[..., None]) + c_hi * mix[..., None]
    # full-scale pixels take the last stop exactly (ref: :157-160)
    rgb = torch.where((x >= 0.999)[..., None], last, rgb)
    # negative intensities contribute NOTHING to the accumulation
    # (ref: SpectrumDSP.cpp:124-125 `if (intensity < 0) continue;` over a
    # zero-initialized buffer) — black, not the background stop, so a
    # silent pair never tints the multi-pair ONE_MINUS_SRC_COLOR blend
    return torch.where((intensity < 0)[..., None], 0.0, rgb)


def blend_pairs(rgb: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Accumulate per-pair colours with GL_ONE_MINUS_SRC_COLOR semantics
    (ref: SpectrumDSP.cpp:162-167): closed form 1 - prod(1 - src)."""
    return 1.0 - torch.prod(1.0 - rgb, dim=axis)


def quantize_rgba8(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] float -> [..., 4] uint8 with opaque alpha
    (ref: SpectrumDSP.cpp:191-198). Truncates, as the reference does."""
    q = (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
    alpha = torch.full(q.shape[:-1] + (1,), 255, dtype=torch.uint8, device=q.device)
    return torch.cat([q, alpha], dim=-1)


def spectrogram_columns_plain(
    intensity: torch.Tensor, colours: torch.Tensor, ratios: torch.Tensor, bounds: torch.Tensor = None
) -> torch.Tensor:
    """Plain PyTorch version of :func:`spectrogram_columns`: the gradient
    map, the pair blend and the quantize, one torch operation at a time."""
    rgb = gradient_map(intensity, colours, ratios, bounds)  # [pairs, T, P, 3]
    return quantize_rgba8(blend_pairs(rgb, axis=0))


def spectrogram_columns(
    intensity: torch.Tensor, colours: torch.Tensor, ratios: torch.Tensor, bounds: torch.Tensor = None
) -> torch.Tensor:
    """Full column pipeline: intensities [pairs, T, P] + per-pair colour
    tables [pairs, S, 3] (or one [S, 3] table) -> RGBA8 columns [T, P, 4]
    (pairs blended). CPU tensors take :func:`spectrogram_columns_plain`;
    CUDA tensors launch ``sig_colormap`` of ``csrc/colormap.cu`` once,
    reading the intensities at their strides in place, or raise: float32
    only, 2 to :data:`MAX_STOPS` stops."""
    with span("colormap"):
        if intensity.device.type == "cpu":
            return spectrogram_columns_plain(intensity, colours, ratios, bounds)
        dev = intensity.device
        if dev.type != "cuda":
            raise ValueError(f"spectrogram_columns: intensities on {dev}")
        stops = ratios.shape[0] if ratios.ndim == 1 else -1
        if not 2 <= stops <= MAX_STOPS:
            raise ValueError(f"spectrogram_columns: the kernel takes 2 to {MAX_STOPS} stops, got ratios "
                             f"{tuple(ratios.shape)}")
        if intensity.dtype != torch.float32 or intensity.ndim != 3:
            raise ValueError(f"spectrogram_columns: intensities must be float32 [pairs, T, P], got "
                             f"{intensity.dtype} {tuple(intensity.shape)}")
        pairs, t, p = intensity.shape
        if colours.shape not in ((stops, 3), (pairs, stops, 3)) or colours.dtype != torch.float32:
            raise ValueError(f"spectrogram_columns: colours must be float32 [{stops}, 3] or [{pairs}, {stops}, 3], "
                             f"got {colours.dtype} {tuple(colours.shape)}")
        if bounds is None:
            bounds = gradient_bounds(ratios)
        if bounds.dtype != torch.float32 or tuple(bounds.shape) != (stops,):
            raise ValueError(f"spectrogram_columns: bounds must be float32 [{stops}], got "
                             f"{bounds.dtype} {tuple(bounds.shape)}")
        if colours.device != dev or bounds.device != dev:
            raise ValueError(f"spectrogram_columns: intensities on {dev}, colours on {colours.device}, "
                             f"bounds on {bounds.device}")
        out = torch.empty((t, p, 4), dtype=torch.uint8, device=dev)
        if out.numel() == 0:
            return out
        colours, bounds = colours.contiguous(), bounds.contiguous()
        _build.launch(
            "sig_colormap", dev, intensity.data_ptr(), *intensity.stride(), colours.data_ptr(),
            pairs if colours.ndim == 3 else 1, bounds.data_ptr(), out.data_ptr(), pairs, t, p, stops, name="colormap",
        )
        count("colormap.launches")
        return out
