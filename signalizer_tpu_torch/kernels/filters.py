"""IIR filters: biquads, the 3-band Linkwitz-Riley crossover, one-pole
smoothers.

Counterpart of :mod:`signalizer_tpu.kernels.filters` (ref:
cpl/dsp/LinkwitzRileyNetwork.h, tuned at OscilloscopeDSP.inl:440; RBJ
cookbook biquads, LR4 = squared 2nd-order Butterworth), with the same
shapes and semantics, on tensors on any device.

A biquad in transposed direct form II is the 2-state linear recurrence
``s[n] = A s[n-1] + B x[n]``. The JAX package solves it with an associative
scan over 2×2 companion matrices; here it is a log-depth doubling scan over
the sample axis: round ``k`` adds ``A^d s[n-d]`` (``d = 2^k``) to every
``s[n]`` with ``n >= d``. ``A^d`` is one 2×2 matrix per round, squared on
the host in float64 from the float32 coefficients, and applied as four
elementwise products: no ``matmul``, so TF32 cannot reach the recurrence.
That matters: the 300 Hz crossover's poles sit near the unit circle, and
reduced-precision products push its matrix powers past it
(``signalizer_tpu/kernels/filters.py:_recurrence_scan``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from signalizer_tpu_torch.core.constant import resolve_device


class BiquadCoeffs(NamedTuple):
    """Normalized (a0 = 1) biquad coefficients."""

    b0: float
    b1: float
    b2: float
    a1: float
    a2: float


def butterworth_lowpass(fc: float, fs: float, q: float = math.sqrt(0.5)) -> BiquadCoeffs:
    """RBJ cookbook 2nd-order lowpass."""
    w0 = 2.0 * math.pi * fc / fs
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    a0 = 1.0 + alpha
    return BiquadCoeffs(
        b0=(1.0 - cw) / 2.0 / a0,
        b1=(1.0 - cw) / a0,
        b2=(1.0 - cw) / 2.0 / a0,
        a1=-2.0 * cw / a0,
        a2=(1.0 - alpha) / a0,
    )


def butterworth_highpass(fc: float, fs: float, q: float = math.sqrt(0.5)) -> BiquadCoeffs:
    """RBJ cookbook 2nd-order highpass."""
    w0 = 2.0 * math.pi * fc / fs
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    a0 = 1.0 + alpha
    return BiquadCoeffs(
        b0=(1.0 + cw) / 2.0 / a0,
        b1=-(1.0 + cw) / a0,
        b2=(1.0 + cw) / 2.0 / a0,
        a1=-2.0 * cw / a0,
        a2=(1.0 - alpha) / a0,
    )


def _shift(v: torch.Tensor, d: int) -> torch.Tensor:
    """v delayed by d samples along the last axis, zero-filled."""
    return torch.nn.functional.pad(v[..., :-d], (d, 0))


def _recurrence_scan(
    a: np.ndarray, u0: torch.Tensor, u1: torch.Tensor, s0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve s[n] = A s[n-1] + u[n] for every n, A a constant 2×2.

    ``u0``, ``u1`` [..., W] are the two components of u; ``s0`` [..., 2] the
    state before sample 0. Returns the two components of s[0..W-1].
    """
    w = u0.shape[-1]
    m = a.astype(np.float64)
    # fold the initial state into the first sample
    first0 = u0[..., :1] + (float(m[0, 0]) * s0[..., 0:1] + float(m[0, 1]) * s0[..., 1:2])
    first1 = u1[..., :1] + (float(m[1, 0]) * s0[..., 0:1] + float(m[1, 1]) * s0[..., 1:2])
    v0 = torch.cat([first0, u0[..., 1:]], dim=-1)
    v1 = torch.cat([first1, u1[..., 1:]], dim=-1)
    d = 1
    while d < w:
        p0, p1 = _shift(v0, d), _shift(v1, d)
        m00, m01, m10, m11 = (float(c) for c in m.ravel())
        v0, v1 = v0 + (m00 * p0 + m01 * p1), v1 + (m10 * p0 + m11 * p1)
        m = m @ m
        d *= 2
    return v0, v1


def biquad_filter(
    coeffs: BiquadCoeffs, x: torch.Tensor, zi: torch.Tensor = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a biquad along the last axis. x [..., W]; zi [..., 2] TDF2
    state. Returns (y [..., W], zf [..., 2])."""
    b0, b1, b2, a1, a2 = (float(c) for c in coeffs)
    f32 = np.float32
    # the companion matrix in the signal's precision, as the JAX code has it
    a = np.array([[-a1, 1.0], [-a2, 0.0]], f32)
    bv0, bv1 = float(f32(b1 - a1 * b0)), float(f32(b2 - a2 * b0))
    if zi is None:
        zi = torch.zeros(x.shape[:-1] + (2,), dtype=x.dtype, device=x.device)
    s_0, s_1 = _recurrence_scan(a, x * bv0, x * bv1, zi)
    s1_prev = torch.cat([zi[..., 0:1], s_0[..., :-1]], dim=-1)
    y = s1_prev + float(f32(b0)) * x
    return y, torch.stack([s_0[..., -1], s_1[..., -1]], dim=-1)


class CrossoverState(NamedTuple):
    """Per-section TDF2 states for the 3-band network: [..., sections, 2]."""

    z: torch.Tensor


def init_crossover_state(
    batch_shape: Tuple[int, ...] = (), dtype=torch.float32, device=None
) -> CrossoverState:
    """Zero states on ``device`` (``None``: the GPU, raising without one)."""
    device = resolve_device(device)
    return CrossoverState(z=torch.zeros(tuple(batch_shape) + (8, 2), dtype=dtype, device=device))


def three_band_split(
    x: torch.Tensor,
    fs: float,
    f_low: float = 300.0,
    f_high: float = 3000.0,
    state: CrossoverState = None,
) -> Tuple[torch.Tensor, CrossoverState]:
    """3-band Linkwitz-Riley split (ref: cpl LinkwitzRileyNetwork<T,3>,
    tuneCrossOver(300, 3000) at OscilloscopeDSP.inl:440).

    LR4 topology: each crossover is a squared Butterworth biquad. x [..., W]
    -> bands [..., 3, W] (low, mid, high) and the new state. CPU tensors take
    the eight doubling scans of :func:`biquad_filter`
    (:func:`signalizer_tpu_torch.kernels.colour_track.three_band_split_plain`);
    CUDA tensors launch kernel E's split entry
    (:mod:`signalizer_tpu_torch.kernels.colour_track`) or raise.
    """
    from signalizer_tpu_torch.kernels import colour_track  # it builds on this module

    return colour_track.three_band_split(x, fs, f_low, f_high, state)


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def onepole_block_update(state: torch.Tensor, u: torch.Tensor, pole, new_samples=None) -> torch.Tensor:
    """Final state of s' = u + p (s - u) over a length-W block, closed form.
    state [...], u [..., W]. ``new_samples`` (0..W) consumes only the
    trailing that many samples: identity for the rest."""
    w = u.shape[-1]
    i = torch.arange(w, dtype=u.dtype, device=u.device)
    pole = _as_tensor(pole, u)
    ramp = torch.pow(pole[..., None], (w - 1) - i)
    if new_samples is None:
        decay = torch.pow(pole, float(w))
        acc = torch.sum(u * ramp, dim=-1)
    else:
        n = _as_tensor(new_samples, u)
        decay = torch.pow(pole, n)
        acc = torch.sum(torch.where(i >= w - n, u * ramp, 0.0), dim=-1)
    return decay * state + acc * (1.0 - pole)


def onepole_smooth(x: torch.Tensor, pole, s0: torch.Tensor = None) -> torch.Tensor:
    """Per-sample one-pole smoother s[n] = x[n] + p (s[n-1] - x[n]) along
    the last axis, by the same doubling scan as the biquads (the pole's
    powers squared in the signal's precision, as the JAX scan forms them).
    Returns the full sequence."""
    pole = _as_tensor(pole, x)
    v = x * (1.0 - pole)
    if s0 is not None:
        v = torch.cat([v[..., :1] + pole * s0[..., None], v[..., 1:]], dim=-1)
    w = x.shape[-1]
    pd = pole
    d = 1
    while d < w:
        v = v + pd * _shift(v, d)
        pd = pd * pd
        d *= 2
    return v
