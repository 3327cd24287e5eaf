"""Vectorscope functions: Lissajous/polar transforms, correlation, meters.

Counterpart of :mod:`signalizer_tpu.kernels.vectorscope` (ref:
Source/Vectorscope/Vectorscope.cpp:268-377 audioProcessing,
VectorscopeRendering.cpp:444-497 drawRectPlot, :500-746 drawPolarPlot,
:748-822 drawStereoMeters, :825-889 runPeakFilter), with the same shapes and
semantics, in plain PyTorch on the tensors' device:

* the per-sample loops are batched maps over ``[..., 2, samples]`` frames;
* the one-pole meter filters (envelope, dual-speed balance and phase
  smoothing) are not scanned per sample: over a block the final state of a
  one-pole filter is ``s' = p^W s0 + (1-p) * sum_i p^(W-1-i) u[i]``, one
  weighted sum with a power ramp
  (:func:`~signalizer_tpu_torch.kernels.filters.onepole_block_update`). The
  reference only reads the filter state once per block, so per-sample
  outputs are unobservable.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from signalizer_tpu_torch.core.constant import resolve_device
from signalizer_tpu_torch.kernels.filters import onepole_block_update

SQRT_HALF = 0.7071067811865476  # sqrt(2)/2


class VectorscopeMeterState(NamedTuple):
    """Filter states (ref: Vectorscope.h FilterStates / filters member).

    Axis convention: speed 0 = quick (pole = stereo_pole), speed 1 = slow
    (pole = stereo_pole ** 0.25, ref: Vectorscope.cpp:281
    secondStereoFilterSpeed = 0.25)."""

    envelope: torch.Tensor  # [..., 2] smoothed L^2 / R^2
    balance: torch.Tensor  # [..., 2(speed), 2(ch)] smoothed L^2 / R^2
    phase: torch.Tensor  # [..., 2(speed)] smoothed correlation
    # [...] last NORMAL raw autogain: the reference only overwrites
    # envelopeGain when the fresh 1/max(sqrt(env)) isnormal()
    # (Vectorscope.cpp:362-366, VectorscopeRendering.cpp:884-888), so on
    # silence/reset the previous gain persists instead of popping to 1
    gain: torch.Tensor


def init_meter_state(batch_shape: Tuple[int, ...] = (), device=None) -> VectorscopeMeterState:
    """Zeroed filters and unit gain on ``device`` (``None``: the GPU,
    raising without one)."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return VectorscopeMeterState(
        envelope=torch.zeros(batch_shape + (2,), **f32),
        balance=torch.zeros(batch_shape + (2, 2), **f32),
        phase=torch.zeros(batch_shape + (2,), **f32),
        gain=torch.ones(batch_shape, **f32),
    )


def meter_state_from_arrays(envelope, balance, phase, gain, device=None) -> VectorscopeMeterState:
    """A :class:`VectorscopeMeterState` from carried state given as arrays
    (e.g. a JAX state read with ``np.asarray``), copied to ``device``
    (``None``: the GPU, raising without one)."""
    device = resolve_device(device)
    return VectorscopeMeterState(
        *(torch.tensor(a, dtype=torch.float32, device=device) for a in (envelope, balance, phase, gain))
    )


def filter_coefficient(window_normalized, sample_rate) -> float:
    """One-pole coefficient from the normalized window parameter
    (ref: Vectorscope.cpp:201-202: exp(-1 / (norm * fs))). Host scalar."""
    return math.exp(-1.0 / (window_normalized * sample_rate))


# ---------------------------------------------------------------------------
# per-sample transforms
# ---------------------------------------------------------------------------


def correlation(frames: torch.Tensor) -> torch.Tensor:
    """Per-sample stereo correlation in [-1, 1]
    (ref: Vectorscope.cpp:297-317).

    Rotates (L, R) by 135 degrees, takes the phase angle, and returns
    ``cos(2*angle)`` (continuous across the +-pi seam). Silent samples
    (L == R == 0) read 0 (the reference substitutes a pi/4 dummy angle).
    frames [..., 2, W] -> [..., W].
    """
    left = frames[..., 0, :]
    right = frames[..., 1, :]
    x = -SQRT_HALF * (left + right)
    y = SQRT_HALF * (right - left)
    both_zero = (x == 0) & (y == 0)
    angle = torch.atan(y / torch.where(both_zero, 1.0, x))
    angle = torch.where(both_zero, math.pi / 4, angle)
    return torch.cos(2.0 * angle)


def _fade(frames: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Age ramp -1 (oldest) .. 0 (newest) over the sample axis."""
    fade = torch.linspace(-1.0, 0.0, frames.shape[-1], dtype=frames.dtype, device=frames.device)
    return fade.expand(like.shape)


def lissajous_vertices(frames: torch.Tensor, *, rotation: float = 0.0, gain=1.0) -> torch.Tensor:
    """Lissajous point cloud: frames [..., 2, W] -> vertices [..., W, 3].

    x = right, y = left (ref: drawRectPlot addVertex(right, left, z),
    VectorscopeRendering.cpp:466), z ramps -1 (oldest) .. 0 (newest) for age
    fading. Rotation (turns, a host float) and gain are folded in (the
    reference applies them on the GL matrix stack, :448-452); the rotation's
    sine and cosine are rounded to the frames' precision first, as a
    float32 device scalar would be."""
    left = frames[..., 0, :]
    right = frames[..., 1, :]
    x, y = right, left
    th = torch.tensor(2.0 * math.pi, dtype=frames.dtype) * torch.tensor(rotation, dtype=frames.dtype)
    c, s = float(torch.cos(th)), float(torch.sin(th))
    x, y = c * x - s * y, s * x + c * y
    return torch.stack([gain * x, gain * y, _fade(frames, x)], dim=-1)


def polar_vertices(frames: torch.Tensor, *, gain=1.0, scale_to_fill: bool = False) -> torch.Tensor:
    """Polar ("half-moon") point cloud: frames [..., 2, W] -> [..., W, 3]
    (ref: drawPolarPlot, VectorscopeRendering.cpp:563-604).

    length = max(|L|, |R|) (unit square -> triangle hypotenuse), the stereo
    field is rotated to center on the Y axis, and the angle folds both half
    circles upward; (x, y) = (sin, cos)(angle) * length."""
    left = frames[..., 0, :]
    right = frames[..., 1, :]
    length = torch.maximum(left.abs(), right.abs())
    vy = -SQRT_HALF * (left + right)
    vx = SQRT_HALF * (left - right)
    both_zero = (left == 0) & (right == 0)
    angle = torch.atan(vx / torch.where(vy == 0, torch.finfo(frames.dtype).tiny, vy))
    angle = torch.where(both_zero, 0.0, angle)
    x = torch.sin(angle) * length
    y = torch.cos(angle) * length
    x = x * gain
    y = y * gain
    if scale_to_fill:
        # stretch the [0, 1] half-circle to fill [-1, 1] vertically
        # (ref: Conditional01To11HeightTransform / scalePolarModeToFill)
        y = y * 2.0 - 1.0
    return torch.stack([x, y, _fade(frames, x)], dim=-1)


# ---------------------------------------------------------------------------
# meter filters (block-closed-form one-pole updates)
# ---------------------------------------------------------------------------


def update_meters(
    state: VectorscopeMeterState,
    frames: torch.Tensor,
    *,
    envelope_pole,
    stereo_pole,
    second_speed: float = 0.25,
    new_samples=None,
) -> VectorscopeMeterState:
    """Advance all meter filters over a frame block
    (ref: Vectorscope.cpp:319-342). frames [..., 2, W].

    The reference advances these in the audio callback — each sample seen
    exactly once. A caller re-reading an overlapping history window per
    render tick must pass ``new_samples`` so only the trailing new samples
    integrate; otherwise the meter ballistics scale with tick rate x window
    size instead of audio time. The poles are host floats or tensors; the
    slow pole ``stereo_pole ** second_speed`` is taken in the frames'
    precision on their device."""
    kw = dict(dtype=frames.dtype, device=frames.device)
    envelope_pole = torch.as_tensor(envelope_pole, **kw)
    stereo_pole = torch.as_tensor(stereo_pole, **kw)
    sq = frames[..., :2, :] ** 2  # [..., 2, W]
    corr = correlation(frames)  # [..., W]

    lead = state.phase.shape[:-1]
    poles2 = torch.stack(
        [stereo_pole.expand(lead), torch.pow(stereo_pole, second_speed).expand(lead)], dim=-1
    )  # [..., 2]

    env = onepole_block_update(
        state.envelope, sq, envelope_pole.expand(state.envelope.shape), new_samples
    )
    balance = onepole_block_update(
        state.balance, sq[..., None, :, :], poles2[..., :, None], new_samples
    )
    phase = onepole_block_update(state.phase, corr[..., None, :], poles2, new_samples)
    return VectorscopeMeterState(envelope=env, balance=balance, phase=phase, gain=state.gain)


def meter_readout(state: VectorscopeMeterState):
    """Meter bar positions in [0, 1] (ref: drawStereoMeters,
    VectorscopeRendering.cpp:766-775): balance = atan(balR/balL)/(pi/2)
    (0.5 fallback when degenerate), correlation = phase * 0.5 + 0.5.

    Returns dict with 'balance' [..., 2(speed)] and 'correlation'
    [..., 2(speed)]."""
    bal_l = state.balance[..., 0]
    bal_r = state.balance[..., 1]
    # atan(R/L)/(pi/2); L == 0 with R > 0 is a hard-right +inf ratio -> 1.0
    # (the reference relies on IEEE atan(+inf) = pi/2); only 0/0 is
    # degenerate and falls back to center. An exactly-zero result also
    # snaps to center: the reference guards with !std::isnormal, and 0.0
    # is not a normal float — so a mathematically hard-left signal whose
    # R envelope reads EXACTLY 0 displays center (a real decaying
    # envelope is merely tiny, so live hard-left still reads ~0.0).
    raw = torch.atan(bal_r / torch.where(bal_l == 0, 1.0, bal_l)) / (math.pi * 0.5)
    raw = torch.where(raw == 0.0, 0.5, raw)
    balance = torch.where(bal_l > 0, raw, torch.where(bal_r > 0, 1.0, 0.5))
    corr_bar = state.phase * 0.5 + 0.5
    return {"balance": balance, "correlation": corr_bar}


# ---------------------------------------------------------------------------
# autogain
# ---------------------------------------------------------------------------


def rms_autogain(state: VectorscopeMeterState, fallback=None) -> torch.Tensor:
    """RMS auto-gain 1 / max(sqrt(envL), sqrt(envR))
    (ref: Vectorscope.cpp:347-366). When the fresh value is degenerate
    (zero/inf envelope) the reference's isnormal() guard KEEPS the
    previous envelopeGain — the default fallback is the state's carried
    last-normal gain; pass ``fallback`` to override."""
    if fallback is None:
        fallback = state.gain
    g = 1.0 / torch.maximum(torch.sqrt(state.envelope[..., 0]), torch.sqrt(state.envelope[..., 1]))
    return torch.where(torch.isfinite(g) & (g > 0), g, fallback)


def peak_autogain_update(
    envelope: torch.Tensor, frames: torch.Tensor, decay_coeff, fallback=1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peak-decay auto-gain over the visible buffer
    (ref: runPeakFilter, VectorscopeRendering.cpp:825-889):
    env[ch] = max(env * coeff, peak[ch]^2); gain = 1/max(sqrt(env)).

    envelope [..., 2]; frames [..., 2, W]. Returns (new_envelope, gain).
    ``fallback`` replaces a degenerate gain — pass the previous gain for
    the reference's isnormal() hold (VectorscopeRendering.cpp:884-888)."""
    peaks = frames[..., :2, :].abs().amax(dim=-1)  # [..., 2]
    new_env = torch.maximum(envelope * decay_coeff, peaks**2)
    g = 1.0 / torch.sqrt(torch.maximum(new_env[..., 0], new_env[..., 1]))
    gain = torch.where(torch.isfinite(g) & (g > 0), g, fallback)
    return new_env, gain


def apply_transform(vertices: torch.Tensor, matrix, translation=None) -> torch.Tensor:
    """Apply a 3x3 transform (+ optional translation) to [..., N, 3] vertex
    clouds (ref: ParameterTransformValue / MatrixModification usage —
    the reference applies these on the GL matrix stack). Nine multiply-adds
    a vertex, written out so that no matmul precision setting applies."""
    m = torch.as_tensor(matrix, dtype=vertices.dtype, device=vertices.device)
    out = (vertices[..., None, :] * m).sum(-1)
    if translation is not None:
        out = out + torch.as_tensor(translation, dtype=vertices.dtype, device=vertices.device)
    return out
