"""Spectrum analysis: window -> FFT -> magnitude -> pixel remap -> decay -> dB.

Counterpart of :mod:`signalizer_tpu.kernels.spectrum` (ref:
Source/Spectrum/TransformDSP.inl — prepareTransform :38-231, doTransform
:486-502, mapToLinearSpace :504-1135, mapAndTransformDFTFilters
:1297-1435), with the same shapes and semantics. Two stages carry the
Spectrum step, each a hand-written CUDA kernel with a plain PyTorch version
beside it:

* stage 1, :func:`~signalizer_tpu_torch.kernels.window_fft_mag.window_fft_mag`
  — channel packing, window, FFT, DC/Nyquist halving, ``|.|``;
* the magnitude tail, :func:`~signalizer_tpu_torch.kernels.display_map.display_map`
  — ``_remap_mag``, peak decay over T and K, dB map.

A CPU tensor runs the plain versions, a CUDA tensor the kernels. PHASE's
values (complex interpolation, a first-maximum argbin over each pixel's
chunk, the cancellation), fed by stage 1's complex output, are
:func:`phase_values_plain` on the CPU and one kernel on a GPU
(:mod:`~signalizer_tpu_torch.kernels.phase_values`; the JAX package ran
them as XLA ops); their decay, phase smoothing and dB map are kernel G on a GPU
(:mod:`~signalizer_tpu_torch.kernels.phase_decay_db`). For the magnitude modes, :func:`spectrum_values` and
:func:`post_process` are the two halves of the tail, each its own entry of
the display kernel on a CUDA tensor
(:func:`~signalizer_tpu_torch.kernels.display_map.display_remap`,
:func:`~signalizer_tpu_torch.kernels.display_map.display_decay_db`);
:func:`analyze_frames` runs both halves in one launch. Only the linear
max-decay semantics are ported; ``decay_domain`` is accepted for API parity
and ignored.

The carried :class:`LineGraphState` is updated in place by
:func:`post_process` and :func:`analyze_frames` (the JAX step donated it).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from signalizer_tpu_torch.core.config import SpectrumChannels
from signalizer_tpu_torch.core.constant import SpectrumConstant, resolve_device
from signalizer_tpu_torch.kernels.display_map import (  # noqa: F401 — re-exported
    _binmax_mag,
    _db_map,
    _interp,
    _interp_mag,
    _remap_mag,
    decay_db,
    display_decay_db,
    display_map,
    display_remap,
)
from signalizer_tpu_torch.kernels.phase_decay_db import phase_decay_db
from signalizer_tpu_torch.kernels.phase_values import phase_values
from signalizer_tpu_torch.kernels.window_fft_mag import (  # noqa: F401 — re-exported
    _half_spectrum,
    _pack_channels,
    window_fft_mag,
)
from signalizer_tpu_torch.utils.diagnostics import span


class LineGraphState(NamedTuple):
    """Per-line-graph peak-decay filter state
    (ref: TransformPair.h:63-94 LineGraphDesc.states)."""

    magnitude: torch.Tensor  # [..., K, rows, P] decayed peak magnitudes
    phase: torch.Tensor  # [..., K, P] smoothed phase (Phase mode only)


def init_line_graph_state(
    constant: SpectrumConstant, batch_shape: Tuple[int, ...] = ()
) -> LineGraphState:
    k = constant.num_line_graphs
    rows = constant.state_channels
    p = constant.axis_points
    dev = constant.device
    return LineGraphState(
        magnitude=torch.zeros(batch_shape + (k, rows, p), dtype=torch.float32, device=dev),
        phase=torch.zeros(batch_shape + (k, p), dtype=torch.float32, device=dev),
    )


def line_graph_state_from_arrays(magnitude, phase, device=None) -> LineGraphState:
    """A :class:`LineGraphState` from carried state given as arrays (e.g. a
    JAX state read with ``np.asarray``), copied to ``device`` (``None``:
    the GPU, raising without one)."""
    device = resolve_device(device)
    return LineGraphState(
        magnitude=torch.tensor(magnitude, dtype=torch.float32, device=device),
        phase=torch.tensor(phase, dtype=torch.float32, device=device),
    )


def stitch_preliminary(
    constant: SpectrumConstant,
    history: torch.Tensor,
    preliminary: torch.Tensor,
    num_samples: int = None,
) -> torch.Tensor:
    """Stitch an analysis window from retained history plus a raw
    in-flight block not yet committed to the history (ref: the
    preliminary-audio prepareTransform overload, TransformDSP.inl:233-484).

    ``history`` [..., C, H >= window - stop] (newest last), ``preliminary``
    [..., C, S]; ``num_samples`` (defaults to S) = how many leading
    preliminary samples are valid. Returns the stitched [..., C, window]
    frame, bit-equal to framing after the block commits.
    """
    w = constant.window_size
    s = preliminary.shape[-1]
    stop = min(int(num_samples) if num_samples is not None else s, w)
    hist_n = w - stop
    parts = []
    if hist_n:
        h = history.shape[-1]
        if h < hist_n:
            raise ValueError(f"history {h} < required tail {hist_n}")
        parts.append(history[..., h - hist_n : h])
    if stop:
        parts.append(preliminary[..., :stop])
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def _binmax_argbin(values: torch.Tensor, constant: SpectrumConstant) -> torch.Tensor:
    """First bin index achieving the chunk max of ``values`` per pixel
    (ref: strictly-greater update in TransformDSP.inl:826-838 selects the
    first maximum). values [..., n_values] -> int64 [..., P]."""
    g = torch.where(constant.band_mask, values[..., constant.band_idx], -torch.inf)
    first = constant.band_idx[:, 0] + torch.argmax(g, dim=-1)  # first maximum
    return torch.where(constant.single_mask, constant.single_bin.long(), first)


def phase_values_plain(constant: SpectrumConstant, spec: torch.Tensor) -> torch.Tensor:
    """PHASE's display values from the complex half spectra ``spec`` [..., 2,
    nv] (stage 1's PHASE output) in plain PyTorch, one torch operation at a
    time: [..., 2, P], row 0 the mid magnitude, row 1 the cancellation.
    :func:`~signalizer_tpu_torch.kernels.phase_values.phase_values` runs it
    on a CPU tensor and launches one kernel, held to it, on a CUDA tensor."""
    inv = constant.inv_size
    mags = spec.abs()
    l, r = spec[..., 0, :], spec[..., 1, :]
    # interpolation region: complex interp for cancellation, magnitude
    # interp for mid (ref: TransformDSP.inl:671-803)
    il = _interp(l, constant)
    ir = _interp(r, constant)
    mid_i = inv * (_interp(mags[..., 0, :], constant) + _interp(mags[..., 1, :], constant))
    cancel_num = inv * (il + ir).abs()
    mid_for_cancel = inv * (il.abs() + ir.abs())
    cancel_i = 1.0 - torch.where(
        mid_for_cancel > 0, cancel_num / torch.clamp(mid_for_cancel, min=1e-30), 0.0
    )
    # bin-max region: argmax of max(|L|^2, |R|^2) per chunk
    # (ref: TransformDSP.inl:813-850)
    power = torch.maximum(mags[..., 0, :], mags[..., 1, :])
    maxbin = _binmax_argbin(power, constant)  # [..., P]
    lm = torch.gather(l, -1, maxbin)
    rm = torch.gather(r, -1, maxbin)
    mid_b = inv * (lm.abs() + rm.abs())
    interference = inv * (lm + rm).abs()
    cancel_b = 1.0 - torch.where(mid_b > 0, interference / torch.clamp(mid_b, min=1e-30), 0.0)
    mid = torch.where(constant.interp_mask, mid_i, mid_b)
    cancel = torch.where(constant.interp_mask, cancel_i, cancel_b)
    return torch.stack([mid, cancel], dim=-2)


def spectrum_values(constant: SpectrumConstant, frames: torch.Tensor) -> torch.Tensor:
    """Frames [..., C, W] -> display-space linear values [..., rows, P].

    * mono modes / Complex: rows=1, magnitude.
    * Separate / MidSide: rows=2, (first, second) magnitudes.
    * Phase: rows=2, (mid magnitude, phase-cancellation in [0, 1]).
    """
    stage1 = window_fft_mag(constant, frames)
    if constant.configuration != SpectrumChannels.PHASE:
        # magnitudes for every other mode: the reference abs()'s csf
        # before its loops (ref: TransformDSP.inl:557-560/866-869/999-1002)
        return display_remap(constant, stage1)

    with span("phase.values"):
        return phase_values(constant, stage1)


class SpectrumResult(NamedTuple):
    """Post-processed display frames: ``results`` [..., T, K, rows, P]
    normalized display values; ``state`` the carry for the next call."""

    results: torch.Tensor
    state: LineGraphState


def post_process(
    constant: SpectrumConstant,
    state: LineGraphState,
    vals: torch.Tensor,
    valid=None,
    decay_domain: str = "auto",
) -> SpectrumResult:
    """Per-line-graph peak decay + dB mapping over a time-sequence.

    ``vals`` [..., T, rows, P] are time-ordered linear display values (from
    :func:`spectrum_values`); ``state = max(pole * state, new)`` (ref:
    TransformDSP.inl:1336-1341) runs over T, on a GPU in one launch: kernel
    B's decay-and-dB entry, or in PHASE kernel G (with the phase
    smoothing, :func:`~signalizer_tpu_torch.kernels.phase_decay_db.phase_decay_db`).
    ``valid`` (optional [T] bool) marks padded frames that leave every
    filter state untouched. ``state``'s tensors are updated in place and
    returned in the result. ``decay_domain`` is accepted for parity with
    the JAX package and ignored: the port has the linear semantics only.
    """
    del decay_domain
    if constant.configuration == SpectrumChannels.PHASE:
        return SpectrumResult(phase_decay_db(constant, state, vals, valid), state)
    results = display_decay_db(constant, state.magnitude, vals.contiguous(), valid)
    return SpectrumResult(results, state)


def analyze_frames(
    constant: SpectrumConstant,
    state: LineGraphState,
    frames: torch.Tensor,
    valid=None,
    decay_domain: str = "auto",
) -> SpectrumResult:
    """Full pipeline: frames [..., T, C, W] -> display results
    [..., T, K, rows, P] (ref: TransformDSP.inl:1163-1211, :1137-1148).

    Magnitude modes run stage 1 then the display tail (on CUDA: kernel A
    then kernel B); PHASE runs :func:`spectrum_values` +
    :func:`post_process`. ``valid`` [T] masks padded frames out of the
    filter states. ``state`` is updated in place (the JAX step donated it).
    """
    if constant.configuration == SpectrumChannels.PHASE:
        vals = spectrum_values(constant, frames)
        return post_process(constant, state, vals, valid=valid, decay_domain=decay_domain)
    mags = window_fft_mag(constant, frames)  # [..., T, rows, nv]
    results = display_map(constant, mags, state.magnitude, valid)
    return SpectrumResult(results, state)
