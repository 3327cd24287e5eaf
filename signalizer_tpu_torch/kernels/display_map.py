"""Kernel B: pixel remap -> peak decay -> normalized dB over all frames and
line graphs, one CUDA warp per (pair, row, 32 pixels, 8 frames) with the
decay recurrence split exactly across the groups of frames.

Replaces the Pallas kernel ``tools/pallas_display_map.py::fused_display_map``
and computes the magnitude tail of the Spectrum step: the JAX production
path runs it as ``_remap_mag`` + ``post_process``
(``signalizer_tpu/kernels/spectrum.py:286-291, :518-598``; ref:
TransformDSP.inl mapToLinearSpace :504-1135, mapAndTransformDFTFilters
:1297-1435). The CUDA source is ``signalizer_tpu_torch/csrc/display_map.cu``;
this module holds its wrapper, its plain PyTorch version and the remap/dB
helpers the Spectrum functions share.

Only the linear max-decay semantics exist here: the JAX package's log-domain
form is the same function evaluated another way on the TPU.
"""

from __future__ import annotations

import torch

from signalizer_tpu_torch.core.constant import SpectrumConstant, db_constants
from signalizer_tpu_torch.kernels import _build
from signalizer_tpu_torch.kernels.peak_decay import peak_decay_scan

# the most taps and line graphs the kernel takes
MAX_TAPS = 10
MAX_LINE_GRAPHS = 8

# kernel launches since the last reset (chip_smoke.py and tests read it)
launches = 0


def _interp(values: torch.Tensor, constant: SpectrumConstant) -> torch.Tensor:
    """Weighted tap gather: values [..., n_values] -> [..., P]. Works on
    real or complex values (PHASE interpolates complex cells)."""
    g = values[..., constant.interp_indices]  # [..., P, taps]
    return (g * constant.interp_weights).sum(-1)


def _binmax_mag(mags: torch.Tensor, constant: SpectrumConstant) -> torch.Tensor:
    """Chunked bin-max for magnitude rows (ref: TransformDSP.inl:608-639):
    a banded gather of each pixel's contiguous chunk plus a masked max."""
    g = mags[..., constant.band_idx]  # [..., P, maxband]
    segmax = torch.where(constant.band_mask, g, -torch.inf).amax(-1)
    single = mags[..., constant.single_bin]
    return torch.where(constant.single_mask, single, segmax)


def _interp_mag(mags: torch.Tensor, constant: SpectrumConstant) -> torch.Tensor:
    """Magnitude interpolation with the |.| rectification applied (the
    Lanczos kernel has negative lobes)."""
    return _interp(mags, constant).abs()


def _remap_mag(mags: torch.Tensor, constant: SpectrumConstant) -> torch.Tensor:
    """Interpolate-vs-binmax pixel remap for magnitude rows
    (ref: mapToLinearSpace, TransformDSP.inl:562-639)."""
    return torch.where(
        constant.interp_mask, _interp_mag(mags, constant), _binmax_mag(mags, constant)
    )


def _db_map(constant: SpectrumConstant, magnitudes: torch.Tensor) -> torch.Tensor:
    """Normalized dB mapping (ref: TransformDSP.inl:1308-1346):
    ``log(slope * mag / lowerFrac) / log(upperFrac / lowerFrac)``, clipped to
    ``clip_db`` where the argument is non-positive. Output is display-space:
    0 at low_dbs, 1 at high_dbs."""
    lower, delta_y_recip = db_constants(constant.low_dbs, constant.high_dbs)
    x = constant.slope_map * magnitudes / lower
    return torch.where(
        x > 0, torch.log(torch.clamp(x, min=1e-38)) * delta_y_recip, constant.clip_db
    )


def decay_db(
    constant: SpectrumConstant, state: torch.Tensor, vals: torch.Tensor, valid=None
) -> torch.Tensor:
    """Peak decay + dB map of display values ``vals`` [..., T, rows, P]
    against ``state`` [..., K, rows, P]; returns [..., T, K, rows, P].
    ``state`` is updated in place (the JAX step donated it)."""
    seq = vals[..., :, None, :, :]  # [..., T, 1, rows, P]
    decayed, new_state = peak_decay_scan(
        state, seq, constant.decay_poles[:, None, None], time_axis=-4, valid=valid
    )
    state.copy_(new_state)
    return _db_map(constant, decayed)


def display_map_plain(
    constant: SpectrumConstant, mags: torch.Tensor, state: torch.Tensor, valid=None
) -> torch.Tensor:
    """Plain PyTorch magnitude tail: ``inv_size * _remap_mag`` -> the
    sequential peak-decay loop -> ``_db_map``. ``mags`` [..., T, rows, nv],
    ``state`` [..., K, rows, P] updated in place; returns
    [..., T, K, rows, P]."""
    vals = constant.inv_size * _remap_mag(mags, constant)
    return decay_db(constant, state, vals, valid)


def _valid_tensor(valid, t: int, device) -> torch.Tensor:
    v = torch.as_tensor(valid, dtype=torch.bool, device=device).reshape(-1)
    if v.numel() != t:
        raise ValueError(f"display_map: valid has {v.numel()} entries for T={t}")
    return v.contiguous()


def display_map(
    constant: SpectrumConstant, mags: torch.Tensor, state: torch.Tensor, valid=None
) -> torch.Tensor:
    """Remap + peak decay + dB for magnitudes ``mags`` [..., T, rows, nv] f32.

    ``state`` [..., K, rows, P] f32 is updated in place (the JAX step
    donated it); ``valid`` (optional [T] bool) marks padded frames that
    leave the state untouched. Returns display values [..., T, K, rows, P].
    CPU tensors take :func:`display_map_plain`; CUDA tensors launch
    ``csrc/display_map.cu`` or raise.
    """
    global launches
    if mags.device.type == "cpu":
        return display_map_plain(constant, mags, state, valid)
    if mags.device.type != "cuda":
        raise ValueError(f"display_map: unsupported device {mags.device}")
    p = constant.axis_points
    nv = constant.n_spectrum_values
    k = constant.num_line_graphs
    taps = constant.interp_taps
    if mags.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError("display_map: mags and state must be float32")
    if mags.ndim < 3 or mags.shape[-1] != nv:
        raise ValueError(f"display_map: mags must be [..., T, rows, {nv}], got {tuple(mags.shape)}")
    lead, t, rows = mags.shape[:-3], mags.shape[-3], mags.shape[-2]
    if tuple(state.shape) != tuple(lead) + (k, rows, p):
        raise ValueError(
            f"display_map: state must be {tuple(lead) + (k, rows, p)}, got {tuple(state.shape)}"
        )
    if not (mags.is_contiguous() and state.is_contiguous()):
        raise ValueError("display_map: mags and state must be contiguous")
    if state.device != mags.device or constant.device != mags.device:
        raise ValueError("display_map: mags, state and constant must share one device")
    if taps > MAX_TAPS or k > MAX_LINE_GRAPHS:
        raise ValueError(f"display_map: at most {MAX_TAPS} taps and {MAX_LINE_GRAPHS} line graphs")
    pairs = 1
    for d in lead:
        pairs *= d
    out = torch.empty(tuple(lead) + (t, k, rows, p), dtype=torch.float32, device=mags.device)
    if pairs == 0 or t == 0:
        return out
    v = None if valid is None else _valid_tensor(valid, t, mags.device)
    c = constant
    lib = _build.library()
    with torch.cuda.device(mags.device):
        stream = torch.cuda.current_stream(mags.device).cuda_stream
        err = lib.sig_display_map(
            mags.data_ptr(),
            c.interp_indices.data_ptr(),
            c.interp_weights.data_ptr(),
            c.interp_mask.data_ptr(),
            c.single_mask.data_ptr(),
            c.single_bin.data_ptr(),
            c.chunk_lo.data_ptr(),
            c.chunk_len.data_ptr(),
            c.slope_map.data_ptr(),
            c.decay_poles.data_ptr(),
            c.display_scalars.data_ptr(),
            None if v is None else v.data_ptr(),
            state.data_ptr(),
            out.data_ptr(),
            pairs,
            t,
            k,
            rows,
            p,
            nv,
            taps,
            stream,
        )
    _build.check(err, "display_map")
    launches += 1
    return out
