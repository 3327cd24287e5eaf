"""The Spectrum's PHASE values: each pixel's mid magnitude and phase
cancellation from a pair's complex half spectra.

Counterpart of the PHASE branch of
:func:`signalizer_tpu.kernels.spectrum.spectrum_values` (ref:
TransformDSP.inl:671-850), which the JAX package runs as XLA operations
with no Pallas kernel. :func:`phase_values` launches one kernel on a GPU,
``csrc/phase_values.cu``, and runs the plain version on the CPU:
:func:`~signalizer_tpu_torch.kernels.spectrum.phase_values_plain`, the
torch operations of ``spectrum_values``' PHASE branch (complex tap
interpolation, the first-maximum argbin over each pixel's chunk, the
gathers, the cancellation), which the CPU runs and the kernel is held to.
"""

from __future__ import annotations

import torch

from signalizer_tpu_torch.core.constant import SpectrumConstant
from signalizer_tpu_torch.kernels import _build
from signalizer_tpu_torch.utils.diagnostics import count

# the most taps the kernel takes (csrc/phase_values.cu kMaxTaps): Lanczos,
# a = 5, the most any plan has
MAX_TAPS = 10
# kernel launches count in the diagnostics registry as phase_values.launches


def phase_values(constant: SpectrumConstant, spec: torch.Tensor) -> torch.Tensor:
    """Complex half spectra ``spec`` [..., 2, nv] complex64 (kernel A's PHASE
    output: row 0 the left channel, row 1 the right) -> [..., 2, P] f32, row
    0 the mid magnitude, row 1 the cancellation in [0, 1]. CPU tensors take
    :func:`~signalizer_tpu_torch.kernels.spectrum.phase_values_plain`; CUDA
    tensors launch ``sig_phase_values`` of ``csrc/phase_values.cu`` once,
    reading ``spec`` in place as float pairs, or raise."""
    c = constant
    if spec.device.type == "cpu":
        from signalizer_tpu_torch.kernels.spectrum import phase_values_plain

        return phase_values_plain(c, spec)
    nv, p = c.n_spectrum_values, c.axis_points
    if spec.device.type != "cuda" or c.device != spec.device:
        raise ValueError(f"phase_values: spectra on {spec.device}, constant on {c.device}")
    if spec.dtype != torch.complex64 or spec.ndim < 2 or tuple(spec.shape[-2:]) != (2, nv):
        raise ValueError(f"phase_values: spectra must be complex64 [..., 2, {nv}], got {spec.dtype} "
                         f"{tuple(spec.shape)}")
    if not spec.is_contiguous():
        raise ValueError("phase_values: spectra must be contiguous")
    if c.interp_taps > MAX_TAPS:
        raise ValueError(f"phase_values: at most {MAX_TAPS} taps, got {c.interp_taps}")
    out = torch.empty(spec.shape[:-2] + (2, p), dtype=torch.float32, device=spec.device)
    frames = out.numel() // (2 * p)
    if frames == 0:
        return out
    # the last count is the plan's longest chunk: it picks the kernel's mapping
    _build.launch(
        "sig_phase_values", spec.device, spec.data_ptr(), c.interp_indices.data_ptr(), c.interp_weights.data_ptr(),
        c.interp_mask.data_ptr(), c.single_mask.data_ptr(), c.single_bin.data_ptr(), c.chunk_lo.data_ptr(),
        c.chunk_len.data_ptr(), c.display_scalars.data_ptr(), out.data_ptr(), frames, p, nv, c.interp_taps,
        c.band_idx.shape[-1], name="phase_values",
    )
    count("phase_values.launches")
    return out
