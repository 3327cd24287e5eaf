"""Kernel A: channel packing -> window -> FFT -> magnitude, each frame row
a packed real transform in one CUDA block's shared memory, or, for rows too
long for that, a four-step transform through device memory.

Replaces the Pallas kernel
``signalizer_tpu/kernels/pallas_spectrum.py::fused_window_rfft_mag`` and
computes stage 1 of the Spectrum step (ref: TransformDSP.inl
prepareTransform :38-231, doTransform :486-502): the JAX production path
runs it as ``_pack_channels`` + ``_half_spectrum`` + ``abs``
(``signalizer_tpu/kernels/spectrum.py:118-200, :362-364``). The CUDA source
is ``signalizer_tpu_torch/csrc/window_fft_mag.cu`` (the one-block form)
and ``csrc/window_fft_mag_long.cu`` (the long form); this module holds their
wrapper, the plain PyTorch version and the stage-1 helpers the Spectrum
functions share.

:func:`window_fft_mag` on a CPU tensor runs :func:`window_fft_mag_plain`;
on a CUDA tensor it launches one of the two forms, picked by the transform
size, or raises. Output per mode:

* real magnitude modes: ``[..., rows, N/2+1]`` f32, DC/Nyquist halved;
* COMPLEX: ``[..., 1, N]`` f32, the full circle, no halving;
* PHASE: ``[..., 2, N/2+1]`` complex64 half spectra, DC/Nyquist halved
  (its tail needs the complex cells).
"""

from __future__ import annotations

import torch

from signalizer_tpu_torch.core.config import SpectrumChannels
from signalizer_tpu_torch.core.constant import SpectrumConstant
from signalizer_tpu_torch.kernels import _build

# the largest transforms the one-block form holds in one block's shared
# memory: a real row runs as an N/2-point complex transform (4*N bytes),
# COMPLEX as an N-point one (8*N bytes); longer rows take the long form
MAX_TRANSFORM_SIZE = 32768
MAX_COMPLEX_TRANSFORM_SIZE = 16384
# the longest rows the long form takes: a core of L = 2^20 complex points
# (its first pass holds 16 columns of L1 = 1024 points, 128 KB)
MAX_LONG_TRANSFORM_SIZE = 1 << 21
MAX_LONG_COMPLEX_TRANSFORM_SIZE = 1 << 20

# calls that launched each form since the last reset (chip_smoke.py and
# tests read them): the one-block kernel, and the long form's two passes
launches = 0
long_launches = 0


def _pack_channels(constant: SpectrumConstant, frames: torch.Tensor) -> torch.Tensor:
    """frames [..., C, W] -> windowed real rows [..., rows, W] (or complex
    [..., W] for Complex mode). Ref packing factors: TransformDSP.inl:91-215."""
    cfg = constant.configuration
    w = constant.window_kernel
    left = frames[..., 0, :]
    if cfg == SpectrumChannels.LEFT:
        rows = left[..., None, :]
    elif cfg == SpectrumChannels.RIGHT:
        rows = frames[..., 1, :][..., None, :]
    elif cfg == SpectrumChannels.MERGE:
        rows = ((left + frames[..., 1, :]) * 0.5)[..., None, :]
    elif cfg == SpectrumChannels.SIDE:
        rows = ((left - frames[..., 1, :]) * 0.5)[..., None, :]
    elif cfg == SpectrumChannels.MIDSIDE:
        right = frames[..., 1, :]
        rows = torch.stack([(left + right) * 0.5, (left - right) * 0.5], dim=-2)
    elif cfg in (SpectrumChannels.PHASE, SpectrumChannels.SEPARATE):
        rows = frames[..., :2, :]
    elif cfg == SpectrumChannels.COMPLEX:
        return torch.complex(left * w, frames[..., 1, :] * w)
    else:  # pragma: no cover
        raise ValueError(cfg)
    return rows * w


def _half_spectrum(constant: SpectrumConstant, rows: torch.Tensor) -> torch.Tensor:
    """Windowed rows [..., W] -> rFFT bins [..., N/2+1] complex, zero-padded
    to transform_size, with DC and Nyquist halved
    (ref: TransformDSP.inl:551-554 — the one-sided display convention)."""
    n = constant.transform_size
    spec = torch.fft.rfft(rows, n=n, dim=-1)
    nb = n // 2
    scale = torch.ones(nb + 1, dtype=rows.dtype, device=rows.device)
    scale[0] = 0.5
    scale[nb] = 0.5
    return spec * scale


def window_fft_mag_plain(constant: SpectrumConstant, frames: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch stage 1: ``_pack_channels`` -> ``torch.fft`` ->
    DC/Nyquist halving -> ``abs`` (PHASE: the complex half spectra)."""
    if constant.configuration == SpectrumChannels.COMPLEX:
        z = _pack_channels(constant, frames)
        return torch.fft.fft(z, n=constant.transform_size, dim=-1).abs()[..., None, :]
    spec = _half_spectrum(constant, _pack_channels(constant, frames))
    if constant.configuration == SpectrumChannels.PHASE:
        return spec
    return spec.abs()


def out_shape(constant: SpectrumConstant, lead) -> tuple:
    """Stage-1 output shape for frames with leading dims ``lead``."""
    n = constant.transform_size
    if constant.configuration == SpectrumChannels.COMPLEX:
        return tuple(lead) + (1, n)
    return tuple(lead) + (constant.state_channels, n // 2 + 1)


def uses_long_form(constant: SpectrumConstant) -> bool:
    """Whether a CUDA call for this constant takes the long form."""
    limit = MAX_COMPLEX_TRANSFORM_SIZE if constant.configuration == SpectrumChannels.COMPLEX else MAX_TRANSFORM_SIZE
    return constant.transform_size > limit


def window_fft_mag(constant: SpectrumConstant, frames: torch.Tensor) -> torch.Tensor:
    """Stage 1 of the Spectrum step for frames [..., C, W] f32.

    CPU tensors take :func:`window_fft_mag_plain`; CUDA tensors launch
    ``csrc/window_fft_mag.cu`` (a block a row) up to 32768 points (16384 for
    COMPLEX) and ``csrc/window_fft_mag_long.cu`` (two passes through a
    scratch tensor) above, or raise.
    """
    global launches, long_launches
    if frames.device.type == "cpu":
        return window_fft_mag_plain(constant, frames)
    if frames.device.type != "cuda":
        raise ValueError(f"window_fft_mag: unsupported device {frames.device}")
    n = constant.transform_size
    complex_mode = constant.configuration == SpectrumChannels.COMPLEX
    long_form = uses_long_form(constant)
    longest = MAX_LONG_COMPLEX_TRANSFORM_SIZE if complex_mode else MAX_LONG_TRANSFORM_SIZE
    if n > longest:
        raise ValueError(f"window_fft_mag: transform_size {n} > {longest}, the longest row the kernel takes")
    w = constant.window_size
    if frames.dtype != torch.float32:
        raise TypeError(f"window_fft_mag: frames must be float32, got {frames.dtype}")
    if frames.ndim < 2 or frames.shape[-1] != w or frames.shape[-2] < 2:
        raise ValueError(f"window_fft_mag: frames must be [..., C>=2, {w}], got {tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("window_fft_mag: frames must be contiguous")
    for name in ("window_kernel", "fft_twiddles"):
        if getattr(constant, name).device != frames.device:
            raise ValueError(f"window_fft_mag: constant.{name} is not on {frames.device}")
    if tuple(constant.fft_twiddles.shape) != (n, 2) or not constant.fft_twiddles.is_contiguous():
        raise ValueError(f"window_fft_mag: constant.fft_twiddles must be a contiguous [{n}, 2] table")
    lead = frames.shape[:-2]
    batch = 1
    for d in lead:
        batch *= d
    phase = constant.configuration == SpectrumChannels.PHASE
    shape = out_shape(constant, lead) + ((2,) if phase else ())
    out = torch.empty(shape, dtype=torch.float32, device=frames.device)
    if batch == 0:
        return torch.view_as_complex(out) if phase else out
    lib = _build.library()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        if long_form:
            # the columns' transforms, twiddled: [rows, L] complex points
            core = n if complex_mode else n // 2
            scratch = torch.empty(
                (batch * constant.state_channels, core, 2), dtype=torch.float32, device=frames.device
            )
            err = lib.sig_window_fft_mag_long(
                frames.data_ptr(), constant.window_kernel.data_ptr(), constant.fft_twiddles.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), batch, frames.shape[-2], w, n.bit_length() - 1,
                int(constant.configuration), stream,
            )
        else:
            err = lib.sig_window_fft_mag(
                frames.data_ptr(),
                constant.window_kernel.data_ptr(),
                constant.fft_twiddles.data_ptr(),
                out.data_ptr(),
                batch,
                frames.shape[-2],
                w,
                n.bit_length() - 1,
                int(constant.configuration),
                stream,
            )
    _build.check(err, "window_fft_mag")
    if long_form:
        long_launches += 1
    else:
        launches += 1
    return torch.view_as_complex(out) if phase else out
