"""Kernel A: channel packing -> window -> FFT -> magnitude, each frame row
a packed real transform in one CUDA block's shared memory; for rows too
long for that, in a thread-block cluster's distributed shared memory; for
the longest rows, a four-step transform through device memory.

Replaces the Pallas kernel
``signalizer_tpu/kernels/pallas_spectrum.py::fused_window_rfft_mag`` and
computes stage 1 of the Spectrum step (ref: TransformDSP.inl
prepareTransform :38-231, doTransform :486-502): the JAX production path
runs it as ``_pack_channels`` + ``_half_spectrum`` + ``abs``
(``signalizer_tpu/kernels/spectrum.py:118-200, :362-364``). The CUDA source
is ``signalizer_tpu_torch/csrc/window_fft_mag.cu`` (the one-block form),
``csrc/window_fft_mag_cluster.cu`` (the cluster form) and
``csrc/window_fft_mag_long.cu`` (the two-pass form); this module holds
their wrapper, the plain PyTorch version and the stage-1 helpers the
Spectrum functions share.

:func:`window_fft_mag` on a CPU tensor runs :func:`window_fft_mag_plain`;
on a CUDA tensor it launches the form :func:`form` names, picked by the
transform size and whether the mode is COMPLEX, or raises. Output per
mode:

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
from signalizer_tpu_torch.utils.diagnostics import count, span

# the largest transforms the one-block form holds in one block's shared
# memory: a real row runs as an N/2-point complex transform (4*N bytes),
# COMPLEX as an N-point one (8*N bytes); longer rows take the cluster form
MAX_TRANSFORM_SIZE = 32768
MAX_COMPLEX_TRANSFORM_SIZE = 16384
# the longest rows the cluster form takes: a core of L = 65536 complex
# points (512 KB); longer rows take the two-pass form
MAX_CLUSTER_TRANSFORM_SIZE = 131072
MAX_CLUSTER_COMPLEX_TRANSFORM_SIZE = 65536
# a cluster's blocks hold CLUSTER_SHARE_BYTES of the core each: 4 blocks for
# L = 32768, 8 for 65536. On the card 4 blocks took 231 us at 512 rows of
# N = 65536 (8: 241) and 20 us at 16 rows (2: 27); at N = 131072, 8 blocks
# took 0.180 ms for 128 rows against 0.210 for 4 (PERF.md)
CLUSTER_SHARE_BYTES = 64 * 1024
# the longest rows the two-pass form takes: a core of L = 2^20 complex
# points (its first pass holds 16 columns of L1 = 1024 points, 128 KB)
MAX_LONG_TRANSFORM_SIZE = 1 << 21
MAX_LONG_COMPLEX_TRANSFORM_SIZE = 1 << 20

# calls that launched each form count in the diagnostics registry:
# window_fft_mag.launches (the one-block kernel), .cluster_launches (the
# cluster kernel) and .long_launches (the two-pass form's two kernels)


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


def form(constant: SpectrumConstant) -> str:
    """The form a CUDA call for this constant takes: ``"block"`` (one block
    a row), ``"cluster"`` (a thread-block cluster a row) or ``"two_pass"``
    (through a scratch tensor), by the transform size and whether the mode
    is COMPLEX (whose core is N points, not N/2)."""
    n = constant.transform_size
    cplx = constant.configuration == SpectrumChannels.COMPLEX
    if n <= (MAX_COMPLEX_TRANSFORM_SIZE if cplx else MAX_TRANSFORM_SIZE):
        return "block"
    if n <= (MAX_CLUSTER_COMPLEX_TRANSFORM_SIZE if cplx else MAX_CLUSTER_TRANSFORM_SIZE):
        return "cluster"
    return "two_pass"


def cluster_size(constant: SpectrumConstant) -> int:
    """Blocks a row of the cluster form: the fewest (2, 4 or 8) whose share
    of the row's core (8 bytes a complex point) is at most
    ``CLUSTER_SHARE_BYTES``."""
    core = constant.transform_size
    if constant.configuration != SpectrumChannels.COMPLEX:
        core //= 2
    return min(8, max(2, 8 * core // CLUSTER_SHARE_BYTES))


def long_core(constant: SpectrumConstant) -> tuple:
    """The two-pass form's split of a row's core: ``(L1, L2)`` with
    ``L = L1 * L2`` complex points (N/2 for a real row, N for COMPLEX) and
    ``L1 = 2^floor(log2(L) / 2)``."""
    core = constant.transform_size
    if constant.configuration != SpectrumChannels.COMPLEX:
        core //= 2
    l1 = 1 << ((core.bit_length() - 1) >> 1)
    return l1, core // l1


def window_fft_mag(constant: SpectrumConstant, frames: torch.Tensor) -> torch.Tensor:
    """Stage 1 of the Spectrum step for frames [..., C, W] f32.

    CPU tensors take :func:`window_fft_mag_plain`; CUDA tensors launch
    ``csrc/window_fft_mag.cu`` (a block a row) up to 32768 points (16384 for
    COMPLEX), ``csrc/window_fft_mag_cluster.cu`` (a cluster of
    :func:`cluster_size` blocks a row) up to 131072 (65536) and
    ``csrc/window_fft_mag_long.cu`` (two passes through a scratch tensor)
    above, or raise.
    """
    with span("kernel.window_fft_mag"):
        if frames.device.type == "cpu":
            return window_fft_mag_plain(constant, frames)
        if frames.device.type != "cuda":
            raise ValueError(f"window_fft_mag: unsupported device {frames.device}")
        n = constant.transform_size
        complex_mode = constant.configuration == SpectrumChannels.COMPLEX
        route = form(constant)
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
        head = (frames.data_ptr(), constant.window_kernel.data_ptr(), constant.fft_twiddles.data_ptr())
        tail = (batch, frames.shape[-2], w, n.bit_length() - 1, int(constant.configuration))
        if route == "cluster":
            _build.launch("sig_window_fft_mag_cluster", frames.device, *head, out.data_ptr(), *tail,
                          cluster_size(constant).bit_length() - 1, name="window_fft_mag")
            count("window_fft_mag.cluster_launches")
        elif route == "two_pass":
            # the columns' transforms, twiddled: [rows, L] complex points
            core = n if complex_mode else n // 2
            scratch = torch.empty(
                (batch * constant.state_channels, core, 2), dtype=torch.float32, device=frames.device
            )
            _build.launch("sig_window_fft_mag_long", frames.device, *head, scratch.data_ptr(), out.data_ptr(),
                          *tail, name="window_fft_mag")
            count("window_fft_mag.long_launches")
        else:
            _build.launch("sig_window_fft_mag", frames.device, *head, out.data_ptr(), *tail, name="window_fft_mag")
            count("window_fft_mag.launches")
        return torch.view_as_complex(out) if phase else out
