"""Kernel C: Lanczos, linear or nearest resample of history rows at
fractional positions shared by the rows of a pair.

Replaces the Pallas kernel
``signalizer_tpu/kernels/pallas_resample.py::fused_banded_resample`` (ref:
the per-pixel sampleAt<Lanczos>/linear/nearest taps of
OscilloscopeRendering.cpp drawWavePlot :854-888). The CUDA source is
``signalizer_tpu_torch/csrc/banded_resample.cu``; this module holds its
wrapper and its plain PyTorch version, the per-tap form of the JAX
package's ``_sinc_gather`` together with the gather branches of
``linear_resample`` and ``nearest_resample``
(``signalizer_tpu/kernels/oscilloscope.py:531-544, :668-674, :691-697``).

:func:`banded_resample` on a CPU tensor runs :func:`banded_resample_plain`;
on a CUDA tensor it launches the kernel or raises. Shapes: x ``[B, R, W]``
f32, pos ``[B, P]`` f32 (any P) -> ``[B, R, P]`` f32, and a second
``[B, R, P]`` nearest pick at the same positions with ``with_nearest``.
Edge taps clamp to ``[0, W-1]``.
"""

from __future__ import annotations

import torch

from signalizer_tpu_torch.kernels import _build

KINDS = {"lanczos": 0, "linear": 1, "nearest": 2}
MAX_A = 16  # kMaxA in the CUDA source
# kSmemFloats in the CUDA source: a block stages its tap span for all R rows
# in shared memory when R * span fits, else it reads the taps from global
# memory (the kernel's second form)
SMEM_FLOATS = 3072
BLOCK = 128  # pixels per CUDA block

# kernel launches since the last reset (chip_smoke.py and tests read it)
launches = 0


def block_span(step: float, a: int) -> int:
    """Source samples a 128-pixel block of evenly spaced positions ``step``
    apart reads at most (its tap span in the kernel)."""
    return int(abs(step) * (BLOCK - 1)) + 2 * a + 1


def stages_in_shared_memory(rows: int, step: float, a: int) -> bool:
    """Whether the kernel's blocks stage their taps in shared memory for
    ``rows`` rows at position spacing ``step`` (upper bound of the span)."""
    return rows * block_span(step, a) <= SMEM_FLOATS


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, R, W] at idx [B, P, K] (shared by the rows) -> [B, R, P, K]."""
    b, r, _ = x.shape
    flat = idx.reshape(b, 1, -1).expand(b, r, -1)
    return torch.gather(x, -1, flat).reshape((b, r) + tuple(idx.shape[1:]))


def _nearest_plain(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Nearest sample, ties upward: ``clamp(floor(pos + 0.5))``."""
    w = x.shape[-1]
    idx = torch.clamp(torch.floor(pos + 0.5).long(), 0, w - 1)
    return _gather_rows(x, idx[..., None])[..., 0]


def banded_resample_plain(
    x: torch.Tensor, pos: torch.Tensor, *, a: int, kind: str, with_nearest: bool = False
):
    """Plain PyTorch version of kernel C, per tap.

    * lanczos: ``sum_j sinc(t_j) sinc(t_j / a) x[clamp(i_j)]`` over the 2a
      taps ``i_j = floor(pos) - a + 1 + j``, ``t_j = pos - i_j``, weights
      zero at ``|t| >= a`` (``_sinc_gather``);
    * linear: ``x[i0] (1 - frac) + x[i0 + 1] frac`` with clamped indices;
    * nearest: ``x[clamp(floor(pos + 0.5))]``.
    """
    if kind not in KINDS:
        raise ValueError(f"banded_resample: unknown kind {kind!r}")
    w = x.shape[-1]
    if kind == "lanczos":
        i0 = torch.floor(pos)
        offs = torch.arange(-a + 1, a + 1, dtype=pos.dtype, device=pos.device)
        tap_pos = i0[..., None] + offs  # [B, P, 2a]
        t = pos[..., None] - tap_pos
        weights = torch.where(t.abs() < a, torch.sinc(t) * torch.sinc(t / a), 0.0)
        idx = torch.clamp(tap_pos.long(), 0, w - 1)
        out = torch.sum(_gather_rows(x, idx) * weights[:, None], dim=-1)
    elif kind == "linear":
        i0 = torch.floor(pos)
        frac = (pos - i0)[:, None]
        idx = torch.clamp(torch.stack([i0, i0 + 1], dim=-1).long(), 0, w - 1)
        g = _gather_rows(x, idx)
        out = g[..., 0] * (1 - frac) + g[..., 1] * frac
    else:
        out = _nearest_plain(x, pos)
    if with_nearest:
        return out, _nearest_plain(x, pos)
    return out


def _check(x: torch.Tensor, pos: torch.Tensor, a: int, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"banded_resample: unknown kind {kind!r}")
    if not 1 <= a <= MAX_A:
        raise ValueError(f"banded_resample: a={a} outside [1, {MAX_A}]")
    if x.dtype != torch.float32 or pos.dtype != torch.float32:
        raise TypeError(f"banded_resample: x and pos must be float32, got {x.dtype}, {pos.dtype}")
    if x.ndim != 3 or pos.ndim != 2 or pos.shape[0] != x.shape[0] or x.shape[-1] < 1:
        raise ValueError(
            f"banded_resample: x must be [B, R, W] and pos [B, P], got "
            f"{tuple(x.shape)} and {tuple(pos.shape)}"
        )
    if not (x.is_contiguous() and pos.is_contiguous()):
        raise ValueError("banded_resample: x and pos must be contiguous")
    if pos.device != x.device:
        raise ValueError(f"banded_resample: pos on {pos.device}, x on {x.device}")


def banded_resample(
    x: torch.Tensor, pos: torch.Tensor, *, a: int, kind: str, with_nearest: bool = False
):
    """Resample x [B, R, W] at pos [B, P] -> [B, R, P] (and the nearest
    pick at the same positions with ``with_nearest``).

    CPU tensors take :func:`banded_resample_plain`; CUDA tensors launch
    ``csrc/banded_resample.cu`` (one block per pair and 128 pixels) or raise.
    """
    global launches
    if x.device.type == "cpu":
        return banded_resample_plain(x, pos, a=a, kind=kind, with_nearest=with_nearest)
    if x.device.type != "cuda":
        raise ValueError(f"banded_resample: unsupported device {x.device}")
    _check(x, pos, a, kind)
    bsz, rows, w = x.shape
    p = pos.shape[-1]
    out = torch.empty((bsz, rows, p), dtype=torch.float32, device=x.device)
    near = torch.empty_like(out) if with_nearest else None
    if out.numel() == 0:
        return (out, near) if with_nearest else out
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sig_banded_resample(
            x.data_ptr(),
            pos.data_ptr(),
            out.data_ptr(),
            near.data_ptr() if with_nearest else None,
            bsz,
            rows,
            w,
            p,
            a,
            KINDS[kind],
            stream,
        )
    _build.check(err, "banded_resample")
    launches += 1
    return (out, near) if with_nearest else out
