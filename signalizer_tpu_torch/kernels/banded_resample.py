"""Kernel C: Lanczos, linear or nearest resample of history rows at
fractional positions shared by the rows of a pair.

Replaces the Pallas kernel
``signalizer_tpu/kernels/pallas_resample.py::fused_banded_resample`` (ref:
the per-pixel sampleAt<Lanczos>/linear/nearest taps of
OscilloscopeRendering.cpp drawWavePlot :854-888). The CUDA source is
``signalizer_tpu_torch/csrc/banded_resample.cu``; this module holds its
wrappers and its plain PyTorch version, the per-tap form of the JAX
package's ``_sinc_gather`` together with the gather branches of
``linear_resample`` and ``nearest_resample``
(``signalizer_tpu/kernels/oscilloscope.py:531-544, :668-674, :691-697``).

Two entries, one kernel. :func:`banded_resample` takes the positions as a
tensor (the TPU kernel's own signature); :func:`banded_resample_affine`
takes ``start [B]``, a host ``step`` and a clip range, and the kernel forms
``clamp(fma(p, step, start), lo, hi)`` itself, so evenly spaced positions
cost no launches and no tensor (a ``step`` tensor, one a pair, goes through
the ``pos`` entry). On a CPU tensor they run
:func:`banded_resample_plain` (the affine entry at
:func:`affine_positions`' tensor); on a CUDA tensor they launch the kernel
or raise. Shapes: x ``[B, R, W]`` f32, pos ``[B, P]`` f32 (any P) ->
``[B, R, P]`` f32, and a second ``[B, R, P]`` nearest pick at the same
positions with ``with_nearest``. Edge taps clamp to ``[0, W-1]``.

:func:`kernel_lanczos_weights` evaluates the Lanczos weights in torch the
way the kernel does (three trigonometric values a pixel and a rotation by
a host table), for the CPU tests.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from signalizer_tpu_torch.kernels import _build
from signalizer_tpu_torch.utils.diagnostics import count, span

KINDS = {"lanczos": 0, "linear": 1, "nearest": 2}
MAX_A = 16  # kMaxA in the CUDA source

# kernel launches count in the diagnostics registry as banded_resample.launches


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


def _tap_positions(pos: torch.Tensor, a: int) -> torch.Tensor:
    """The 2a taps ``floor(pos) - a + 1 .. floor(pos) + a`` -> [..., 2a]."""
    offs = torch.arange(-a + 1, a + 1, dtype=pos.dtype, device=pos.device)
    return torch.floor(pos)[..., None] + offs


def plain_lanczos_weights(t: torch.Tensor, a: int) -> torch.Tensor:
    """``sinc(t) sinc(t / a)``, zero at ``|t| >= a``."""
    return torch.where(t.abs() < a, torch.sinc(t) * torch.sinc(t / a), 0.0)


def _weighted_taps(x: torch.Tensor, tap_pos: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_j weights[b, p, j] * x[b, r, clamp(tap_pos[b, p, j])] -> [B, R, P]."""
    idx = torch.clamp(tap_pos.long(), 0, x.shape[-1] - 1)
    return torch.sum(_gather_rows(x, idx) * weights[:, None], dim=-1)


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
        tap_pos = _tap_positions(pos, a)
        out = _weighted_taps(x, tap_pos, plain_lanczos_weights(pos[..., None] - tap_pos, a))
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


def _per_row(v):
    """A start or step as the JAX code broadcasts it, in float64 holding its
    f32 value: a tensor [...] gains a pixel axis; a host number stays a
    scalar (no upload)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).to(torch.float64)[..., None]
    return float(np.float32(v))


def affine_positions(x: torch.Tensor, start, step, num_out: int, lo: float, hi: float) -> torch.Tensor:
    """``clip(start[..., None] + p * step[..., None], lo, hi)`` in f32 on x's
    device, with ``start + p * step`` rounded once, as a fused multiply-add
    rounds it: under ``jit`` XLA contracts this expression into an FMA, and
    the JAX processor runs jitted. The product of two f32 values is exact in
    float64, so the sum is formed there and rounded to f32 (the kernel's own
    ``fmaf`` can differ from that by one ulp in a rare double-rounding tie)."""
    p = torch.arange(num_out, dtype=torch.float64, device=x.device)
    pos = (_per_row(start) + p * _per_row(step)).to(torch.float32)
    return torch.clamp(pos, lo, hi)


def banded_resample_affine_plain(
    x: torch.Tensor, start: torch.Tensor, step, num_out: int, lo: float, hi: float,
    *, a: int, kind: str, with_nearest: bool = False,
):
    """:func:`banded_resample_plain` at :func:`affine_positions`' tensor."""
    pos = affine_positions(x, start, step, num_out, lo, hi)
    return banded_resample_plain(x, pos, a=a, kind=kind, with_nearest=with_nearest)


# ---------------------------------------------------------------------------
# the kernel's Lanczos weights, in torch
# ---------------------------------------------------------------------------

INV_PI2 = float(np.float32(1.0 / math.pi**2))  # kInvPi2 in the CUDA source


@functools.lru_cache(maxsize=None)
def rotation_table(a: int) -> np.ndarray:
    """``cos(pi m / a)``, m = 0..a, then ``sin(pi m / a)``, m = 0..a: float64
    values rounded to f32, the table the kernel rotates ``sin(pi d / a)``
    by. A host array; the C entry copies it into the launch's arguments."""
    ang = np.pi * np.arange(a + 1, dtype=np.float64) / a
    table = np.concatenate([np.cos(ang), np.sin(ang)]).astype(np.float32)
    table.setflags(write=False)
    return table


def kernel_lanczos_weights(pos: torch.Tensor, a: int) -> torch.Tensor:
    """The weights of the taps ``floor(pos) - a + 1 .. floor(pos) + a`` as
    the CUDA kernel evaluates them, [..., 2a] f32 on the CPU.

    With n the sample nearest to pos and d = pos - n (exact, |d| <= 0.5) the
    samples n + m, |m| <= a, lie at t = d - m, and
    ``w = a sin(pi d) (-1)^m s2 / (pi^2 t^2)`` with
    ``s2 = sin(pi d / a) cos(pi m / a) - cos(pi d / a) sin(pi m / a)``
    rotated by :func:`rotation_table`; 1 where |t| < 1e-6 (m = 0 only), 0
    where |t| >= a (m = +-a only). The three trigonometric values are taken
    in float64 and rounded, standing in for ``sinpif`` and ``sincospif``;
    every other step is the kernel's f32 operation, its one fused
    multiply-add formed in float64. Of the 2a + 1 candidates the one outside
    the tap set (m = -a where d >= 0, m = +a where d < 0) is dropped."""
    table = torch.tensor(rotation_table(a))
    pos = pos.to(torch.float32).cpu()
    d = pos - torch.round(pos)  # rintf: ties to even
    m = torch.arange(-a, a + 1)
    cos_m = table[m.abs()]
    sin_m = torch.sign(m).to(torch.float32) * table[a + 1 + m.abs()]
    s1 = torch.sin(math.pi * d.double()).float()
    arg = math.pi * (d / np.float32(a)).double()
    sd, cd = torch.sin(arg).float()[..., None], torch.cos(arg).float()[..., None]
    k = (s1 * float(np.float32(a) * np.float32(INV_PI2)))[..., None]
    t = d[..., None] - m.to(torch.float32)
    s2 = (sd.double() * cos_m.double() - (cd * sin_m).double()).float()
    w = torch.where(m % 2 == 1, -k, k) * s2 * torch.reciprocal(t * t)
    w = torch.where((m == 0) & (t.abs() < 1e-6), 1.0, w)
    w = torch.where((m.abs() == a) & (t.abs() >= a), 0.0, w)
    first = torch.where(d < 0, 0, 1)[..., None]  # d < 0: n = floor(pos) + 1
    return torch.gather(w, -1, first + torch.arange(2 * a))


def kernel_lanczos_resample(x: torch.Tensor, pos: torch.Tensor, a: int) -> torch.Tensor:
    """The Lanczos resample with :func:`kernel_lanczos_weights` in place of
    the plain version's ``sinc`` products (CPU tensors)."""
    return _weighted_taps(x, _tap_positions(pos, a), kernel_lanczos_weights(pos, a))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _check_x(x: torch.Tensor, a: int, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"banded_resample: unknown kind {kind!r}")
    if not 1 <= a <= MAX_A:
        raise ValueError(f"banded_resample: a={a} outside [1, {MAX_A}]")
    if x.dtype != torch.float32:
        raise TypeError(f"banded_resample: x must be float32, got {x.dtype}")
    if x.ndim != 3 or x.shape[-1] < 1:
        raise ValueError(f"banded_resample: x must be [B, R, W], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("banded_resample: x must be contiguous")


def _check_rows(x: torch.Tensor, v: torch.Tensor, name: str, ndim: int) -> None:
    """``v`` is ``pos [B, P]`` or a per-pair ``start``/``step`` ``[B]``."""
    if v.dtype != torch.float32:
        raise TypeError(f"banded_resample: {name} must be float32, got {v.dtype}")
    if v.ndim != ndim or v.shape[0] != x.shape[0]:
        raise ValueError(
            f"banded_resample: {name} must be [B{', P' if ndim == 2 else ''}] for x "
            f"{tuple(x.shape)}, got {tuple(v.shape)}"
        )
    if not v.is_contiguous():
        raise ValueError(f"banded_resample: {name} must be contiguous")
    if v.device != x.device:
        raise ValueError(f"banded_resample: {name} on {v.device}, x on {x.device}")


@functools.lru_cache(maxsize=None)
def _rotation_address(a: int) -> int:
    """The host address of :func:`rotation_table`'s array (kept alive by
    that function's cache; ``ndarray.ctypes`` is slow to ask every launch)."""
    return rotation_table(a).ctypes.data


def _launch(entry: str, x: torch.Tensor, head: tuple, p: int, a: int, kind: str, with_nearest: bool):
    """Allocate the outputs (one buffer for both), launch ``entry`` on x's
    device and current stream, count the launch."""
    bsz, rows, w = x.shape
    buf = torch.empty((2 if with_nearest else 1, bsz, rows, p), dtype=torch.float32, device=x.device)
    if bsz * rows * p > 0:
        out = buf.data_ptr()
        _build.launch(
            entry, x.device, *head,
            out,
            out + 4 * bsz * rows * p if with_nearest else None,
            bsz, rows, w, p, a, KINDS[kind],
            _rotation_address(a) if kind == "lanczos" else None,
            name="banded_resample",
        )
        count("banded_resample.launches")
    return buf.unbind(0) if with_nearest else buf[0]


def banded_resample(
    x: torch.Tensor, pos: torch.Tensor, *, a: int, kind: str, with_nearest: bool = False
):
    """Resample x [B, R, W] at pos [B, P] -> [B, R, P] (and the nearest
    pick at the same positions with ``with_nearest``).

    CPU tensors take :func:`banded_resample_plain`; CUDA tensors launch
    ``csrc/banded_resample.cu`` (one thread per pair and pixel) or raise.
    """
    with span("kernel.banded_resample"):
        if x.device.type == "cpu":
            return banded_resample_plain(x, pos, a=a, kind=kind, with_nearest=with_nearest)
        if x.device.type != "cuda":
            raise ValueError(f"banded_resample: unsupported device {x.device}")
        _check_x(x, a, kind)
        _check_rows(x, pos, "pos", 2)
        return _launch("sig_banded_resample", x, (x.data_ptr(), pos.data_ptr()),
                       pos.shape[-1], a, kind, with_nearest)


def banded_resample_affine(
    x: torch.Tensor, start: torch.Tensor, step, num_out: int, lo: float, hi: float,
    *, a: int, kind: str, with_nearest: bool = False,
):
    """Resample x [B, R, W] at the positions
    ``clamp(start[b] + p * step[b], lo, hi)``, p = 0..num_out-1, rounded once
    -> [B, R, num_out] (and the nearest pick with ``with_nearest``).

    start [B] f32; step a host number (every pair's) or a tensor [B] f32.
    CPU tensors take :func:`banded_resample_affine_plain`; on a CUDA tensor
    the kernel forms the positions itself from a host ``step`` (the
    oscilloscope step's), and takes a tensor ``step`` (the JAX step's form,
    which no view of the port passes) through :func:`affine_positions` and
    the ``pos`` entry; or the call raises.
    """
    with span("kernel.banded_resample"):
        if x.device.type == "cpu":
            return banded_resample_affine_plain(
                x, start, step, num_out, lo, hi, a=a, kind=kind, with_nearest=with_nearest
            )
        if x.device.type != "cuda":
            raise ValueError(f"banded_resample: unsupported device {x.device}")
        _check_x(x, a, kind)
        _check_rows(x, start, "start", 1)
        if num_out < 0:
            raise ValueError(f"banded_resample: num_out={num_out}")
        if isinstance(step, torch.Tensor):
            _check_rows(x, step, "step", 1)
            pos = affine_positions(x, start, step, num_out, lo, hi)
            return _launch("sig_banded_resample", x, (x.data_ptr(), pos.data_ptr()), num_out, a, kind, with_nearest)
        head = (x.data_ptr(), start.data_ptr(), float(np.float32(step)), float(lo), float(hi))
        return _launch("sig_banded_resample_affine", x, head, num_out, a, kind, with_nearest)
