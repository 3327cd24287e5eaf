"""Kernel H: the resonator bank's chunk recurrence and its readout.

Replaces the ``lax.scan`` of
``signalizer_tpu/kernels/resonator.py:274-315`` (``resonate_chunks``: the
T-step recurrence ``z <- z * c^W + drive_t`` on (re, im) pairs, a valid
mask, the magnitude readout after each chunk when asked) and the windowed
readout of the final state (``resonator_readout_complex``). The drives stay
one float32 matrix product in torch
(:func:`~signalizer_tpu_torch.kernels.resonator.resonate_chunks`). The CUDA
source is ``signalizer_tpu_torch/csrc/resonator_scan.cu``; this module holds
its wrapper, :func:`resonator_scan`, and its plain version,
:func:`resonator_scan_plain`, the loop over T that ran in
``resonate_chunks`` before, which the CPU runs and the kernel is held to.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from signalizer_tpu_torch.kernels import _build
from signalizer_tpu_torch.stream.pinned import device_mask
from signalizer_tpu_torch.utils.diagnostics import count, span

# the vector counts the kernel takes: 2K + 1 for a cosine-sum window of order
# K <= 4 (csrc/resonator_scan.cu's instantiations)
VECTORS = (1, 3, 5, 7, 9)
# kernel launches count in the diagnostics registry as resonator_scan.launches


class ScanResult(NamedTuple):
    """The bank after T chunks: ``state`` [..., P, V, 2]; the final state's
    windowed readout ``re``, ``im`` [..., P] (gain applied) and its
    ``magnitude``; ``readouts`` [T, ..., P], the magnitude after every
    chunk, or ``None`` when not asked for."""

    state: torch.Tensor
    re: torch.Tensor
    im: torch.Tensor
    magnitude: torch.Tensor
    readouts: Optional[torch.Tensor]


def readout_complex_plain(
    state: torch.Tensor, combine: torch.Tensor, gain: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed complex readout of ``state`` [..., P, V, 2]: the vectors
    combined with ``combine`` [V] (an elementwise product and a sum), times
    ``gain`` [P]; returns (re, im) [..., P]."""
    z = (state * combine[:, None]).sum(-2)  # [..., P, 2]
    return z[..., 0] * gain, z[..., 1] * gain


def _magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(re * re + im * im)


def _advance(state: torch.Tensor, drive: torch.Tensor, decay_re, decay_im) -> torch.Tensor:
    """z * c^W + drive on (re, im) pairs."""
    zr, zi = state[..., 0], state[..., 1]
    return torch.stack(
        [zr * decay_re - zi * decay_im + drive[..., 0], zr * decay_im + zi * decay_re + drive[..., 1]],
        dim=-1,
    )


def _host_steps(valid, t: int) -> np.ndarray:
    steps = np.ones(t, bool) if valid is None else np.asarray(
        valid.cpu() if isinstance(valid, torch.Tensor) else valid, bool).reshape(-1)
    if steps.shape[0] != t:
        raise ValueError(f"valid has {steps.shape[0]} entries for T={t}")
    return steps


def resonator_scan_plain(
    state: torch.Tensor,
    drives: torch.Tensor,
    decay_re: torch.Tensor,
    decay_im: torch.Tensor,
    combine: torch.Tensor,
    gain: torch.Tensor,
    valid=None,
    emit_readouts: bool = False,
) -> ScanResult:
    """Plain PyTorch version of :func:`resonator_scan`: the recurrence as a
    loop over T that skips the chunks ``valid`` marks False (read on the
    host), a readout after each chunk when asked, and the final readout."""
    t = drives.shape[-4]
    steps = _host_steps(valid, t)
    ys = []
    for i in range(t):
        if steps[i]:
            state = _advance(state, drives[..., i, :, :, :], decay_re, decay_im)
        if emit_readouts:
            ys.append(_magnitude(*readout_complex_plain(state, combine, gain)))
    re, im = readout_complex_plain(state, combine, gain)
    return ScanResult(state, re, im, _magnitude(re, im), torch.stack(ys, dim=0) if emit_readouts else None)


def resonator_scan(
    state: torch.Tensor,
    drives: torch.Tensor,
    decay_re: torch.Tensor,
    decay_im: torch.Tensor,
    combine: torch.Tensor,
    gain: torch.Tensor,
    valid=None,
    emit_readouts: bool = False,
) -> ScanResult:
    """Advance the bank ``state`` [..., P, V, 2] f32 over the drives
    ``drives`` [..., T, P, V, 2] (``sum_n c^(W-1-n) x_t[n]`` of each chunk)
    with ``decay_re``, ``decay_im`` [P, V] (``c^W``), skipping the chunks
    ``valid`` (optional [T] bool, host values or a tensor) marks False, and
    read the bank out with ``combine`` [V] and ``gain`` [P]. ``state`` is
    not modified. CPU tensors take :func:`resonator_scan_plain`; CUDA
    tensors launch ``sig_resonator_scan`` of ``csrc/resonator_scan.cu`` once
    (a host mask goes up through a pinned buffer: no sync) or raise."""
    with span("kernel.resonator_scan"):
        if drives.device.type == "cpu":
            return resonator_scan_plain(state, drives, decay_re, decay_im, combine, gain, valid, emit_readouts)
        dev = drives.device
        if drives.device.type != "cuda" or drives.ndim < 4 or drives.shape[-1] != 2:
            raise ValueError(
                f"resonator_scan: drives must be [..., T, P, V, 2] on a GPU, got {tuple(drives.shape)} on {dev}"
            )
        t, p, v = drives.shape[-4], drives.shape[-3], drives.shape[-2]
        lead = tuple(drives.shape[:-4])
        if v not in VECTORS:
            raise ValueError(f"resonator_scan: {v} vectors, the kernel takes {VECTORS}")
        for name, x, shape in (("state", state, lead + (p, v, 2)), ("decay_re", decay_re, (p, v)),
                               ("decay_im", decay_im, (p, v)), ("combine", combine, (v,)), ("gain", gain, (p,))):
            if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != dev:
                raise ValueError(f"resonator_scan: {name} must be float32 {shape} on {dev}, "
                                 f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if drives.dtype != torch.float32:
            raise TypeError("resonator_scan: drives must be float32")
        drives, state = drives.contiguous(), state.contiguous()
        # the plan's c^W is one [P, V, 2] tensor: its re and im views are read
        # in place, 2 floats apart
        stride = decay_re.stride(-1)
        if not (stride in (1, 2) and decay_re.stride() == decay_im.stride() == (v * stride, stride)):
            decay_re, decay_im, stride = decay_re.contiguous(), decay_im.contiguous(), 1
        b = 1
        for d in lead:
            b *= d
        state_out = torch.empty_like(state)
        re, im, mag = (torch.empty(lead + (p,), dtype=torch.float32, device=dev) for _ in range(3))
        readouts = torch.empty((t,) + lead + (p,), dtype=torch.float32, device=dev) if emit_readouts else None
        if b == 0 or p == 0:
            return ScanResult(state_out, re, im, mag, readouts)
        mask = None if valid is None else device_mask(valid, t, dev)
        _build.launch(
            "sig_resonator_scan", dev, state.data_ptr(), drives.data_ptr(), decay_re.data_ptr(), decay_im.data_ptr(),
            None if mask is None else mask.data_ptr(), combine.contiguous().data_ptr(), gain.contiguous().data_ptr(),
            state_out.data_ptr(), re.data_ptr(), im.data_ptr(), mag.data_ptr(),
            None if readouts is None else readouts.data_ptr(), b, t, p, v, stride, name="resonator_scan",
        )
        count("resonator_scan.launches")
        return ScanResult(state_out, re, im, mag, readouts)
