"""Peak-decay filtering as a plain sequential loop over time.

Counterpart of :mod:`signalizer_tpu.kernels.peak_decay`. The reference's
per-pixel peak filter (ref: cpl CPeakFilter usage at
Source/Spectrum/TransformDSP.inl:1336-1341) is the recurrence

    state[t] = max(pole * state[t-1], x[t])

— sequential in time, parallel across pixels/graphs/streams. The JAX
package evaluates it as an associative scan (the TPU has no cheap
sequential loop); here it is the plain loop over T, one vectorized step per
frame. On the magnitude path the display kernel
(:mod:`signalizer_tpu_torch.kernels.display_map`) runs the same loop per
thread, and this module is the plain version it is held against, as it is
for kernel G's PHASE tail (:mod:`~signalizer_tpu_torch.kernels.phase_decay_db`).
"""

from __future__ import annotations

from typing import Tuple

import torch


def peak_decay_step(state: torch.Tensor, x: torch.Tensor, pole) -> torch.Tensor:
    """One frame: ``max(pole * state, x)``."""
    return torch.maximum(pole * state, x)


def peak_decay_scan(
    state0: torch.Tensor, xs: torch.Tensor, pole, *, time_axis: int = None, valid=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the decay recurrence over a time-sequence of frames.

    Args:
      state0: initial state, shape ``S``.
      xs: new values with one extra time axis (``time_axis``, default 0);
        without it, ``xs``'s shape broadcasts against ``S``.
      pole: decay coefficient(s), broadcastable against ``state0``.
      valid: optional [T] bool; ``False`` frames leave the state unchanged
        (host-side padding for bucketed batch shapes).

    Returns ``(decayed, final_state)``: ``decayed`` holds the post-update
    state per frame, with the time axis where ``xs`` has it.
    """
    if time_axis is None:
        if xs.ndim != state0.ndim + 1:
            raise ValueError("xs must have exactly one more axis than state0")
        time_axis = 0
    time_axis = time_axis % xs.ndim

    t = torch.movedim(xs, time_axis, 0)
    pole = torch.as_tensor(pole, dtype=t.dtype, device=t.device)
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=t.device)
    s = state0
    outs = []
    for i in range(t.shape[0]):
        new = peak_decay_step(s, t[i], pole)
        s = new if valid is None else torch.where(valid[i], new, s.expand_as(new))
        outs.append(s)
    decayed = torch.stack(outs, dim=0)
    return torch.movedim(decayed, 0, time_axis), s
