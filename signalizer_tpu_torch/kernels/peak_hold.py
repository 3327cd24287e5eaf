"""Kernel D: the envelope-hold trigger's scan.

Replaces the ``lax.scan`` of
``signalizer_tpu/kernels/oscilloscope.py::peak_hold_triggers`` (ref:
PeakHoldProcessor, StreamPreprocessing.h:270-312). The CUDA source is
``signalizer_tpu_torch/csrc/peak_hold.cu``, one templated kernel with two
entries, and this module holds their wrappers and plain versions:

* :func:`peak_hold_triggers` (fires, state, holding), the counterpart of
  the JAX function, and :func:`peak_hold_triggers_plain`, a Python loop
  over the consumed samples with a few torch operations a sample (the CPU
  path, and what the kernel is held to bit for bit on the card);
* :func:`envelope_hold_trigger`, the oscilloscope step's whole
  ENVELOPE_HOLD trigger in one launch (the scan, the fire-age queue and the
  window start; nothing as wide as the region is written), and
  :func:`envelope_hold_trigger_plain`, the plain scan followed by the torch
  operations the step used to run on its fires.

The samples consumed are those at or after ``first`` that ``valid`` marks
(all of them without a mask). The oscilloscope step consumes a suffix of
its region, so it passes ``first`` as a host int: the kernel's launch then
uploads nothing and reads nothing back. A mask goes to the kernel as a
device tensor.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from signalizer_tpu_torch.kernels import _build
from signalizer_tpu_torch.utils.diagnostics import count, span

PEAK_DECAY = 0.9999  # ref: StreamPreprocessing.h:291
PEAK_QUEUE_SIZE = 8  # pending envelope-hold fires tracked across steps
# (the reference's TriggeringProcessor peak queue, StreamPreprocessing.h:78)
FIRE_AGE_NONE = 1.0e9  # sentinel age for an empty queue slot
F32 = np.float32

# kernel launches by either entry count in the diagnostics registry as
# peak_hold.launches


def _initial(x: torch.Tensor, threshold, state, holding):
    if state is None:
        state = torch.full(x.shape[:-1], 1.0, dtype=x.dtype, device=x.device) * (threshold * threshold)
    if holding is None:
        holding = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    return state, holding


def _shift(fires: torch.Tensor) -> torch.Tensor:
    """The fire marks "first sample that no longer qualifies"; the event
    timestamp is the previous sample (ref: peaks.push(... - 1)); a fall at
    sample 0 stays at sample 0 (the JAX package's boundary clamp)."""
    boundary = fires[..., 0]
    shifted = torch.cat([fires[..., 1:], torch.zeros_like(fires[..., :1])], dim=-1)
    shifted[..., 0] |= boundary
    return shifted


def peak_hold_triggers_plain(
    x: torch.Tensor,
    threshold,
    hysteresis,
    state: torch.Tensor = None,
    holding: torch.Tensor = None,
    decay: float = PEAK_DECAY,
    valid=None,
    first: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel D: the recurrence, one sample at a
    time, over the consumed samples only (see :func:`peak_hold_triggers`)."""
    sq = x * x
    w = x.shape[-1]
    state, holding = _initial(x, threshold, state, holding)
    thr2 = torch.as_tensor(threshold * threshold, dtype=x.dtype, device=x.device)
    if valid is None:
        consumed = range(max(first, 0), w)
    else:
        v = torch.as_tensor(valid, dtype=torch.bool).cpu().expand(w).tolist()
        consumed = [i for i in range(max(first, 0), w) if v[i]]
    st, hold = state, holding
    fires = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for i in consumed:
        s = sq[..., i]
        delta = s - st
        falling = delta < 0
        fires[..., i] = falling & hold
        hold = ~falling & (hold | (delta > hysteresis * st))
        st = torch.where(falling, torch.maximum(thr2, st * decay), s)
    return _shift(fires), st, hold


def _scalar(v, name: str, dev: torch.device):
    """A device scalar's pointer, or None for a host number."""
    if not isinstance(v, torch.Tensor):
        return None
    if v.numel() != 1 or v.dtype != torch.float32 or v.device != dev:
        raise ValueError(f"peak_hold_triggers: {name} must be a float32 scalar on {dev}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")
    return v.data_ptr()


def peak_hold_triggers(
    x: torch.Tensor,
    threshold,
    hysteresis,
    state: torch.Tensor = None,
    holding: torch.Tensor = None,
    decay: float = PEAK_DECAY,
    valid=None,
    first: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Envelope-hold trigger events (ref: PeakHoldProcessor,
    StreamPreprocessing.h:270-312).

    Squared-sample peak tracker: while rising, arm when the jump exceeds
    ``hysteresis * state``; on the first fall, fire the previous sample and
    decay the held state by 0.9999 (floored at threshold^2).

    Samples before ``first`` (a host int) and those ``valid`` ([W] bools,
    host or device) leaves unmarked are not consumed: identity steps (state
    unchanged, no fire). ``threshold`` and ``hysteresis`` are host numbers
    or float32 scalars on x's device.

    x [..., W] -> (fires bool [..., W], state [...], holding [...]).

    CPU tensors take :func:`peak_hold_triggers_plain`; CUDA tensors launch
    ``csrc/peak_hold.cu`` (one block a row) or raise.
    """
    with span("kernel.peak_hold"):
        if x.device.type == "cpu":
            return peak_hold_triggers_plain(x, threshold, hysteresis, state, holding, decay, valid, first)
        if x.device.type != "cuda":
            raise ValueError(f"peak_hold_triggers: unsupported device {x.device}")
        if x.dtype != torch.float32 or x.ndim < 1 or x.shape[-1] < 1:
            raise ValueError(f"peak_hold_triggers: x must be float32 [..., W>=1], got {x.dtype} {tuple(x.shape)}")
        dev = x.device
        w = x.shape[-1]
        lead = x.shape[:-1]
        state, holding = _initial(x, threshold, state, holding)
        if state.shape != lead or holding.shape != lead:
            raise ValueError(f"peak_hold_triggers: state {tuple(state.shape)} and holding "
                             f"{tuple(holding.shape)} must be {tuple(lead)}")
        if state.dtype != torch.float32 or holding.dtype != torch.bool:
            raise ValueError("peak_hold_triggers: state must be float32 and holding bool")
        if state.device != dev or holding.device != dev:
            raise ValueError(f"peak_hold_triggers: state and holding must be on {dev}")
        rows2d = x.reshape(-1, w) if x.ndim != 2 else x
        if rows2d.stride(-1) != 1:
            rows2d = rows2d.contiguous()
        rows = rows2d.shape[0]
        state_in, holding_in = state.contiguous(), holding.contiguous()
        if valid is not None:
            valid = torch.as_tensor(valid, dtype=torch.bool).to(dev).expand(w).contiguous()
        thr_ptr = _scalar(threshold, "threshold", dev)
        hyst_ptr = _scalar(hysteresis, "hysteresis", dev)
        # host numbers: the plain version's f32 values (thr^2 formed in float64
        # and rounded once, as torch.as_tensor(threshold * threshold) forms it)
        thr2 = 0.0 if thr_ptr is not None else float(np.float32(threshold * threshold))
        hyst = 0.0 if hyst_ptr is not None else float(np.float32(hysteresis))
        fires = torch.empty(x.shape, dtype=torch.bool, device=dev)
        state_out = torch.empty_like(state_in)
        holding_out = torch.empty_like(holding_in)
        if rows > 0:
            stride = rows2d.stride(0) if rows > 1 else w
            _build.launch(
                "sig_peak_hold", dev, rows2d.data_ptr(), stride, None if valid is None else valid.data_ptr(),
                state_in.data_ptr(), holding_in.data_ptr(), thr_ptr, hyst_ptr, thr2, hyst, float(np.float32(decay)),
                state_out.data_ptr(), holding_out.data_ptr(), fires.data_ptr(), rows, w, max(int(first), 0),
                name="peak_hold_triggers",
            )
            count("peak_hold.launches")
        return fires, state_out, holding_out


def window_start(found, trigger_pos, hf, window):
    """Center the window on the trigger, clamp it into the history, and
    show the newest window where no trigger was found."""
    start = trigger_pos - float((window - F32(1.0)) * F32(0.5))
    start = torch.clamp(start, 0.0, float(hf - window))
    return torch.where(found, start, float(hf - window))


def envelope_hold_trigger_plain(
    region: torch.Tensor,
    threshold,
    hysteresis,
    state: torch.Tensor,
    holding: torch.Tensor,
    fire_ages: torch.Tensor,
    *,
    first: int,
    new_samples,
    window,
    hf,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`envelope_hold_trigger`: the scan of
    :func:`peak_hold_triggers_plain`, then the queue merge and the window
    start as torch operations on its fires."""
    chunk = region.shape[-1]
    dev = region.device
    new_samples, window, hf = F32(new_samples), F32(window), F32(hf)
    fires, new_state, new_holding = peak_hold_triggers_plain(
        region, threshold, hysteresis, state, holding, first=first
    )
    idx = torch.arange(chunk, dtype=torch.float32, device=dev)
    age = (chunk - 1.0) - idx  # age relative to the history end
    cand = torch.where(fires, age, FIRE_AGE_NONE)  # [pairs, chunk]
    k_new = min(PEAK_QUEUE_SIZE, chunk)
    newest = torch.topk(cand, k_new, dim=-1, largest=False, sorted=True).values
    carried = torch.clamp(fire_ages + float(new_samples), max=FIRE_AGE_NONE)
    merged = torch.cat([newest, carried], dim=-1)
    new_fire_ages = torch.topk(merged, PEAK_QUEUE_SIZE, dim=-1, largest=False, sorted=True).values
    # newest fire with its half window complete, still inside history
    mature = (new_fire_ages >= float(window * F32(0.5) - F32(1.0))) & (new_fire_ages < float(hf))
    age_sel = torch.amin(torch.where(mature, new_fire_ages, FIRE_AGE_NONE), dim=-1)
    found = age_sel < FIRE_AGE_NONE
    trigger_pos = float(hf - F32(1.0)) - torch.where(found, age_sel, 0.0)
    start = window_start(found, trigger_pos, hf, window)
    return new_state, new_holding, new_fire_ages, found, start


def envelope_hold_trigger(
    region: torch.Tensor,
    threshold,
    hysteresis,
    state: torch.Tensor,
    holding: torch.Tensor,
    fire_ages: torch.Tensor,
    *,
    first: int,
    new_samples,
    window,
    hf,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The oscilloscope step's ENVELOPE_HOLD trigger (ref:
    StreamPreprocessing.h:270-312): scan the region's consumed suffix (the
    samples at or after ``first``), keep the newest
    ``PEAK_QUEUE_SIZE`` fire ages (those of this region and the carried
    ones, older by ``new_samples``), and place the window on the newest
    fire whose half window is complete.

    ``region`` [pairs, chunk] f32 (unit stride within a row); ``state``
    [pairs] f32, ``holding`` [pairs] bool, ``fire_ages`` [pairs,
    PEAK_QUEUE_SIZE] f32 (ascending, ``FIRE_AGE_NONE`` for an empty slot);
    ``threshold`` and ``hysteresis`` host numbers or float32 scalars on the
    region's device; ``first`` a host int; ``new_samples``, ``window`` and
    ``hf`` (the history length) host numbers, used as float32.

    Returns (state, holding, fire_ages, found [pairs] bool, start [pairs]
    f32). CPU tensors take :func:`envelope_hold_trigger_plain`; CUDA
    tensors launch ``csrc/peak_hold.cu``'s fused entry (one launch, no
    host-device copy) or raise.
    """
    with span("kernel.peak_hold"):
        if region.device.type == "cpu":
            return envelope_hold_trigger_plain(
                region, threshold, hysteresis, state, holding, fire_ages,
                first=first, new_samples=new_samples, window=window, hf=hf,
            )
        if region.device.type != "cuda":
            raise ValueError(f"envelope_hold_trigger: unsupported device {region.device}")
        if region.dtype != torch.float32 or region.ndim != 2 or region.shape[-1] < 1:
            raise ValueError(f"envelope_hold_trigger: region must be float32 [pairs, chunk>=1], got "
                             f"{region.dtype} {tuple(region.shape)}")
        dev = region.device
        pairs, chunk = region.shape
        if state.shape != (pairs,) or holding.shape != (pairs,) or fire_ages.shape != (pairs, PEAK_QUEUE_SIZE):
            raise ValueError(f"envelope_hold_trigger: state {tuple(state.shape)}, holding {tuple(holding.shape)} "
                             f"and fire_ages {tuple(fire_ages.shape)} must be ({pairs},), ({pairs},) and "
                             f"({pairs}, {PEAK_QUEUE_SIZE})")
        if state.dtype != torch.float32 or holding.dtype != torch.bool or fire_ages.dtype != torch.float32:
            raise ValueError("envelope_hold_trigger: state and fire_ages must be float32 and holding bool")
        if state.device != dev or holding.device != dev or fire_ages.device != dev:
            raise ValueError(f"envelope_hold_trigger: state, holding and fire_ages must be on {dev}")
        rows = region if region.stride(-1) == 1 else region.contiguous()
        state_in, holding_in, ages_in = state.contiguous(), holding.contiguous(), fire_ages.contiguous()
        thr_ptr = _scalar(threshold, "threshold", dev)
        hyst_ptr = _scalar(hysteresis, "hysteresis", dev)
        thr2 = 0.0 if thr_ptr is not None else float(np.float32(threshold * threshold))
        hyst = 0.0 if hyst_ptr is not None else float(np.float32(hysteresis))
        # the host numbers as f32 values, each formed as the plain version forms it
        new_samples, window, hf = F32(new_samples), F32(window), F32(hf)
        state_out = torch.empty_like(state_in)
        holding_out = torch.empty_like(holding_in)
        ages_out = torch.empty_like(ages_in)
        found = torch.empty((pairs,), dtype=torch.bool, device=dev)
        start = torch.empty((pairs,), dtype=torch.float32, device=dev)
        if pairs > 0:
            stride = rows.stride(0) if pairs > 1 else chunk
            _build.launch(
                "sig_envelope_hold", dev, rows.data_ptr(), stride, state_in.data_ptr(), holding_in.data_ptr(),
                ages_in.data_ptr(), thr_ptr, hyst_ptr, thr2, hyst, float(np.float32(PEAK_DECAY)), float(new_samples),
                float(window * F32(0.5) - F32(1.0)), float(hf), float(hf - F32(1.0)),
                float((window - F32(1.0)) * F32(0.5)), float(hf - window), state_out.data_ptr(),
                holding_out.data_ptr(), ages_out.data_ptr(), found.data_ptr(), start.data_ptr(), pairs, chunk,
                min(max(int(first), 0), chunk), name="envelope_hold_trigger",
            )
            count("peak_hold.launches")
        return state_out, holding_out, ages_out, found, start
