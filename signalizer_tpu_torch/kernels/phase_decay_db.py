"""Kernel G: the Spectrum's PHASE display tail.

Replaces the compiled loops of ``post_process``'s PHASE branch
(``signalizer_tpu/kernels/spectrum.py:551-584``): the mid row's peak decay
(``peak_decay_scan``, a ``lax.associative_scan``), the one-pole phase
smoothing toward ``cancel * mag`` with ``pole ** 0.3`` (a ``lax.scan``), and
the dB map of both rows (ref: TransformDSP.inl:1336-1341, :1395-1419). The
CUDA source is ``signalizer_tpu_torch/csrc/phase_decay_db.cu``; this module
holds its wrapper, :func:`phase_decay_db`, and its plain version,
:func:`phase_decay_db_plain`, the loops over T that ran in ``post_process``
before, which the CPU runs and the kernel is held to.
"""

from __future__ import annotations

import functools
import weakref

import torch

from signalizer_tpu_torch.core.constant import SpectrumConstant
from signalizer_tpu_torch.kernels import _build
from signalizer_tpu_torch.kernels.display_map import _db_map, _multiprocessors
from signalizer_tpu_torch.kernels.peak_decay import peak_decay_scan
from signalizer_tpu_torch.stream.pinned import device_mask
from signalizer_tpu_torch.utils.diagnostics import count, span

# kernel launches count in the diagnostics registry as phase_decay_db.launches:
# one a wrapper call, of one or two kernels
# the kernel's layout (csrc/phase_decay_db.cu kTile, kGroup, kWalkFrames): a
# block is TILE pixels of a pair and up to GROUP line graphs over a chunk of
# T; T in more than one chunk takes a walk pass first, WALK_FRAMES frames a
# stage, so a chunk is a multiple of it
TILE = 32
GROUP = 8
WALK_FRAMES = 32


@functools.lru_cache(maxsize=None)
def phase_plan(pairs: int, t: int, k: int, p: int, sms: int) -> tuple:
    """``(frames a chunk, chunks)`` for the kernel on ``vals`` [pairs, t, 2,
    p] with ``k`` line graphs on a card of ``sms`` multiprocessors: all of T
    in one chunk (one launch) where the pixel tiles, line-graph groups and
    pairs give two blocks an SM or more, else T halved until they do, each
    chunk a multiple of WALK_FRAMES frames (a walk pass first writes each
    chunk's start)."""
    blocks = -(-p // TILE) * -(-k // GROUP) * pairs
    chunks = 1
    while blocks * chunks < 2 * sms and 2 * chunks * WALK_FRAMES <= t:
        chunks *= 2
    if chunks == 1:
        return t, 1
    frames = -(-t // (chunks * WALK_FRAMES)) * WALK_FRAMES
    return frames, -(-t // frames)


_phase_poles = weakref.WeakKeyDictionary()  # constant -> its phase poles, formed once


def phase_poles(constant: SpectrumConstant) -> torch.Tensor:
    """The phase smoothing's poles [K, 1]: the decay poles to the power 0.3,
    by one torch expression for both versions, so that they share its
    rounding; formed once a constant, on its device."""
    pp = _phase_poles.get(constant)
    if pp is None:
        pp = _phase_poles[constant] = constant.decay_poles[:, None] ** 0.3
    return pp


def phase_decay_db_plain(constant: SpectrumConstant, state, vals: torch.Tensor, valid=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`phase_decay_db`: the decay loop
    (:func:`~signalizer_tpu_torch.kernels.peak_decay.peak_decay_scan`) on the
    halved mid row, the smoothing loop over T, the dB map of both rows."""
    poles = constant.decay_poles  # [K]
    seq = vals[..., :, None, :, :]  # [..., T, 1, rows, P]
    mag_seq = seq[..., 0:1, :] * 0.5  # ref: consts::half at :1407
    cancel_seq = seq[..., 1:2, :]
    decayed, new_mag_state = peak_decay_scan(
        state.magnitude[..., 0:1, :], mag_seq, poles[:, None, None],
        time_axis=-4, valid=valid,
    )
    # phase smoothing: one-pole toward (cancel * mag) with pole^0.3
    # (ref: TransformDSP.inl:1395-1419)
    target = torch.movedim(cancel_seq[..., 0, :] * mag_seq[..., 0, :], -3, 0)  # [T, ..., K, P]
    pp = phase_poles(constant)
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=vals.device)
    carry = state.phase
    phases = []
    for t in range(target.shape[0]):
        out = target[t] + pp * (carry - target[t])
        carry = out if valid is None else torch.where(valid[t], out, carry)
        phases.append(carry)
    phases = torch.stack(phases, dim=-3)  # [..., T, K, P]
    mag_db = _db_map(constant, decayed[..., 0, :])
    phase_db = _db_map(constant, phases)
    results = torch.stack([mag_db, phase_db], dim=-2)  # [..., T, K, rows=2, P]
    state.magnitude[..., 0:1, :] = new_mag_state
    state.phase.copy_(carry)
    return results


def phase_decay_db(constant: SpectrumConstant, state, vals: torch.Tensor, valid=None) -> torch.Tensor:
    """The PHASE tail: values ``vals`` [..., T, 2, P] f32 (the mid magnitude
    and the cancellation, from ``spectrum_values``) against the
    :class:`~signalizer_tpu_torch.kernels.spectrum.LineGraphState` ``state``
    (``magnitude`` [..., K, rows, P], of which only row 0 is read and
    written; ``phase`` [..., K, P]), both updated in place; ``valid``
    (optional [T] bool, host values or a tensor on the values' device)
    marks padded frames that leave the states untouched. Returns
    [..., T, K, 2, P]. CPU tensors take :func:`phase_decay_db_plain`; CUDA
    tensors launch ``sig_phase_decay_db`` of ``csrc/phase_decay_db.cu`` once
    (a host mask goes up through a pinned buffer: no sync), T in the
    chunks of :func:`phase_plan` (one kernel for one chunk; a walk pass
    first for more), or raise."""
    with span("kernel.phase_decay_db"):
        if vals.device.type == "cpu":
            return phase_decay_db_plain(constant, state, vals, valid)
        c = constant
        k, p = c.num_line_graphs, c.axis_points
        if vals.device.type != "cuda" or c.device != vals.device:
            raise ValueError(f"phase_decay_db: values on {vals.device}, constant on {c.device}")
        if vals.dtype != torch.float32 or vals.ndim < 3 or vals.shape[-2:] != (2, p):
            raise ValueError(
                f"phase_decay_db: values must be float32 [..., T, 2, {p}], got {vals.dtype} {tuple(vals.shape)}"
            )
        vals = vals.contiguous()
        lead, t = tuple(vals.shape[:-3]), vals.shape[-3]
        mag, ph = state.magnitude, state.phase
        rows = mag.shape[-2] if mag.ndim >= 2 else 0
        for name, x, shape in (("magnitude", mag, lead + (k, rows, p)), ("phase", ph, lead + (k, p))):
            if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous() or x.device != vals.device:
                raise ValueError(f"phase_decay_db: state.{name} must be contiguous float32 {shape} on {vals.device}, "
                                 f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if rows < 1:
            raise ValueError("phase_decay_db: state.magnitude has no row")
        out = torch.empty(lead + (t, k, 2, p), dtype=torch.float32, device=vals.device)
        if out.numel() == 0:
            return out
        pairs = 1
        for d in lead:
            pairs *= d
        dev = vals.device.index if vals.device.index is not None else torch.cuda.current_device()
        frames, chunks = phase_plan(pairs, t, k, p, _multiprocessors(dev))
        starts = None
        if chunks > 1:
            starts = torch.empty((pairs, chunks, k, 2, p), dtype=torch.float32, device=vals.device)
        v = None if valid is None else device_mask(valid, t, vals.device)
        pp = phase_poles(c)
        _build.launch(
            "sig_phase_decay_db", vals.device, vals.data_ptr(), c.slope_map.data_ptr(), c.decay_poles.data_ptr(),
            pp.data_ptr(), c.display_scalars.data_ptr(), None if v is None else v.data_ptr(), mag.data_ptr(),
            ph.data_ptr(), out.data_ptr(), None if starts is None else starts.data_ptr(), pairs, t, k, rows, p,
            frames, name="phase_decay_db",
        )
        count("phase_decay_db.launches")
        return out
