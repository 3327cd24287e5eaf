"""SpectrumProcessor and ResonatorSpectrumProcessor — the stateful public
faces of the spectrum view.

Counterpart of :mod:`signalizer_tpu.views.spectrum` (ref:
Source/Spectrum/Spectrum.h, SpectrumDSP.cpp:61-227): each owns the constant,
carries the per-pair filter states across calls on one device, and exposes
the batched step: :class:`SpectrumProcessor` the FFT path,
:class:`ResonatorSpectrumProcessor` the resonator bank (RSNT, ref:
TransformDSP.inl:1213-1295 resonatingDispatch). Rendering is out of scope —
outputs are render-ready tensors.

* ``pairs``: channel pairs analyzed in parallel (the reference's
  ``parallel_for`` over pairs, SpectrumDSP.cpp:83) — the batch axis.
* ``process(frames)`` with frames ``[pairs, T, 2, window]`` treats T as
  time-sequential (decay state threads through) and pairs as parallel.
"""

from __future__ import annotations

import numpy as np
import torch

from signalizer_tpu_torch.core.config import SpectrumChannels
from signalizer_tpu_torch.core.constant import (
    SpectrumConstant,
    resolve_device,
    make_spectrum_constant,
)
from signalizer_tpu_torch.core.windows import WindowType
from signalizer_tpu_torch.kernels.resonator import (
    ResonatorBlockPlan,
    ResonatorConstant,
    init_resonator_state,
    make_block_plan,
    make_resonator_constant,
    resonate_and_read,
)
from signalizer_tpu_torch.kernels.spectrum import (
    LineGraphState,
    analyze_frames,
    init_line_graph_state,
    post_process,
    stitch_preliminary,
)
from signalizer_tpu_torch.utils.diagnostics import span


class SpectrumProcessor:
    """Stateful wrapper: constant + carried decay state on one device."""

    def __init__(self, constant: SpectrumConstant, pairs: int = 1):
        self.constant = constant
        self.pairs = pairs
        self._state = init_line_graph_state(constant, (pairs,))

    @classmethod
    def create(cls, *, pairs: int = 1, device=None, **constant_kwargs) -> "SpectrumProcessor":
        """Build the constant on ``device`` and a processor for ``pairs``
        channel pairs. ``device=None`` is the GPU; it raises when no GPU is
        available, and the CPU is used only for ``device="cpu"``."""
        device = resolve_device(device)
        return cls(make_spectrum_constant(device=device, **constant_kwargs), pairs=pairs)

    @property
    def device(self) -> torch.device:
        return self.constant.device

    @property
    def state(self) -> LineGraphState:
        """Current decay state. ``process`` updates these tensors in place
        (the JAX step donated them): clone before processing again to keep
        a snapshot."""
        return self._state

    def reset(self) -> None:
        """Clear filter states (ref: resetState semantics)."""
        self._state = init_line_graph_state(self.constant, (self.pairs,))

    def reconfigure(self, constant: SpectrumConstant) -> None:
        """Swap the constant (ref: handleFlagUpdates rebuild,
        Spectrum.cpp:351-616). Resets state when shapes or the device
        changed."""
        same_shape = (
            constant.axis_points == self.constant.axis_points
            and constant.state_channels == self.constant.state_channels
            and constant.num_line_graphs == self.constant.num_line_graphs
            and constant.device == self.constant.device
        )
        self.constant = constant
        if not same_shape:
            self.reset()

    def _frames(self, frames) -> torch.Tensor:
        with span("ring.frames"):
            if isinstance(frames, np.ndarray):
                frames = torch.from_numpy(np.ascontiguousarray(frames, dtype=np.float32))
            return torch.as_tensor(frames, dtype=torch.float32).to(self.device).contiguous()

    def process(self, frames) -> torch.Tensor:
        """frames [pairs, T, 2, window] (or [pairs, 2, window] for one step),
        numpy or tensor -> display results [pairs, T, K, rows, P] on the
        processor's device; decay state carries across calls."""
        with span("spectrum.process"):
            frames = self._frames(frames)
            if frames.ndim == 3:  # [pairs, C, W] -> single time step
                frames = frames[:, None]
            return analyze_frames(self.constant, self._state, frames).results

    def process_to_host(self, frames) -> np.ndarray:
        return self.process(frames).cpu().numpy()

    def process_with_preliminary(self, history, preliminary, num_samples: int = None) -> torch.Tensor:
        """Analyze one frame stitched from retained history plus the raw
        in-flight block of the current audio callback (the reference's
        preliminary-audio path, TransformDSP.inl:233-484). ``history``
        [pairs, 2, H] newest-last, ``preliminary`` [pairs, 2, S]; returns
        display results [pairs, 1, K, rows, P]."""
        frame = stitch_preliminary(
            self.constant, self._frames(history), self._frames(preliminary), num_samples
        )
        return self.process(frame[:, None])


# ---------------------------------------------------------------------------
# RSNT algorithm path (ref: TransformDSP.inl:1213-1295 resonatingDispatch)
# ---------------------------------------------------------------------------


def _mix_rsnt(cfg: SpectrumChannels, block: torch.Tensor) -> torch.Tensor:
    """[pairs, 2, ...] -> [pairs, rows, ...] per resonatingDispatch
    (ref: TransformDSP.inl:1213-1295; the RSNT path does NOT halve
    Mid/Side, unlike prepareTransform)."""
    left, right = block[:, 0], block[:, 1]
    if cfg == SpectrumChannels.LEFT:
        return left[:, None]
    if cfg == SpectrumChannels.RIGHT:
        return right[:, None]
    if cfg == SpectrumChannels.MERGE:
        return (left + right)[:, None]
    if cfg == SpectrumChannels.SIDE:
        return (left - right)[:, None]
    if cfg == SpectrumChannels.MIDSIDE:
        # ref quirk: RSNT MidSide packs (side, mid) in that order
        # (TransformDSP.inl:1277: pair{left - right, left + right})
        return torch.stack([left - right, left + right], dim=1)
    return block[:, :2]  # PHASE / SEPARATE / COMPLEX


def rsnt_chunks(
    constant: SpectrumConstant,
    resonator: ResonatorConstant,
    res_state: torch.Tensor,
    graph_state: LineGraphState,
    blocks: torch.Tensor,
    valid,
    plan: ResonatorBlockPlan,
):
    """A whole tick's pending audio: mix -> resonate over T chunks -> final
    windowed readout -> decay+dB.

    blocks [pairs, 2, T, W] time-ordered; valid [T] bool on the host or
    None (False = padding, the bank untouched). Returns (results
    [pairs, 1, K, rows, P], res_state, graph_state); ``graph_state`` is
    updated in place by one decay step whatever ``valid`` says, as in the
    JAX package: the step displays the bank as it stands."""
    mixed = _mix_rsnt(constant.configuration, blocks)  # [pairs, rows, T, W]
    # the recurrence and the final state's readout: kernel H on a GPU
    scan = resonate_and_read(resonator, res_state, mixed, valid=valid, plan=plan)
    st = scan.state
    if constant.configuration == SpectrumChannels.PHASE:
        # post_process's PHASE contract is rows = (mid magnitude,
        # cancellation in [0, 1]) — built from the COMPLEX per-channel
        # states exactly like the reference's RSNT Phase branch
        # (mapResonatingSystem, TransformDSP.inl:1111-1127): mid =
        # |L| + |R|, cancellation = 1 - |L + R| / mid.
        re, im, mag = scan.re, scan.im, scan.magnitude  # [pairs, 2, P]
        mid = mag[:, 0] + mag[:, 1]
        sre, sim = re[:, 0] + re[:, 1], im[:, 0] + im[:, 1]
        interference = torch.sqrt(sre * sre + sim * sim)
        cancel = 1.0 - torch.where(mid > 0, interference / torch.clamp(mid, min=1e-30), 0.0)
        vals = torch.stack([mid, cancel], dim=1)  # [pairs, 2, P]
    else:
        vals = scan.magnitude  # [pairs, rows, P]
    result = post_process(constant, graph_state, vals[:, None])
    return result.results, st, result.state


class ResonatorSpectrumProcessor:
    """Spectrum view driven by the resonator bank instead of the FFT
    (ref: TransformAlgorithm::RSNT). Consumes a *continuous* sample stream
    (no framing); per block: channel-mode mix -> resonate -> windowed
    readout -> peak decay -> dB, on the constant's device (on a GPU the
    recurrence and the readout are kernel H, the decay and the dB map the
    display kernel's decay-and-dB entry, or kernel G in PHASE).

    Channel packing per resonatingDispatch: Mid = L + R and Side = L - R
    (the RSNT path does NOT halve, unlike the FFT path's prepareTransform).
    """

    def __init__(
        self,
        constant: SpectrumConstant,
        *,
        pairs: int = 1,
        window_type=None,
        free_q: bool = False,
    ):
        self.constant = constant
        self.pairs = pairs
        self.rows = constant.state_channels
        self.resonator = make_resonator_constant(
            constant.host_frequencies,
            constant.sample_rate,
            constant.window_size,
            device=constant.device,
            window_type=window_type if window_type is not None else WindowType.HANN,
            free_q=free_q,
        )
        self._plans: dict = {}  # chunk length -> ResonatorBlockPlan
        self.reset()

    @classmethod
    def create(
        cls, *, pairs: int = 1, device=None, window_type=None, free_q: bool = False, **constant_kwargs
    ) -> "ResonatorSpectrumProcessor":
        """Build the constant on ``device`` and a processor for ``pairs``
        channel pairs. ``device=None`` is the GPU; it raises when no GPU is
        available, and the CPU is used only for ``device="cpu"``."""
        device = resolve_device(device)
        constant = make_spectrum_constant(device=device, **constant_kwargs)
        return cls(constant, pairs=pairs, window_type=window_type, free_q=free_q)

    @property
    def device(self) -> torch.device:
        return self.constant.device

    def block_plan(self, block: int) -> ResonatorBlockPlan:
        """Cached :class:`ResonatorBlockPlan` for ``block``-sample chunks."""
        plan = self._plans.get(block)
        if plan is None:
            plan = self._plans[block] = make_block_plan(self.resonator, block)
        return plan

    @property
    def res_state(self) -> torch.Tensor:
        """Current resonator bank state [pairs, rows, P, V, 2]."""
        return self._res_state

    @property
    def graph_state(self) -> LineGraphState:
        """Current display decay state (updated in place by ``process``)."""
        return self._graph_state

    def load_state(self, res_state: torch.Tensor, graph_state: LineGraphState) -> None:
        """Continue from carried states (e.g. from
        :func:`~signalizer_tpu_torch.kernels.resonator.resonator_state_from_arrays`
        and :func:`~signalizer_tpu_torch.kernels.spectrum.line_graph_state_from_arrays`)."""
        self._res_state = res_state.to(self.device)
        self._graph_state = LineGraphState(*(t.to(self.device) for t in graph_state))

    def reset(self) -> None:
        self._res_state = init_resonator_state(self.resonator, (self.pairs, self.rows))
        self._graph_state = init_line_graph_state(self.constant, (self.pairs,))

    def _blocks(self, blocks) -> torch.Tensor:
        if isinstance(blocks, np.ndarray):
            blocks = torch.from_numpy(np.ascontiguousarray(blocks, dtype=np.float32))
        return torch.as_tensor(blocks, dtype=torch.float32).to(self.device)

    def process(self, block) -> torch.Tensor:
        """block [pairs, 2, n] -> display results [pairs, 1, K, rows, P]
        (one chunk, via :meth:`process_chunks`)."""
        return self.process_chunks(self._blocks(block)[:, :, None, :])

    def process_chunks(self, blocks, valid=None) -> torch.Tensor:
        """Consume a whole tick's pending audio in one call.

        ``blocks`` [pairs, 2, T, W]: T time-ordered chunks of W samples
        each (each sample exactly once — the bank is stateful).
        ``valid`` [T] bool or None: False entries are host-side padding
        to a fixed T; they advance nothing. Returns the display results
        after the last valid chunk, [pairs, 1, K, rows, P]
        (ref: continuous resonate, TransformDSP.inl:1163-1211).
        """
        blocks = self._blocks(blocks)
        plan = self.block_plan(blocks.shape[-1])
        results, self._res_state, self._graph_state = rsnt_chunks(
            self.constant,
            self.resonator,
            self._res_state,
            self._graph_state,
            blocks,
            valid,
            plan,
        )
        return results
