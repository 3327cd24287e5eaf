"""Device-resident history ring — hop-only ingest for framed views.

Counterpart of :mod:`signalizer_tpu.stream.device_ring`. The reference
never copies analysis windows: ``prepareTransform`` reads each window *in
place* from the stream's history ring (ref:
Source/Spectrum/TransformDSP.inl:38-231 over ``AudioBufferView``s) and the
render path re-reads history without copying (ref:
Source/Spectrum/SpectrumRendering.cpp:620-635). The host-side
:class:`~signalizer_tpu_torch.stream.batcher.FrameBatcher` materializes
every overlapped ``[T, C, W]`` window and uploads it again per tick — at 50%
overlap every sample crosses the host->device link twice.

This module keeps the rolling history in device memory instead:

* the ring is a **shift ring** ``[..., H]`` whose newest sample is always
  at index ``H - 1`` (no cursor, every window is a fixed slice);
* per tick only the NEW samples cross the link (:func:`ring_update`);
* overlapped analysis windows are strided views of the ring
  (:func:`extract_frames`), so ingest cost scales with hop bytes, not
  window bytes.

Framing matches ``FrameBatcher`` exactly (frame ``k`` covers stream
samples ``[k*hop, k*hop + window)``): the FIRST upload is exactly
``window`` samples (frame 0 completes the moment it is uploadable) and
every later upload is a whole number of hops, so the ring end always
coincides with the newest frame's end. tests/test_torch_device_ring.py
holds the functions bit-equal to the JAX package's, and
:class:`DeviceFrameSource` (numpy, copied unchanged) equal to the original.

``hop`` must be an integer: the frame grid has to be aligned to the ring
end every tick. Fractional hops stay on the host batcher path.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from signalizer_tpu_torch.core.constant import resolve_device
from signalizer_tpu_torch.utils.diagnostics import span


def ring_update(ring: torch.Tensor, new: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Shift ``n_valid`` new samples into the ring.

    ``ring`` [..., H]; ``new`` [..., n_max] whose FIRST ``n_valid`` columns
    are valid (the rest is bucket padding); ``n_valid`` a host int. Returns
    the last H samples of ``ring ++ new[..., :n_valid]`` as a new tensor.
    """
    with span("ring.update"):
        n_valid = int(n_valid)
        h = ring.shape[-1]
        if not 0 <= n_valid <= new.shape[-1]:
            raise ValueError(f"n_valid {n_valid} outside 0..{new.shape[-1]}")
        cat = torch.cat([ring, new[..., :n_valid].to(ring.dtype)], dim=-1)
        return cat[..., n_valid : n_valid + h]


def extract_frames(
    ring: torch.Tensor, window: int, hop: int, t_max: int, frame_axis: int = -2
) -> torch.Tensor:
    """Extract the last ``t_max`` hop-spaced windows.

    Slot ``k`` (0 = oldest) is the window ENDING at ring position
    ``H - (t_max - 1 - k) * hop`` — fixed slices, because the shift ring
    keeps the newest sample pinned at ``H - 1``. Returns the windows on a
    new ``frame_axis`` as a strided view of the ring (no copy; a caller
    that needs contiguous frames copies).
    """
    h = ring.shape[-1]
    if (t_max - 1) * hop + window > h:
        raise ValueError(
            f"ring history {h} too short for {t_max} frames of "
            f"window={window} hop={hop}"
        )
    start = h - window - (t_max - 1) * hop
    wins = ring[..., start:].unfold(-1, window, hop)  # [..., t_max, window]
    return torch.movedim(wins, -2, frame_axis)


class UploadUnit(NamedTuple):
    """One bucketed host->device upload for a fused ingest+analyze step."""

    samples: np.ndarray  # [..., t_max * hop] — first n_valid columns real
    n_valid: int  # valid sample count (t_valid * hop)
    frame_valid: np.ndarray  # [t_max] bool — slots to analyze/emit
    t_valid: int  # == frame_valid.sum()


class DeviceFrameSource:
    """Host half of the hop-only ingest path (FrameBatcher's device twin).

    ``push()`` buffers raw samples; :meth:`pull_uploads` hands back
    pow2-bucketed :class:`UploadUnit`\\ s — each one hop-aligned, sized
    ``t_max * hop`` samples — for the caller's step
    (``ring_update`` -> ``extract_frames`` -> analyze, once per
    unit). Only whole hops ever upload; the partial-hop residue waits
    host-side so the frame grid stays aligned to the ring end.
    """

    def __init__(
        self,
        lead_shape: Tuple[int, ...],
        window: int,
        hop: int,
        *,
        t_cap: int = 32,
        history: Optional[int] = None,
        max_pending_frames: Optional[int] = None,
    ):
        if int(hop) != hop or hop <= 0:
            raise ValueError("device ingest requires a positive integer hop")
        hop = int(hop)
        if window <= 0:
            raise ValueError("window must be positive")
        self.lead_shape = tuple(lead_shape)
        self.window = int(window)
        self.hop = hop
        self.t_cap = int(t_cap)
        if self.t_cap < 1:
            raise ValueError("t_cap must be >= 1")
        # pull_uploads buckets t_valid up to the next power of two, so
        # the ring must hold the largest BUCKET of frames, not just t_cap
        # (a non-pow2 t_cap would otherwise fail extract_frames on a full
        # pull)
        bucket_cap = 1 << (self.t_cap - 1).bit_length()
        need = (bucket_cap - 1) * hop + window
        self.history = int(history) if history else max(4 * window, need)
        if self.history < need:
            raise ValueError(
                f"history {self.history} < required {need} "
                f"(t_cap {self.t_cap} buckets up to {bucket_cap} frames)"
            )
        self._primed = False  # next frame's window tail already on device?
        self.max_pending_frames = max_pending_frames
        self._pending: List[np.ndarray] = []
        self._pending_n = 0
        self._front = 0  # absolute stream position of the first pending sample
        self._next_frame = 0  # next absolute frame index to emit (k*hop grid)
        self.frames_produced = 0
        self.dropped_frames = 0
        self.sample_clock = 0

    def init_ring(self, device=None, dtype=torch.float32) -> torch.Tensor:
        """Fresh zeroed device ring [..., H] on ``device`` (``None``: the
        GPU, raising without one)."""
        return torch.zeros(self.lead_shape + (self.history,), dtype=dtype, device=resolve_device(device))

    def push(self, block: np.ndarray) -> None:
        """Buffer [..., n] samples (lead dims must match ``lead_shape``)."""
        block = np.asarray(block, np.float32)
        if block.shape[:-1] != self.lead_shape:
            raise ValueError(
                f"block lead shape {block.shape[:-1]} != {self.lead_shape}"
            )
        self._pending.append(block)
        self._pending_n += block.shape[-1]
        self.sample_clock += block.shape[-1]
        if self.max_pending_frames is not None:
            cap = max(
                self.max_pending_frames * self.hop + self.hop - 1,
                self.window + self.hop,
            )
            dropped = 0
            while self._pending_n > cap:
                # drop the oldest samples (ref: droppedAudioFrames perf
                # counter semantics) — the ring then has a history gap,
                # so the stream re-primes on the next pull
                drop = min(self._pending_n - cap, self._pending[0].shape[-1])
                head = self._pending[0]
                if drop >= head.shape[-1]:
                    self._pending.pop(0)
                else:
                    self._pending[0] = head[..., drop:]
                self._pending_n -= drop
                dropped += drop
            if dropped:
                # stay on the absolute k*hop frame grid (FrameBatcher
                # pins frame k at [k*hop, k*hop+window) even across
                # drops): re-prime at the first frame whose window lies
                # entirely in surviving samples, and count exactly the
                # frames whose data fell into the gap (round-4 review)
                self._front += dropped
                k0 = -(-self._front // self.hop)  # ceil
                self.dropped_frames += max(0, k0 - self._next_frame)
                self._next_frame = max(self._next_frame, k0)
                self._primed = False

    def frames_ready(self) -> int:
        """Frames a pull would emit now."""
        if self._primed:
            return self._pending_n // self.hop
        # re-prime skips up to the next frame boundary on the absolute grid
        skip = self._next_frame * self.hop - self._front
        if self._pending_n < skip + self.window:
            return 0
        return 1 + (self._pending_n - skip - self.window) // self.hop

    def _take(self, n: int) -> np.ndarray:
        """Pop exactly n samples from the pending buffer -> [..., n]."""
        parts, got = [], 0
        while got < n:
            head = self._pending[0]
            take = min(n - got, head.shape[-1])
            parts.append(head[..., :take])
            if take == head.shape[-1]:
                self._pending.pop(0)
            else:
                self._pending[0] = head[..., take:]
            got += take
        self._pending_n -= n
        self._front += n
        return np.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0].copy()

    def pull_uploads(self, max_frames: Optional[int] = None) -> List[UploadUnit]:
        """Consume ready frames as bucketed upload units.

        The first unit of a (re)primed stream carries exactly ``window``
        samples (frame 0); every later unit covers ``t_valid <= t_cap``
        whole hops, padded to the pow2 bucket ``t_max`` (the JAX
        package's units, kept so that both packages see the same ones).
        ``frame_valid[k]`` is True for the trailing ``t_valid`` slots —
        masked-out slots leave filter state untouched downstream.
        """
        units: List[UploadUnit] = []
        budget = None if max_frames is None else max(0, int(max_frames))
        if not self._primed:
            skip = self._next_frame * self.hop - self._front
            if self._pending_n < skip + self.window or budget == 0:
                return units
            if skip:
                self._take(skip)  # gap samples no frame on the grid reads
            units.append(
                UploadUnit(self._take(self.window), self.window, np.ones(1, bool), 1)
            )
            self._primed = True
            self._next_frame += 1
            self.frames_produced += 1
            if budget is not None:
                budget -= 1
        hops = self._pending_n // self.hop
        if budget is not None:
            hops = min(hops, budget)
        while hops > 0:
            t_valid = min(hops, self.t_cap)
            t_max = 1 << (t_valid - 1).bit_length()
            samples = np.zeros(self.lead_shape + (t_max * self.hop,), np.float32)
            n = t_valid * self.hop
            samples[..., :n] = self._take(n)
            frame_valid = np.zeros(t_max, bool)
            frame_valid[t_max - t_valid :] = True
            self.frames_produced += t_valid
            self._next_frame += t_valid
            units.append(UploadUnit(samples, n, frame_valid, t_valid))
            hops -= t_valid
        return units


# ---------------------------------------------------------------------------
# single-frame step helper (latency path)
# ---------------------------------------------------------------------------


def ingest_window(ring: torch.Tensor, new: torch.Tensor, *, window: int):
    """Hop-only latency step primitive: shift ``new`` [..., hop] in and
    return (ring', newest window [..., window])."""
    ring = ring_update(ring, new, new.shape[-1])
    return ring, ring[..., ring.shape[-1] - window :]
