"""Frame batcher: continuous stream -> [T, C, window] device frame batches.

The port's own copy of :mod:`signalizer_tpu.stream.batcher` (numpy,
arithmetic unchanged; tests hold it equal to the original). Replaces the reference's per-view streaming chunkers (the spectrogram's
blobSize accumulator, ref: Source/Spectrum/TransformDSP.inl:1163-1211
audioEntryPoint) with one host-side hopper: overlapping STFT-style framing
with arbitrary hop (hop < window = overlap, hop > window = gapped
spectrogram blobs), emitting *batches* of every complete frame since the
last pull so the device processes T frames per dispatch instead of one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from signalizer_tpu_torch.stream.ring_buffer import make_ring_buffer


class FrameBatcher:
    """Hopper over a ring buffer.

    Frames are ``window`` samples long; frame k covers samples
    ``[k*hop, k*hop + window)`` on the monotonic stream clock. ``pull()``
    returns all complete frames not yet emitted as one [T, C, window]
    batch (empty T=0 array when none).
    """

    def __init__(
        self,
        channels: int,
        window: int,
        hop: float,
        *,
        capacity: Optional[int] = None,
        dtype=np.float32,
    ):
        if window <= 0 or hop <= 0:
            raise ValueError("window and hop must be positive")
        self.window = window
        self.hop = float(hop)
        capacity = capacity or max(window * 4, int(hop * 4) + window)
        self.ring = make_ring_buffer(channels, capacity, dtype=dtype)
        self._next_frame = 0  # next frame index to emit
        self.dropped_frames = 0

    @property
    def channels(self) -> int:
        return self.ring.channels

    def push(self, block: np.ndarray) -> None:
        self.ring.write(block)

    def frames_ready(self) -> int:
        """Number of complete, not-yet-emitted frames.

        Readiness must use the *same* rounded end-clock as the read path
        (``int(k*hop + 0.5) + window <= clock``, round-half-up exactly as the
        native ``sz_frame_gather``): with fractional hop the exact
        product can undershoot the rounded end by <0.5 samples, and a frame
        counted ready off the exact product would read as "future" and be
        lost even though its data arrives on the next push.
        """
        clock = self.ring.sample_clock
        if clock < self.window:
            return 0
        total = int(np.floor((clock - self.window) / self.hop)) + 1
        # the rounded end clock of the last candidate may exceed the exact
        # product by up to 0.5 — walk back until it is truly readable...
        while total > 0 and int((total - 1) * self.hop + 0.5) + self.window > clock:
            total -= 1
        # ...and symmetrically the NEXT frame's rounded end may undershoot
        # the exact product (round-down) and already be readable — walk
        # forward, or the final frame of an offline stream is never
        # emitted (round-3 review)
        while int(total * self.hop + 0.5) + self.window <= clock:
            total += 1
        return max(0, total - self._next_frame)

    def pull(self, max_frames: Optional[int] = None) -> np.ndarray:
        """Emit ready frames as [T, C, window]; advances the cursor.

        Frames whose data already fell out of the ring are dropped (counted
        in ``dropped_frames`` — the reference exposes the same condition via
        its perf counters, ref: AudioStream getPerfMeasures droppedFrames).
        """
        t = self.frames_ready()
        if max_frames is not None:
            t = min(t, max_frames)
        if t == 0:
            return np.zeros((0, self.ring.channels, self.window), np.float32)
        if hasattr(self.ring, "frame_gather"):  # native bulk path
            out = self.ring.frame_gather(self._next_frame, t, self.hop, self.window)
            self.dropped_frames += t - out.shape[0]
            self._next_frame += t
            return out
        out = np.zeros((t, self.ring.channels, self.window), np.float32)
        emitted = 0
        advanced = 0
        for k in range(self._next_frame, self._next_frame + t):
            end_clock = int(k * self.hop + 0.5) + self.window  # round-half-up, matches sz_frame_gather
            try:
                out[emitted] = self.ring.read_at(end_clock, self.window)
                emitted += 1
                advanced += 1
            except ValueError as e:
                if "future" in str(e):
                    # defensive: never advance past a not-yet-complete frame —
                    # retry it on the next pull instead of dropping it
                    break
                self.dropped_frames += 1
                advanced += 1
        self._next_frame += advanced
        if emitted < t:
            out = out[:emitted]
        return out
