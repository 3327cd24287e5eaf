"""Host-side multichannel ring buffer.

The port's own copy of :mod:`signalizer_tpu.stream.ring_buffer` (numpy,
arithmetic unchanged; tests hold it equal to the original over seeded
push/read sequences, and to the native ring that :func:`make_ring_buffer`
returns where ``g++`` built it). Replaces cpl's ``CLIFOStream`` / 2-segment circular AudioBufferViews
(ref: cpl AudioStream buffer views, SURVEY.md §2.9) with a contiguous
numpy design: the framework consumes *fixed-size trailing windows* (device
frames), so the primary read is ``latest(n)`` — materialized contiguously
with at most one wrap copy — rather than iterator segments. Single-writer
by contract: the producer (audio callback / feeder thread) writes, consumers
read snapshots; numpy slice copies make torn reads impossible at the frame
level.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class RingBuffer:
    """Fixed-capacity multichannel sample ring.

    ``capacity`` samples per channel; ``write`` appends, ``latest`` reads
    the trailing window. Tracks a monotonic sample clock (total samples
    ever written — the reference's steadyClock analogue,
    ref: MixGraphListener State endpoint semantics).
    """

    def __init__(self, channels: int, capacity: int, dtype=np.float32):
        if capacity <= 0 or channels <= 0:
            raise ValueError("channels and capacity must be positive")
        self.channels = channels
        self.capacity = capacity
        self._data = np.zeros((channels, capacity), dtype=dtype)
        self._head = 0  # next write index
        self._written = 0  # monotonic sample clock

    @property
    def sample_clock(self) -> int:
        return self._written

    @property
    def valid_samples(self) -> int:
        """Samples available to read (<= capacity)."""
        return min(self._written, self.capacity)

    def clear(self) -> None:
        self._data[:] = 0
        self._head = 0
        self._written = 0

    def write(self, block: np.ndarray) -> None:
        """Append block [channels, n]. Blocks larger than capacity keep
        only the trailing ``capacity`` samples (old data is gone anyway)."""
        block = np.asarray(block)
        if block.ndim != 2 or block.shape[0] != self.channels:
            raise ValueError(f"expected [{self.channels}, n] block, got {block.shape}")
        n = block.shape[1]
        # data and head land BEFORE the clock advances: a concurrent
        # reader (threaded python-fallback stream) that sees the new
        # _written must also see the samples it implies — advancing the
        # clock first would let it attribute stale data to the new clock
        if n >= self.capacity:
            self._data[:] = block[:, n - self.capacity :]
            self._head = 0
            self._written += n
            return
        first = min(n, self.capacity - self._head)
        self._data[:, self._head : self._head + first] = block[:, :first]
        rest = n - first
        if rest:
            self._data[:, :rest] = block[:, first:]
        self._head = (self._head + n) % self.capacity
        self._written += n

    def latest(self, n: int, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Trailing window [channels, n] ending at the newest sample.
        Zero-padded on the left if fewer than n samples were ever written."""
        if n > self.capacity:
            raise ValueError(f"window {n} exceeds capacity {self.capacity}")
        if out is None:
            out = np.zeros((self.channels, n), dtype=self._data.dtype)
        else:
            out[:] = 0
        avail = min(n, self.valid_samples)
        if avail == 0:
            return out
        start = (self._head - avail) % self.capacity
        first = min(avail, self.capacity - start)
        out[:, n - avail : n - avail + first] = self._data[:, start : start + first]
        rest = avail - first
        if rest:
            out[:, n - rest :] = self._data[:, :rest]
        return out

    def seek_to(self, clock: int) -> None:
        """Advance the monotonic clock to ``clock``, zero-filling the gap
        (used to place a stream's ring on its own steady-clock timeline)."""
        if clock <= self._written:
            return
        gap = clock - self._written
        if gap >= self.capacity:
            self._data[:] = 0
            self._head = 0
            self._written = clock
        else:
            self.write(np.zeros((self.channels, int(gap)), self._data.dtype))

    def read_at(self, clock: int, n: int) -> np.ndarray:
        """Window [channels, n] ending at absolute sample ``clock`` (on the
        monotonic clock). Raises if the region has been overwritten."""
        if clock > self._written:
            raise ValueError("cannot read the future")
        behind = self._written - clock
        if behind + n > self.capacity:
            raise ValueError("window no longer in the ring")
        full = self.latest(n + behind)
        return full[:, :n].copy() if behind else full


def make_ring_buffer(channels: int, capacity: int, dtype=np.float32, prefer_native: bool = True):
    """Ring factory, as the JAX package's: the C++ runtime
    (``signalizer_tpu_torch/native/host_runtime.cpp``, built with ``g++`` on
    first use) when it is available, numpy otherwise. Both share the exact
    same semantics (tests/test_torch_stream_copies.py cross-checks them)."""
    if prefer_native and dtype == np.float32:
        from signalizer_tpu_torch.native_bindings import NativeRingBuffer, native_available

        if native_available():
            return NativeRingBuffer(channels, capacity)
    return RingBuffer(channels, capacity, dtype=dtype)
