"""Device-resident presentation history — hop-only uploads for the tick loop.

Counterpart of :mod:`signalizer_tpu.stream.device_history`. The reference's
views re-read the presentation stream's history ring *in place* every
render frame (ref: Source/Spectrum/SpectrumRendering.cpp:620-635 re-reading
retained history; Source/Oscilloscope/OscilloscopeRendering.cpp pulling
``audioStream`` views per frame) — samples are never copied per view.
Uploading each view's full analysis window per tick would move window
bytes times active views across the host->device link at UI cadence, even
though almost all of those samples were already on the device the tick
before.

This module keeps ONE ``[channels, H]`` float32 shift ring on the device
(the :func:`~signalizer_tpu_torch.stream.device_ring.ring_update`
primitive) fed by a presentation stream listener:

* audio-cadence ``on_stream_audio`` callbacks buffer copies host-side (the
  delivery buffer is only valid during the callback);
* once per tick :meth:`sync` uploads *exactly the samples that arrived
  since the previous tick* through a pinned staging buffer (no power-of-two
  bucket: the port has no compiled shapes to bound) and shifts them in;
* every view then reads its window as a view of the ring's tail
  (:meth:`window`), sharing the same ring — ingest cost per tick scales
  with the audio rate, not ``window x views``.

Parity contract: ``window(n)`` equals
``AudioStreamOutput.get_history(n)`` bit-exactly (zero left-padding before
the stream has produced ``n`` samples, trailing alignment after), locked by
tests/test_torch_device_history.py against the JAX package's mirror and the
host ring across ragged push patterns, overruns and re-primes.

Exactness mechanism (the JAX package's, line for line): every delivered
block carries the producer's write-time ``(end_clock, generation)`` stamp
(``ListenerContext``), and the mirror keys its state on the same clock.
:meth:`sync` accepts only blocks that chain gaplessly from the ring's
current clock; anything else — attach, stream reconfiguration, dropped
packets, pending trimmed under a stalled consumer, a failed upload —
re-primes from an atomic ``history_snapshot`` of the host ring, which by
write-before-deliver ordering supersedes every block delivered up to that
point. Stale re-deliveries of samples already inside a snapshot (the
threaded stream's written-but-not-yet-delivered race) are dropped by their
stamps, so the mirror never double-counts a block. Unstamped deliveries (a
custom output that never stamps) fall back to ingest-everything semantics
with the same snapshot re-prime on overrun, minus the stale-block dedup.

``device=None`` is the GPU and raises without one; ``device="cpu"`` keeps
the ring on the CPU (the tests).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from signalizer_tpu_torch.core.constant import resolve_device
from signalizer_tpu_torch.stream.device_ring import ring_update


def _upload(ring: torch.Tensor, staged: torch.Tensor, n: int) -> torch.Tensor:
    """Shift the ``n`` staged samples ``staged`` [channels, n] (host) into
    ``ring`` [channels, H]: one host->device copy (asynchronous from pinned
    memory) and :func:`ring_update`."""
    new = staged.to(ring.device, non_blocking=True)
    return ring_update(ring, new, n)


class DevicePresentationHistory:
    """Shared device ring over one stream's presentation history.

    Attach to an :class:`~signalizer_tpu_torch.stream.audio_stream.AudioStreamOutput`;
    call :meth:`sync` once per render tick from the consumer thread, then
    :meth:`window` per view. Detach with :meth:`close`.
    """

    def __init__(self, output, history: Optional[int] = None, *, device=None):
        self.device = resolve_device(device)
        self._output = output
        self._explicit_history = int(history) if history else None
        self._lock = threading.Lock()
        # (block, end_clock, generation); stamps None for custom outputs
        self._pending: List[Tuple[np.ndarray, Optional[int], Optional[int]]] = []
        self._pending_n = 0
        self._overrun = False  # pending trimmed: ring must full-re-prime
        self._ring: Optional[torch.Tensor] = None
        self._channels = 0
        self._history = 0
        # host clock/generation of the ring's newest sample (None until the
        # first stamped re-prime; stays None for unstamped streams)
        self._clock: Optional[int] = None
        self._gen: Optional[int] = None
        # host staging for the uploads, channels x H floats (pinned on a
        # CUDA device); the event marks the end of the last copy out of it
        self._staging: Optional[torch.Tensor] = None
        self._staged: Optional[torch.cuda.Event] = None
        # what the last sync uploaded and how (read by chip_smoke.py)
        self.uploaded_samples = 0
        self.uploaded_bytes = 0
        self.reprimes = 0
        output.add_listener(self)

    # --- geometry ---------------------------------------------------------
    def _target_shape(self) -> tuple:
        info = self._output.info
        h = self._explicit_history or int(info.audio_history_capacity)
        return int(info.channels), max(int(h), 1)

    @property
    def history(self) -> int:
        """Ring length H (== the stream's history capacity by default)."""
        return self._target_shape()[1]

    # --- stream listener protocol ------------------------------------------
    def on_stream_audio(self, ctx, block) -> None:
        b = np.array(block, np.float32, copy=True)  # buffer dies after cb
        end = getattr(ctx, "block_end_clock", None)
        gen = getattr(ctx, "ring_generation", None)
        with self._lock:
            self._pending.append((b, end, gen))
            self._pending_n += b.shape[-1]
            # bound host memory across long freezes / stalled consumers:
            # only the last H samples can ever reach the ring anyway
            cap = self.history
            while self._pending_n - self._pending[0][0].shape[-1] >= cap:
                self._pending_n -= self._pending.pop(0)[0].shape[-1]
                self._overrun = True

    def on_stream_properties_changed(self, ctx, before) -> None:
        pass  # geometry re-checked lazily in sync(); stale blocks are
        # rejected by their generation stamps

    def on_stream_died(self, ctx) -> None:
        pass

    # --- consumer side ------------------------------------------------------
    def _stage(self, data: np.ndarray) -> torch.Tensor:
        """``data`` [channels, n <= H] as a contiguous prefix of the host
        staging buffer (channels x H floats, pinned on a CUDA device, so
        that the copy to the device is asynchronous), after the previous
        copy out of it has finished."""
        ch, n = data.shape
        if self._staging is None or self._staging.numel() != ch * self._history:
            pinned = self.device.type == "cuda"
            self._staging = torch.empty(ch * self._history, dtype=torch.float32, pin_memory=pinned)
        elif self._staged is not None:
            self._staged.synchronize()
        staged = self._staging[: ch * n].view(ch, n)
        staged.numpy()[:] = data
        return staged

    def _reprime(self, ch: int, h: int) -> torch.Tensor:
        """Rebuild the device ring from an atomic host snapshot. Every block
        delivered before this moment was written before it (the stream
        writes its ring, then delivers), so the snapshot supersedes all of
        them; later stale re-deliveries carry end clocks <= the snapshot's
        and are dropped by the stamp filter."""
        snap = self._output.history_snapshot(h) if hasattr(
            self._output, "history_snapshot"
        ) else None
        if snap is not None:
            data, clock, gen = snap
            self._clock, self._gen = int(clock), int(gen)
        else:  # custom output: best-effort, no clock domain to key on
            data = self._output.get_history(h)
            self._clock = self._gen = None
        self._ring = torch.from_numpy(np.array(data, np.float32)).to(self.device)
        self._channels, self._history = ch, h
        self.uploaded_samples = h
        self.uploaded_bytes = self._ring.numel() * self._ring.element_size()
        self.reprimes += 1
        return self._ring

    def sync(self) -> torch.Tensor:
        """Upload everything that arrived since the last call; return the
        ring. One host->device copy of exactly the new samples."""
        with self._lock:
            parts, self._pending = self._pending, []
            n = self._pending_n
            self._pending_n = 0
            overrun, self._overrun = self._overrun, False
        self.uploaded_samples = self.uploaded_bytes = 0

        ch, h = self._target_shape()
        if self._ring is None or self._channels != ch or self._history != h:
            return self._reprime(ch, h)

        stamped = self._clock is not None and all(
            e is not None and g is not None for _, e, g in parts
        )
        if stamped:
            # any block from another clock domain (stream reconfigured
            # back to the same shape, ring rebuilt) invalidates the chain:
            # the snapshot supersedes everything popped so far
            if any(g != self._gen for _, _, g in parts):
                return self._reprime(ch, h)
            # drop stale re-deliveries (samples already inside a snapshot)
            parts = [p for p in parts if p[1] > self._clock]
            n = sum(p[0].shape[-1] for p in parts)
            # gap check: the kept blocks must chain gaplessly from the
            # ring's clock — a break means samples the mirror never saw
            # (dropped packets, trimmed pending)
            expected = self._clock
            for b, e, _ in parts:
                if e - b.shape[-1] != expected:
                    return self._reprime(ch, h)
                expected = e
        elif overrun or self._clock is not None:
            # unstamped delivery after a stamped history (or trimmed
            # pending without stamps to re-chain by): re-prime
            return self._reprime(ch, h)

        if n == 0:
            return self._ring

        blocks = [p[0] for p in parts]
        data = np.concatenate(blocks, axis=-1) if len(blocks) > 1 else blocks[0]
        if data.shape[0] != ch:  # channel-count race: rebuild next sync
            fixed = np.zeros((ch, data.shape[-1]), np.float32)
            fixed[: min(ch, data.shape[0])] = data[: min(ch, data.shape[0])]
            data = fixed
        if n > h:
            data = data[..., -h:]
            n = data.shape[-1]
        staged = self._stage(data)
        try:
            self._ring = _upload(self._ring, staged, n)
        except Exception:
            # drop the mirror; the next sync re-primes from an atomic host
            # snapshot (which also supersedes this upload's samples) and
            # the stamp filter drops any of them that get re-delivered
            # meanwhile
            self._ring = None
            self._channels = self._history = 0
            self._clock = self._gen = None
            raise
        if self.device.type == "cuda":
            self._staged = torch.cuda.Event()
            self._staged.record()
        self.uploaded_samples = n
        self.uploaded_bytes = staged.numel() * staged.element_size()
        if stamped:
            self._clock = parts[-1][1]
        return self._ring

    def window(self, n: int, *, lead: int = 0, pad_to: int = 0) -> torch.Tensor:
        """Trailing device window [channels, n] (call after :meth:`sync`): a
        view of the ring (row stride >= H, so a caller that needs
        contiguous rows copies). ``lead`` prepends that many singleton
        axes; ``pad_to`` zero-pads the channel axis up to that many rows
        (a copy)."""
        if self._ring is None:
            self.sync()
        n = int(n)
        if n > self._history:
            raise ValueError(f"window {n} exceeds device history {self._history}")
        t = self._ring[:, self._ring.shape[-1] - n :]
        c = t.shape[0]
        if pad_to and c < pad_to:
            t = torch.cat([t, t.new_zeros((pad_to - c, n))], dim=0)
        for _ in range(int(lead)):
            t = t[None]
        return t

    @property
    def ring(self) -> Optional[torch.Tensor]:
        """The device ring [channels, H] (None before the first sync)."""
        return self._ring

    def close(self) -> None:
        self._output.remove_listener(self)
        self._ring = None
