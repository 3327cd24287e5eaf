"""FramePipeline — depth-N in-flight dispatch pipelining.

Counterpart of :mod:`signalizer_tpu.stream.frame_pipeline`. The reference
decouples DSP from display with a 10-deep lock-free frame queue (ref:
Spectrum::SFrameQueue, Source/Spectrum/Spectrum.h:139-143): the audio thread
keeps producing while the render thread consumes whatever is READY, so
neither ever waits on the other's latency. Here up to ``depth`` analysis
steps stay in flight on the device — the host->device upload of frame t+1
and the host's launches overlap the device compute of frame t — and
consumption is non-blocking: a ``torch.cuda.Event`` recorded after each
submitted step is checked with ``query()``, never with a per-frame
``synchronize()``. Blocking is reserved for BACKPRESSURE: when more than
``depth`` frames are in flight, ``submit`` synchronizes on the oldest
step's event (the reference's bounded queue keeps the producer from racing
ahead the same way). On the CPU every step has finished when it returns,
so its outputs are ready at once.

Usage::

    pipe = FramePipeline(step_fn, state0, depth=32)   # device=None: the GPU
    for block in audio_blocks:
        for done in pipe.submit(block):   # 0+ completed outputs, in order
            display(done)
    for done in pipe.drain():
        display(done)

``step_fn(state, frame) -> (output, new_state)`` takes the frame as a
tensor on the pipeline's device and launches its work on the current
stream; the state is threaded internally (the pipeline never re-reads an
old state).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Iterable, List, Tuple

import numpy as np
import torch

from signalizer_tpu_torch.core.constant import resolve_device


class FramePipeline:
    """Keep up to ``depth`` steps in flight, harvesting completed outputs
    non-blockingly (ref: the 10-deep SFrameQueue; the consumer only ever
    takes what is ready)."""

    def __init__(
        self,
        step_fn: Callable[[Any, Any], Tuple[Any, Any]],
        state: Any = None,
        *,
        depth: int = 32,
        device=None,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.device = resolve_device(device)
        self.step_fn = step_fn
        self.state = state
        self.depth = depth
        # (output, event recorded after its step; None on the CPU)
        self._inflight: deque = deque()
        self.frames_submitted = 0
        self.frames_completed = 0

    def _to_device(self, frame) -> torch.Tensor:
        if isinstance(frame, np.ndarray):
            frame = torch.from_numpy(np.ascontiguousarray(frame))
        return torch.as_tensor(frame).to(self.device, non_blocking=True)

    def submit(self, frame) -> List[Any]:
        """Dispatch one frame asynchronously. Returns every output that
        has completed (possibly none), oldest first; blocks only if more
        than ``depth`` frames would remain in flight."""
        out, self.state = self.step_fn(self.state, self._to_device(frame))
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._inflight.append((out, event))
        self.frames_submitted += 1
        done = self.harvest()
        while len(self._inflight) > self.depth:  # backpressure
            done.append(self._pop_blocking())
        return done

    def harvest(self) -> List[Any]:
        """Pop and return the leading run of completed outputs without
        blocking (completion order is submission order: the steps run in
        order on one stream)."""
        done = []
        while self._inflight and (self._inflight[0][1] is None or self._inflight[0][1].query()):
            done.append(self._inflight.popleft()[0])
            self.frames_completed += 1
        return done

    def _pop_blocking(self):
        out, event = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        self.frames_completed += 1
        return out

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def drain(self, poll_s: float = 0.001, timeout_s: float = 10.0) -> List[Any]:
        """Complete and return every in-flight output (end of stream).
        Polls readiness; falls back to blocking pops if nothing completes
        within ``timeout_s``."""
        outs = []
        deadline = time.monotonic() + timeout_s
        while self._inflight:
            got = self.harvest()
            if got:
                outs.extend(got)
                deadline = time.monotonic() + timeout_s
            elif time.monotonic() > deadline:
                outs.append(self._pop_blocking())
            else:
                time.sleep(poll_s)
        return outs

    def run(self, frames: Iterable[Any]) -> Iterable[Any]:
        """Convenience: pipeline an iterable of frames, yielding outputs
        in submission order as they complete."""
        for f in frames:
            yield from self.submit(f)
        yield from self.drain()
