"""Diagnostics, global behaviour toggles, non-terminal assumptions.

The port's own copy of :mod:`signalizer_tpu.utils.diagnostics` (arithmetic
unchanged; tests hold it equal to the original), with :class:`profile_trace`
on ``torch.profiler`` instead of ``jax.profiler``. Equivalents of the
reference's observability surface (ref: SURVEY.md §4/§5):

* :class:`Diagnostics` — the diagnostics-HUD data (ref: per-view HUD,
  SpectrumRendering.cpp:149-184) plus the BASELINE metrics (frames/sec,
  latency percentiles).
* :class:`SharedBehaviour` — global toggles (ref: SharedBehaviour.h:37-45).
* :func:`assumption` — NONTERMINAL_ASSUMPTION (ref: CommonSignalizer.h:1175,
  impl CommonSignalizer.cpp:51-83): hashed once-only reporting of violated
  invariants via logging instead of crashing.

The port's own observability, which the JAX package does not have:

* :func:`count` — the counter registry (kernel launches and the like):
  always counts; :func:`counter` reads one, :func:`reset_counters` zeroes.
* :func:`span` — a named host span at a layer boundary (the processor, the
  device ring, the colour map, each kernel wrapper's entry), recorded only
  while a ``torch.profiler`` session runs, into a preallocated ring of
  records (name, start, end, parent) that :func:`spans` reads out after the
  window. With no profiler running, ``span()`` returns one shared no-op
  object: no allocation and no clock read.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from array import array
from dataclasses import dataclass
from typing import Dict, List, NamedTuple

import numpy as np
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger("signalizer_tpu_torch")

_seen_assumptions: set = set()


def assumption(condition: bool, message: str) -> bool:
    """Non-fatal invariant check: logs each *distinct* violation once
    (dedup by message hash, like the reference's hashed once-only MsgBox
    queue) and returns the condition so callers can early-out."""
    if not condition:
        key = hash(message)
        if key not in _seen_assumptions:
            _seen_assumptions.add(key)
            logger.error("assumption violated: %s", message)
    return bool(condition)


def reset_assumptions() -> None:
    _seen_assumptions.clear()


@dataclass
class SharedBehaviour:
    """ref: SharedBehaviour.h:37-45."""

    hide_widgets_on_mouse_exit: bool = False
    stop_processing_on_suspend: bool = False
    show_legend: bool = True


class Diagnostics:
    """Rolling frame statistics (ref: GraphicsWindow 64-tap box filters,
    CommonSignalizer.h:163-231 + AudioStream perf measures)."""

    def __init__(self, window: int = 64):
        self.window = window
        self._frame_times: List[float] = []
        self._frame_sum = 0.0  # running box-filter sum: snapshot() is O(1)
        self._latencies: List[float] = []
        self._lat_cache: Dict[str, float] = None  # recomputed only on new data
        self._last = None
        self.counters: Dict[str, float] = {}

    def tick_frame(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._frame_times.append(now - self._last)
            self._frame_sum += now - self._last
            if len(self._frame_times) > self.window:
                drop = self._frame_times[: -self.window]
                del self._frame_times[: -self.window]
                self._frame_sum -= sum(drop)
        self._last = now

    def record_latency(self, seconds: float) -> None:
        self._latencies.append(seconds)
        self._latencies = self._latencies[-max(self.window * 4, 256) :]
        self._lat_cache = None

    def bump(self, name: str, amount: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + amount

    @property
    def fps(self) -> float:
        if not self._frame_times:
            return 0.0
        mean = self._frame_sum / len(self._frame_times)
        return 1.0 / mean if mean > 0 else 0.0

    def latency_percentiles(self) -> Dict[str, float]:
        if not self._latencies:
            return {"p50_ms": 0.0, "p99_ms": 0.0}
        if self._lat_cache is None:
            arr = np.asarray(self._latencies) * 1e3
            self._lat_cache = {
                "p50_ms": float(np.percentile(arr, 50)),
                "p99_ms": float(np.percentile(arr, 99)),
            }
        return dict(self._lat_cache)

    def snapshot(self) -> Dict[str, float]:
        out = {"fps": self.fps, **self.latency_percentiles(), **self.counters}
        return out


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_counts: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (``"<wrapper>.launches"`` and the
    like); counts whether or not a profiler runs."""
    _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name``: 0 where nothing counted it since its reset."""
    return _counts.get(name, 0)


def reset_counters(*names: str) -> None:
    """Zero the counters ``names``."""
    for name in names:
        _counts.pop(name, None)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

# records the ring holds: a traced window of 51 s at the headline's rate
# (~2.4 k calls a second, 4 spans a call) fills under half of it; an older
# record is overwritten by the newest
SPAN_CAPACITY = 1 << 20
_MASK = SPAN_CAPACITY - 1


class Span(NamedTuple):
    """A closed span as :func:`spans` reads it: its ``name``, start and end
    in nanoseconds of the Unix epoch, and ``parent``, the index in the same
    list of the span that enclosed it (-1 for none)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int


class _SpanLog:
    """The preallocated ring of span records, by sequence number (slot
    ``seq & _MASK``): the name, start and end on ``time.perf_counter_ns``
    (end -1 while open), the parent's sequence number (-1 for none).
    ``next(seq)`` hands each span its number (atomic under the interpreter
    lock); ``first`` is the first number since the last reset."""

    def __init__(self):
        self.name: List[str] = [None] * SPAN_CAPACITY
        self.start = array("q", bytes(8 * SPAN_CAPACITY))
        self.end = array("q", bytes(8 * SPAN_CAPACITY))
        self.parent = array("q", bytes(8 * SPAN_CAPACITY))
        self.seq = itertools.count()
        self.first = 0


class _Open(threading.local):
    """Each thread's innermost open span (-1 for none)."""

    seq = -1


_log: _SpanLog = None  # made by the first span a profiler sees
_open = _Open()


class _NoSpan:
    """What :func:`span` returns while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


class _OpenSpan:
    """What :func:`span` returns after opening a record: its exit closes
    the calling thread's innermost open span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        now = time.perf_counter_ns()
        seq = _open.seq
        if seq >= 0:
            slot = seq & _MASK
            _log.end[slot] = now
            _open.seq = _log.parent[slot]
        return None


_NO_SPAN = _NoSpan()
_OPEN_SPAN = _OpenSpan()


def span(name: str):
    """``with span("ring.update"): ...``: a span of the enclosed code,
    recorded while a ``torch.profiler`` session runs, under the calling
    thread's innermost open span; otherwise nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    global _log
    log = _log
    if log is None:
        log = _log = _SpanLog()
    seq = next(log.seq)
    slot = seq & _MASK
    log.name[slot] = name
    log.parent[slot] = _open.seq
    log.end[slot] = -1
    _open.seq = seq
    log.start[slot] = time.perf_counter_ns()
    return _OPEN_SPAN


def _epoch_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, the median of nine
    readings each taken between two readings of the other clock."""
    offsets = []
    for _ in range(9):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        offsets.append(wall - (a + b) // 2)
    return sorted(offsets)[4]


def spans() -> List[Span]:
    """The closed spans the ring holds, oldest first, in nanoseconds of the
    Unix epoch (the clock the profiler's events are given in)."""
    log = _log
    if log is None:
        return []
    offset = _epoch_offset_ns()
    last = next(log.seq)  # a number no span takes: read the ones before it
    log.end[last & _MASK] = -1
    out, index = [], {}
    for seq in range(max(log.first, last - SPAN_CAPACITY + 1), last):
        slot = seq & _MASK
        end = log.end[slot]
        if end < 0:
            continue
        index[seq] = len(out)
        out.append(Span(log.name[slot], log.start[slot] + offset, end + offset, index.get(log.parent[slot], -1)))
    return out


def reset_spans() -> None:
    """Forget every recorded span (their ring stays allocated)."""
    if _log is not None:
        _log.first = next(_log.seq)
        _log.end[_log.first & _MASK] = -1
    _open.seq = -1


def self_ns(records) -> List[int]:
    """Each span's self time: its duration less the part of it that its
    child spans cover (children of one thread do not overlap). ``records``
    as :func:`spans` reads them, or tuples in the same order of fields."""
    own = [s[2] - s[1] for s in records]
    for s in records:
        if s[3] >= 0:
            own[s[3]] -= s[2] - s[1]
    return own


class profile_trace:
    """Context manager wrapping ``torch.profiler`` for on-demand traces
    (SURVEY.md §5.1: the tracer is the framework's profiler + the
    Diagnostics counters): host operations, and the GPU's kernels where
    CUDA is available, written on exit as a Chrome trace
    ``<log_dir>/trace.json`` with the program's spans beside them as host
    events (category ``program_span``). Usage::

        with profile_trace("traces/tick"):
            processor.process(frames)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = None
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        reset_spans()
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import json
        from pathlib import Path

        self._prof.__exit__(*exc)
        directory = Path(self.log_dir)
        directory.mkdir(parents=True, exist_ok=True)
        self.path = directory / "trace.json"
        self._prof.export_chrome_trace(str(self.path))
        trace = json.loads(self.path.read_text())
        base = int(trace.get("baseTimeNanoseconds", 0))
        pid = os.getpid()
        trace["traceEvents"].extend(
            {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": 0,
             "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3}
            for s in spans()
        )
        self.path.write_text(json.dumps(trace))
        return False
