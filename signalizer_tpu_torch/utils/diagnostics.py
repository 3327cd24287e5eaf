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
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

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


class profile_trace:
    """Context manager wrapping ``torch.profiler`` for on-demand traces
    (SURVEY.md §5.1: the tracer is the framework's profiler + the
    Diagnostics counters): host operations, and the GPU's kernels where
    CUDA is available, written on exit as a Chrome trace
    ``<log_dir>/trace.json``. Usage::

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
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        from pathlib import Path

        self._prof.__exit__(*exc)
        directory = Path(self.log_dir)
        directory.mkdir(parents=True, exist_ok=True)
        self.path = directory / "trace.json"
        self._prof.export_chrome_trace(str(self.path))
        return False
