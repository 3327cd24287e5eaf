"""Domain transformatters and formatters.

* AudioHistoryTransformatter — window size against a mutable history
  capacity (ref: Source/Common/CommonSignalizer.h:266-454).
* WindowSizeTransformatter — per-time-mode oscilloscope window mapping
  (ref: Source/Oscilloscope/OscilloscopeParameters.h:189-240) with unit
  parsing (ms / smps / r / bars, :95-187).
* LinearHzFormatter — parses notes ("A4", "C#3"), samples, ms, radians
  and beats into Hz (ref: OscilloscopeParameters.h:247-347).

The port's own copy of :mod:`signalizer_tpu.params.transformatters`, arithmetic and names unchanged;
tests/test_torch_params_state.py holds the two equal.
"""

from __future__ import annotations

import enum
import math
import re
from typing import Optional

from signalizer_tpu_torch.params.parameters import Formatter, Transformer


class AudioHistoryTransformatter(Transformer, Formatter):
    """Normalized knob <-> window size in samples, LINEAR against the
    *current* history capacity — transform(n) = round(n * capacity),
    normalize(v) = v / capacity (ref: CommonSignalizer.h:408-441) — and
    rescales when stream properties change (onStreamPropertiesChanged,
    CommonSignalizer.h:326: the transformed value tracks capacity so the
    knob keeps its relative position when the capacity grows).

    Deviation: transform floors at 1 sample (the reference returns 0 at
    n=0 and guards downstream; our constant factories take the window size
    directly)."""

    class Mode(enum.IntEnum):
        MILLISECONDS = 0
        SAMPLES = 1

    def __init__(self, sample_rate: float = 48_000.0, capacity: int = 48_000,
                 minimum: float = 128.0, mode: "AudioHistoryTransformatter.Mode" = None):
        self.sample_rate = float(sample_rate)
        self.capacity = float(capacity)
        self.minimum = float(minimum)  # used by the WindowSize subclass
        self.mode = mode if mode is not None else self.Mode.MILLISECONDS

    def set_stream_properties(self, sample_rate: float, capacity: int) -> None:
        self.sample_rate = float(sample_rate)
        self.capacity = float(capacity)

    def transform(self, n: float) -> float:
        return max(1.0, round(n * self.capacity))

    def normalize(self, v: float) -> float:
        return min(1.0, max(0.0, v / max(self.capacity, 1e-9)))

    def format(self, value: float) -> str:
        if self.mode == self.Mode.MILLISECONDS:
            return f"{value * 1000.0 / self.sample_rate:.1f} ms"
        return f"{int(round(value))} smps"

    def parse(self, text: str) -> Optional[float]:
        t = text.strip().lower()
        m = re.match(r"([-+0-9.e]+)\s*(smps|samples|ms|s)?", t)
        if not m:
            return None
        try:
            v = float(m.group(1))
        except ValueError:
            return None
        unit = m.group(2)
        if unit == "ms":
            return v * 1e-3 * self.sample_rate
        if unit == "s":
            return v * self.sample_rate
        if unit in ("smps", "samples", None):
            return v if unit else (v * 1e-3 * self.sample_rate if self.mode == self.Mode.MILLISECONDS else v)
        return v


class TimeMode(enum.IntEnum):
    """ref: OscilloscopeParameters.h:60-63."""

    TIME = 0
    CYCLES = 1
    BEATS = 2


class WindowSizeTransformatter(AudioHistoryTransformatter):
    """Oscilloscope window size with per-time-mode semantics
    (ref: OscilloscopeParameters.h:189-240):

    * TIME: exponential curve over [100, capacity] samples linearly
      rescaled onto [2, capacity] (n=0 is a 2-sample window)
    * CYCLES: exponential 1 .. 32 cycles ("r" parses radians)
    * BEATS: the transformed value is the pow2-quantized beat DIVISION
      nextPow2Inc(round(32^(1-n))), formatted "1/N"; parse accepts
      fractions ("1/8") and "bars" (= 4 beats), stored as the reciprocal
    """

    MIN_TIME_SAMPLES = 100.0
    MAX_CYCLES = 32.0
    MAX_BEATS = 32
    _TAU = 2.0 * math.pi

    def __init__(self, sample_rate: float = 48_000.0, capacity: int = 48_000):
        super().__init__(sample_rate, capacity, minimum=self.MIN_TIME_SAMPLES)
        self.time_mode = TimeMode.TIME

    def transform(self, n: float) -> float:
        if self.time_mode == TimeMode.TIME:
            # exp curve over [100, cap], linearly rescaled onto [2, cap]
            # (ref: OscilloscopeParameters.h:199-210 — n=0 gives a
            # 2-sample window, not 100)
            cap = self.capacity
            exp_samples = self.minimum * (cap / self.minimum) ** n
            frac = (exp_samples - self.minimum) / max(cap - self.minimum, 1e-9)
            return 2.0 + frac * (cap - 2.0)
        if self.time_mode == TimeMode.CYCLES:
            return 1.0 * self.MAX_CYCLES**n
        # BEATS: the transformed value is the beat DIVISION (denominator):
        # nextPow2Inc(round(32^(1-n))) (ref: :226-229)
        raw = int(round(self.MAX_BEATS ** (1.0 - n)))
        return float(self._next_pow2(max(raw, 1)))

    @staticmethod
    def _next_pow2(v: int) -> int:
        """Smallest power of two >= v (ref: cpl nextPow2Inc)."""
        return 1 << (v - 1).bit_length()

    def normalize(self, v: float) -> float:
        if self.time_mode == TimeMode.TIME:
            cap = self.capacity
            if cap <= self.minimum:
                # degenerate history (cap <= the 100-sample TIME floor):
                # transform() pins every n to ~the same window, so any
                # value normalizes to 0 rather than dividing by log(1)=0
                return 0.0
            v = max(2.0, min(v, cap))
            frac = (v - 2.0) / max(cap - 2.0, 1e-9)
            exp_samples = self.minimum + frac * (cap - self.minimum)
            return math.log(exp_samples / self.minimum) / math.log(cap / self.minimum)
        if self.time_mode == TimeMode.CYCLES:
            v = max(1.0, min(v, self.MAX_CYCLES))
            return math.log(v) / math.log(self.MAX_CYCLES)
        v = self._next_pow2(max(int(round(min(max(v, 1.0), self.MAX_BEATS))), 1))
        return 1.0 - math.log(v) / math.log(self.MAX_BEATS)

    def format(self, value: float) -> str:
        if self.time_mode == TimeMode.TIME:
            return super().format(value)
        if self.time_mode == TimeMode.CYCLES:
            # cycles with the radian equivalent in parens (ref: :100-104)
            return f"{value:.2f} ({self._TAU * value:.2f} r)"
        return f"1/{value:.0f}"  # beat division (ref: :106-110)

    def parse(self, text: str) -> Optional[float]:
        t = text.strip().lower()
        if self.time_mode == TimeMode.BEATS:
            # "1/8" fractions, optional "bars" (= 4 beats); the transformed
            # value is the reciprocal — the beat division (ref: :134-158)
            frac = re.match(r"\s*([-+0-9.e]+)\s*/\s*([-+0-9.e]+)", t)
            if frac:
                try:
                    v = float(frac.group(1)) / float(frac.group(2))
                except (ValueError, ZeroDivisionError):
                    return None
            else:
                m = re.match(r"\s*([-+0-9.e]+)", t)
                if not m:
                    return None
                try:
                    v = float(m.group(1))
                except ValueError:
                    return None
            if "bar" in t:
                v /= 4.0
            return 1.0 / v if v != 0 else None
        if self.time_mode == TimeMode.CYCLES:
            m = re.match(r"\s*([-+0-9.e]+)", t)
            if not m:
                return None
            try:
                v = float(m.group(1))
            except ValueError:
                return None
            if "r" in t:  # radians -> cycles (ref: :125-129)
                v /= self._TAU
            return v
        # TIME: the parent handles ms/s/smps and interprets a bare number
        # per the display mode (milliseconds by default)
        return super().parse(text)


_NOTE_OFFSETS = {"c": -9, "d": -7, "e": -5, "f": -4, "g": -2, "a": 0, "b": 2}
_NOTE_RE = re.compile(r"^([a-g])([#b]?)(-?\d+)$")


class LinearHzFormatter(Formatter):
    """Hz formatter that also parses musical notes and period units
    (ref: LinearHzFormatter, OscilloscopeParameters.h:247-347).

    Accepted: "440", "440 hz", "a4", "c#3", "eb2", "100 smps",
    "10 ms", "0.5 r" (radians/sample), "2 beats" (against bpm).
    """

    def __init__(self, sample_rate: float = 48_000.0, reference_tuning: float = 440.0,
                 bpm: float = 120.0):
        self.sample_rate = float(sample_rate)
        self.reference_tuning = float(reference_tuning)
        self.bpm = float(bpm)

    def format(self, value: float) -> str:
        return f"{value:.5g} Hz"

    def parse(self, text: str) -> Optional[float]:
        t = text.strip().lower().replace("hz", "").strip()
        m = _NOTE_RE.match(t.replace(" ", ""))
        if m:
            letter, accidental, octave = m.groups()
            semis = _NOTE_OFFSETS[letter]
            if accidental == "#":
                semis += 1
            elif accidental == "b":
                semis -= 1
            semis += (int(octave) - 4) * 12
            return self.reference_tuning * 2.0 ** (semis / 12.0)
        m = re.match(r"([-+0-9.e]+)\s*(smps|samples|ms|s|r|beats|bars)?$", t)
        if not m:
            return None
        try:
            v = float(m.group(1))
        except ValueError:
            return None
        unit = m.group(2)
        if unit in ("smps", "samples"):
            return self.sample_rate / v if v != 0 else None
        if unit == "ms":
            return 1000.0 / v if v != 0 else None
        if unit == "s":
            return 1.0 / v if v != 0 else None
        if unit == "r":
            # radians per sample -> Hz
            return v * self.sample_rate / (2.0 * math.pi)
        if unit in ("beats", "bars"):
            # beats -> Hz: v beats per minute-fraction (ref:
            # OscilloscopeParameters.h:331-334 — (v * bpm) / 60)
            return v * self.bpm / 60.0
        return v
