"""The parameter system: transformers, formatters, parameters, sets, map.

Host-side equivalent of cpl's threaded parameter system as consumed by the
reference (ref: SURVEY.md §2.9 — cpl/infrastructure/parameters/
ParameterSystem.h; registration pattern at e.g.
Source/Spectrum/SpectrumParameters.h:93-223; flat host indexing via
ParameterMap, Source/Common/CommonSignalizer.h:852-919).

Threading model re-design: the reference's ThreadedParameter makes every
knob a lock-free cell because UI, host automation and the audio thread all
touch it concurrently. Here DSP is functional — kernels read immutable
Constants — so parameters only need (a) normalized<->value transforms,
(b) value<->text formatting, (c) change listeners with a UI-pump queue
(the pulseUI pattern) and (d) a monotonic change version (the reference's
ChangeVersion, CommonSignalizer.h:959-988) that reconfiguration keys off.
A plain lock suffices; the hot path never blocks on it.

The port's own copy of :mod:`signalizer_tpu.params.parameters`, arithmetic and names unchanged;
tests/test_torch_params_state.py holds the two equal.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# transformers (normalized [0,1] <-> transformed value)
# ---------------------------------------------------------------------------


class Transformer:
    def transform(self, normalized: float) -> float:
        raise NotImplementedError

    def normalize(self, value: float) -> float:
        raise NotImplementedError


class UnityRange(Transformer):
    def transform(self, n):
        return float(n)

    def normalize(self, v):
        return float(min(1.0, max(0.0, v)))


class ReverseUnityRange(Transformer):
    """transform(n) = 1 - n (ref: cpl reverseUnitRange(1, 0), used for
    ViewRight/ViewBottom so dragging 'outward' automates 0 -> 1)."""

    def transform(self, n):
        return 1.0 - float(min(1.0, max(0.0, n)))

    def normalize(self, v):
        return 1.0 - float(min(1.0, max(0.0, v)))


class LinearRange(Transformer):
    def __init__(self, lo: float, hi: float):
        self.lo, self.hi = float(lo), float(hi)

    def transform(self, n):
        return self.lo + n * (self.hi - self.lo)

    def normalize(self, v):
        n = (v - self.lo) / (self.hi - self.lo)
        return min(1.0, max(0.0, n))


class ExponentialRange(Transformer):
    """lo * (hi/lo)^n — both ends must share sign and be nonzero."""

    def __init__(self, lo: float, hi: float):
        if lo == 0 or hi == 0 or (lo < 0) != (hi < 0):
            raise ValueError("exponential range needs same-signed nonzero ends")
        self.lo, self.hi = float(lo), float(hi)

    def transform(self, n):
        return self.lo * (self.hi / self.lo) ** n

    def normalize(self, v):
        # clamp into the (same-signed) range first: out-of-domain input
        # (e.g. a user typing "0" into a 20..20k Hz knob) must clamp like
        # the linear ranges do, not raise out of set_from_text
        if (v / self.lo) <= 0:
            return 0.0
        n = math.log(v / self.lo) / math.log(self.hi / self.lo)
        return min(1.0, max(0.0, n))


class BooleanRange(Transformer):
    def transform(self, n):
        return 1.0 if n > 0.5 else 0.0

    def normalize(self, v):
        return 1.0 if v > 0.5 else 0.0


class IntegerLinearRange(Transformer):
    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = int(lo), int(hi)

    def transform(self, n):
        return float(self.lo + round(n * (self.hi - self.lo)))

    def normalize(self, v):
        if self.hi == self.lo:
            return 0.0
        n = (v - self.lo) / (self.hi - self.lo)
        return min(1.0, max(0.0, n))


# ---------------------------------------------------------------------------
# formatters (value <-> text)
# ---------------------------------------------------------------------------


class Formatter:
    def format(self, value: float) -> str:
        raise NotImplementedError

    def parse(self, text: str) -> Optional[float]:
        try:
            return float(text.strip().split()[0])
        except (ValueError, IndexError):
            return None


class BasicFormatter(Formatter):
    def __init__(self, digits: int = 3):
        self.digits = digits

    def format(self, value):
        return f"{value:.{self.digits}g}"


class UnitFormatter(BasicFormatter):
    def __init__(self, unit: str, digits: int = 3):
        super().__init__(digits)
        self.unit = unit

    def format(self, value):
        return f"{super().format(value)} {self.unit}"


class DBFormatter(UnitFormatter):
    def __init__(self, digits: int = 2):
        super().__init__("dB", digits)


class AmplitudeDBFormatter(Formatter):
    """LINEAR-amplitude value displayed/parsed in dB (ref: cpl dbFormatter
    over linear ranges — e.g. the trigger threshold, amplitude 0..4 shown
    as dB; the line decay fraction shown as dB/s)."""

    def __init__(self, unit: str = "dB", digits: int = 2):
        self.unit = unit
        self.digits = digits

    def format(self, value):
        if value <= 0:
            return f"-inf {self.unit}"
        return f"{20.0 * math.log10(value):.{self.digits}f} {self.unit}"

    def parse(self, text):
        t = text.strip().lower()
        for suffix in (self.unit.lower(), "db"):
            if t.endswith(suffix):
                t = t[: -len(suffix)].strip()
                break
        try:
            return 10.0 ** (float(t) / 20.0)
        except ValueError:
            return None


class PercentageFormatter(Formatter):
    """Shows a [0,1] value as percent."""

    def format(self, value):
        return f"{value * 100:.1f} %"

    def parse(self, text):
        v = super().parse(text)
        return None if v is None else v / 100.0


class IntegerFormatter(Formatter):
    def format(self, value):
        return str(int(round(value)))


class BooleanFormatter(Formatter):
    def format(self, value):
        return "on" if value > 0.5 else "off"

    def parse(self, text):
        t = text.strip().lower()
        if t in ("on", "true", "yes", "1"):
            return 1.0
        if t in ("off", "false", "no", "0"):
            return 0.0
        return super().parse(text)


class ChoiceFormatter(Formatter):
    """Named options; pairs with IntegerLinearRange(0, len-1)
    (ref: cpl ChoiceFormatter/ChoiceTransformer)."""

    def __init__(self, options: Sequence[str]):
        self.options = list(options)

    def format(self, value):
        i = int(round(value))
        return self.options[min(max(i, 0), len(self.options) - 1)]

    def parse(self, text):
        t = text.strip().lower()
        for i, o in enumerate(self.options):
            if o.lower() == t:
                return float(i)
        return super().parse(text)


# ---------------------------------------------------------------------------
# parameter
# ---------------------------------------------------------------------------

# listener(parameter, source) — source in {"ui", "host", "processor", "text"}
Listener = Callable[["Parameter", str], None]


class Parameter:
    """One automatable knob (ref: cpl FormattedParameter/ThreadedParameter;
    view API: getValueNormalized/Transformed, updateFromUINormalized,
    updateFromHostNormalized, getExportedName, getDisplayText)."""

    def __init__(
        self,
        name: str,
        transformer: Transformer = None,
        formatter: Formatter = None,
        default: float = 0.0,
    ):
        self.name = name
        self.transformer = transformer or UnityRange()
        self.formatter = formatter or BasicFormatter()
        self._normalized = float(default)
        self._version = 0
        self._lock = threading.Lock()
        self._rt_listeners: List[Listener] = []
        self._ui_listeners: List[Listener] = []
        self._pending_ui = False
        self.exported_name = name  # prefixed at registration

    # --- values -----------------------------------------------------------
    @property
    def version(self) -> int:
        return self._version

    def get_normalized(self) -> float:
        return self._normalized

    def get_transformed(self) -> float:
        return self.transformer.transform(self._normalized)

    def _set(self, normalized: float, source: str) -> None:
        normalized = min(1.0, max(0.0, float(normalized)))
        with self._lock:
            changed = normalized != self._normalized
            self._normalized = normalized
            if changed:
                self._version += 1
                self._pending_ui = True
                rt = list(self._rt_listeners)
            else:
                rt = []
        for l in rt:
            l(self, source)

    def set_normalized(self, n: float, source: str = "ui") -> None:
        self._set(n, source)

    def set_transformed(self, value: float, source: str = "ui") -> None:
        self._set(self.transformer.normalize(value), source)

    def update_from_host_normalized(self, n: float) -> None:
        self._set(n, "host")

    def update_from_ui_normalized(self, n: float) -> None:
        self._set(n, "ui")

    def update_from_processor_normalized(self, n: float) -> None:
        self._set(n, "processor")

    # --- text -------------------------------------------------------------
    def get_display_text(self) -> str:
        return self.formatter.format(self.get_transformed())

    def set_from_text(self, text: str) -> bool:
        v = self.formatter.parse(text)
        if v is None:
            return False
        self.set_transformed(v, "text")
        return True

    # --- listeners ----------------------------------------------------------
    def add_rt_listener(self, l: Listener) -> None:
        self._rt_listeners.append(l)

    def add_ui_listener(self, l: Listener) -> None:
        self._ui_listeners.append(l)

    def pulse_ui(self) -> None:
        """Deliver coalesced UI notifications (ref: pulseUI pattern)."""
        if self._pending_ui:
            self._pending_ui = False
            for l in self._ui_listeners:
                l(self, "pulse")


class ParameterSet:
    """Named, prefixed group (ref: ParameterGroup; prefixes "SC."/"OS."/
    "VS." per view, e.g. SpectrumParameters.h registration)."""

    def __init__(self, name: str, prefix: str = ""):
        self.name = name
        self.prefix = prefix
        self._params: List[Parameter] = []
        self._by_name: Dict[str, Parameter] = {}
        self._sealed = False

    def register_parameter(self, p: Parameter) -> Parameter:
        if self._sealed:
            raise RuntimeError("parameter set is sealed")
        p.exported_name = self.prefix + p.name
        self._params.append(p)
        self._by_name[p.name] = p
        return p

    def register_bundle(self, bundle) -> object:
        """Register every Parameter a bundle exposes via .parameters()."""
        for p in bundle.parameters():
            self.register_parameter(p)
        return bundle

    def seal(self) -> None:
        self._sealed = True

    def __len__(self) -> int:
        return len(self._params)

    def __iter__(self):
        return iter(self._params)

    def at(self, index: int) -> Parameter:
        return self._params[index]

    def find(self, name: str) -> Optional[Parameter]:
        return self._by_name.get(name) or next(
            (p for p in self._params if p.exported_name == name), None
        )

    def pulse_ui(self) -> None:
        for p in self._params:
            p.pulse_ui()


class ParameterMap:
    """Ordered map of named sets with flat global indexing for the host
    (ref: ParameterMap::findParameter walking sets,
    CommonSignalizer.h:852-919)."""

    def __init__(self):
        self._sets: List[ParameterSet] = []

    def add_set(self, s: ParameterSet) -> ParameterSet:
        self._sets.append(s)
        return s

    def get_set(self, name: str) -> Optional[ParameterSet]:
        return next((s for s in self._sets if s.name == name), None)

    @property
    def sets(self) -> Tuple[ParameterSet, ...]:
        return tuple(self._sets)

    def num_parameters(self) -> int:
        return sum(len(s) for s in self._sets)

    def find_parameter(self, flat_index: int) -> Parameter:
        for s in self._sets:
            if flat_index < len(s):
                return s.at(flat_index)
            flat_index -= len(s)
        raise IndexError(flat_index)

    def flat_index_of(self, param: Parameter) -> int:
        i = 0
        for s in self._sets:
            for p in s:
                if p is param:
                    return i
                i += 1
        raise ValueError(param.name)

    def pulse_ui(self) -> None:
        for s in self._sets:
            s.pulse_ui()
