"""The traced run's record: the device's operations from one
``torch.profiler`` session over the measured window (CUDA activity only, so
that the host pays only CUPTI's cost a launch), and the harness's own host
spans around each call, read-back and wait.

The profiler stamps its events in nanoseconds of the system clock, the
clock of ``time.time_ns()``, which the spans use; :meth:`Trace.clock_check`
counts the read-back copies that would start before their own span, which
a skew between the two clocks would show. Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time

# device operations that are copies or fills, not kernels
_COPY = re.compile(r"^(Memcpy|Memset)")
_DTOH = re.compile(r"^Memcpy DtoH")


@dataclasses.dataclass
class Trace:
    """Times in seconds from the first host span's start."""

    device: list  # (name, start, end) of every device operation, by start
    host: list  # (name, start, end) of every harness span, by start
    window: tuple  # (start, end) of the traced window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> list:
        return [e for e in self.device if not _COPY.match(e[0])]

    def device_to_host(self) -> list:
        return [e for e in self.device if _DTOH.match(e[0])]

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        busy, reach = 0.0, self.window[0]
        for _, s, e in self.device:
            s, e = max(s, reach), min(e, self.window[1])
            if e > s:
                busy += e - s
                reach = e
        return busy

    def idle_gaps(self) -> list:
        """``(start, end)`` of each stretch of the window with nothing on the
        device."""
        gaps, reach = [], self.window[0]
        for _, s, e in self.device:
            if s > reach:
                gaps.append((reach, min(s, self.window[1])))
            reach = max(reach, e)
        if reach < self.window[1]:
            gaps.append((reach, self.window[1]))
        return [g for g in gaps if g[1] > g[0]]

    def host_activity(self, t: float) -> str:
        """The harness span running on the host at ``t``, or ``host`` for
        time outside every span (the harness's own Python)."""
        lo = bisect.bisect_right(self.host, t, key=lambda span: span[1])  # spans that start by t
        for name, s, e in reversed(self.host[max(0, lo - 4):lo]):
            if s <= t < e:
                return name
        return "host"

    def clock_check(self) -> dict:
        """Read-back copies that start before their own read-back span (the
        i-th copy against the i-th span), and the earliest device op's lead
        on the first span: both 0 where the clocks agree."""
        reads = [s for n, s, _ in self.host if n == "readback"]
        copies = [s for _, s, _ in self.device_to_host()]
        early = sum(1 for c, r in zip(copies, reads) if c < r)
        first = self.device[0][1] if self.device else 0.0
        return {"copies_before_their_span": early, "copies": len(copies), "first_op_s": first}

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing at each gap's middle, each in seconds."""
        ops = {}
        for name, s, e in self.device:
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + (e - s)
        gaps = {}
        for s, e in self.idle_gaps():
            key = self.host_activity((s + e) / 2)
            gaps[key] = gaps.get(key, 0.0) + (e - s)
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[k, v] for k, v in order(ops)], "idle_gaps": [[k, v] for k, v in order(gaps)]}


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    name = name.split("(anonymous namespace)::", 1)[-1]
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            if depth == 0 and ch == "(" and out:
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip().split("::")[-1][:80] or name[:80]


class Spans:
    """A context manager factory: ``with spans("call"): ...`` records
    ``(name, start_ns, end_ns)`` by ``time.time_ns()``."""

    def __init__(self):
        self.spans = []

    def __call__(self, name: str):
        return _Span(self.spans, name)


class _Span:
    __slots__ = ("spans", "name", "t0")

    def __init__(self, spans, name):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        self.spans.append((self.name, self.t0, time.time_ns()))


def _span(evt) -> tuple:
    start = evt.start_ns()
    end = evt.end_ns() if hasattr(evt, "end_ns") else start + evt.duration_ns()
    return start, end


def read(prof, spans: list) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` and the
    host ``spans`` recorded beside it."""
    from torch.autograd import DeviceType

    if not spans:
        raise RuntimeError("no host span: the traced window made no call")
    device = [(evt.name(),) + _span(evt) for evt in prof.profiler.kineto_results.events()
              if evt.device_type() == DeviceType.CUDA]
    t0 = min(s for _, s, _ in spans)
    end = max([e for _, _, e in spans] + [e for _, _, e in device])
    scale = lambda evs: sorted(((n, (s - t0) * 1e-9, (e - t0) * 1e-9) for n, s, e in evs), key=lambda x: x[1])  # noqa: E731
    return Trace(device=scale(device), host=scale(spans), window=(0.0, (end - t0) * 1e-9))
