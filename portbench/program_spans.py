"""The program's own spans over a traced window, for the readers of the
``program_span`` metrics.

While a ``torch.profiler`` session runs, the program records a span at each
of its layer boundaries (``signalizer_tpu_torch.utils.diagnostics.span``):
the processor's call (``spectrum.process``, ``spectrogram.step``), and under
it the device ring (``ring.update``, ``ring.frames``), each kernel wrapper's
entry (``kernel.<wrapper>``) and the colour map (``colormap``). After the
window the harness's readers take them from the program's ring of records:
the window's calls are the last ``record.calls`` processor spans (the window
is the last that calls the program under the profiler), each with the spans
directly under it. A program that records no span (an older one) gives
``None``, and the metric is left out of the line.
"""

from __future__ import annotations

PROCESSORS = ("spectrum.process", "spectrogram.step")


def read_spans() -> list:
    """The program's closed spans, oldest first, as ``(name, start_ns,
    end_ns, parent index)``; ``None`` where the program has no span
    record."""
    try:
        from signalizer_tpu_torch.utils import diagnostics
    except ImportError:
        return None
    spans = getattr(diagnostics, "spans", None)
    return None if spans is None else spans()


def _roots(record, records) -> list:
    """The indices of the window's processor spans: the last
    ``record.calls`` of them."""
    if not records or not record.calls:
        return []
    return [i for i, s in enumerate(records) if s[3] < 0 and s[0] in PROCESSORS][-record.calls:]


def window_calls(record, spans=None) -> list:
    """Per call of the window, ``(processor ns, {child name: ns})``: the
    processor span's duration and the summed durations of the spans
    directly under it, by name. ``None`` where the program recorded no
    processor span."""
    records = read_spans() if spans is None else spans
    roots = _roots(record, records)
    if not roots:
        return None
    children = {i: {} for i in roots}
    first = roots[0]
    for s in records[first:]:
        kids = children.get(s[3])
        if kids is not None:
            kids[s[0]] = kids.get(s[0], 0) + (s[2] - s[1])
    return [(records[i][2] - records[i][1], children[i]) for i in roots]


def mean_us(record, names, spans=None) -> float:
    """The mean a call of the window, in microseconds, of the spans named
    ``names`` directly under the processor span; ``None`` where the
    program recorded none of them."""
    calls = window_calls(record, spans)
    if not calls or not any(n in kids for _, kids in calls for n in names):
        return None
    return sum(kids.get(n, 0) for _, kids in calls for n in names) / len(calls) / 1e3


def self_us(record, spans=None) -> float:
    """The processor span's self time (the program's ``diagnostics.self_ns``:
    its duration less the spans directly under it), mean a call of the
    window in microseconds."""
    records = read_spans() if spans is None else spans
    roots = _roots(record, records)
    if not roots:
        return None
    from signalizer_tpu_torch.utils.diagnostics import self_ns

    own = self_ns(records)
    return sum(own[i] for i in roots) / len(roots) / 1e3
