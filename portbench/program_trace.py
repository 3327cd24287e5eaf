"""One traced run of a cell, with the program's own spans laid on the
device's timeline: where the idle time of the call goes, span by span.

    python3 -m portbench.program_trace --workload <cell> --seed <n> --seconds <s>

A tool for work on the program, never a run of the benchmark: it runs the
cell as ``python3 -m portbench.run ... --trace 1`` does and prints the
result line with a ``program_trace`` object beside the harness's entries:

* ``clock``: how the profiler's clocks sit against the host's. The
  program stamps its spans on the host's clock (Unix time); the profiler
  stamps each kernel launch (the CUDA runtime's call, on the host) and each
  device operation on clocks of its own, which may step within a session.
  Each launch of kernel A or B happens inside its ``kernel.<wrapper>`` span
  and its kernel starts after it, so for each twentieth of the window the
  tool takes the offset that keeps that stretch's launches inside their
  spans (``host_offset_us``; ``launches_outside`` counts those it cannot)
  and the least delay from a launch to its kernel (``device_offset_us``:
  an idle device starts a kernel within microseconds). The least, median
  and largest of both delays by tenths of the window show the raw clocks.
* ``before``/``after``: on the raw clocks and after that alignment, the
  kernels A and B that start before the span that launched them
  (``kernels_before_their_span``) and the read-back copies that start
  before their own read-back span (``copies_before_their_span``).
* ``idle_gaps``: seconds of the window with nothing on the device, by the
  harness span at the gap's middle and the innermost program span there
  (``call/colormap``); ``host`` is time outside every harness span.
* ``spans_us``: each program span's mean a call of the window, and the
  processor span's self time, beside ``processor.host_us``.

A program that records no span (an older one) gives the harness's part
alone.
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import statistics
import sys
import time
import types

from portbench import program_spans
from portbench import trace as tracing

_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
KERNELS = {"window_fft_mag_kernel": "kernel.window_fft_mag", "display_map_kernel": "kernel.display_map"}


def _events(prof) -> dict:
    """The profiler's device operations and the host's kernel launches, in
    nanoseconds of its clock, with their correlation ids."""
    from torch.autograd import DeviceType

    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), start, end, e.correlation_id()))
        elif e.name() in _LAUNCH:
            launches[e.correlation_id()] = (start, end)
    device.sort(key=lambda x: x[1])
    return {"device": device, "launches": launches}


def _segments(xs, ys, span_s, parts):
    """``ys`` split by time into ``parts`` equal stretches of the window."""
    out = [[] for _ in range(parts)]
    for x, y in zip(xs, ys):
        out[min(parts - 1, int(x / span_s * parts)) if span_s > 0 else 0].append((x, y))
    return [seg for seg in out if seg]


def _deciles(xs, ys, span_s):
    """Least, median and largest of ``ys`` in each tenth of the window, in
    microseconds."""
    return [[round(v / 1e3, 1) for v in (min(y), statistics.median(y), max(y))]
            for y in ([y for _, y in seg] for seg in _segments(xs, ys, span_s, 10))]


def _innermost(spans, starts, t):
    """The innermost span of ``spans`` (by start, properly nested) that
    holds ``t``: the last to start by ``t`` or its first ancestor still
    open at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if t < spans[i][2]:
            return spans[i]
        i = spans[i][3]
    return None


def analyse(events: dict, host: list, program: list) -> dict:
    """The ``program_trace`` object from the profiler's ``events``, the
    harness's spans ``host`` and the program's spans ``program``, all in
    nanoseconds of the Unix epoch (each on its own clock)."""
    t0 = min(s for _, s, _ in host)
    window = [s for s in program if s[1] >= t0]
    offset = len(program) - len(window)
    window = [(n, s, e, p - offset if p >= offset else -1) for n, s, e, p in window]
    out = {"program_spans": len(window)}

    # the launches of A and B against the spans that launched them, by order
    pairs = []
    for kernel, span_name in KERNELS.items():
        pattern = re.compile(rf"\b{kernel}\b")
        ops = [op for op in events["device"] if pattern.search(op[0]) and op[1] >= t0]
        spans = [s for s in window if s[0] == span_name]
        n = min(len(ops), len(spans))
        for op, sp in zip(ops[-n:], spans[-n:]):
            launch = events["launches"].get(op[3])
            if launch is not None:
                pairs.append((sp, launch, op))
    out["launches_matched"] = len(pairs)

    def counts(shift):
        before = sum(1 for sp, _, op in pairs if shift(op[1]) < sp[1])
        reads = [s for n, s, _ in host if n == "readback"]
        copies = [shift(s) for n, s, _, _ in events["device"] if n.startswith("Memcpy DtoH") and s >= t0]
        early = sum(1 for c, r in zip(copies, reads) if c < r)
        return {"kernels_before_their_span": before, "kernels": len(pairs), "copies_before_their_span": early,
                "copies": len(copies)}

    out["before"] = counts(lambda t: t)
    if not pairs:
        return out
    xs = [(sp[1] - t0) * 1e-9 for sp, _, _ in pairs]
    d = [launch[0] - sp[1] for sp, launch, _ in pairs]  # the launch's start into its span
    f = [launch[1] - sp[2] for sp, launch, _ in pairs]  # its end past the span's end
    e = [op[1] - launch[1] for _, launch, op in pairs]  # the kernel's start after its launch
    span_s = (max(e for _, _, e in host) - t0) * 1e-9
    parts = 20

    def part(t):
        return min(parts - 1, max(0, int((t - t0) * 1e-9 / span_s * parts))) if span_s > 0 else 0

    seg = [part(sp[1]) for sp, _, _ in pairs]

    # each twentieth of the window on its own, since the profiler's clocks
    # step within a session: the profiler's host clock against the program's
    # (the middle of what keeps that stretch's launches inside their spans),
    # and the device's against the profiler's host clock (the least delay
    # from a launch to its kernel, which an idle device makes ~0)
    host_off, dev_off, infeasible = [None] * parts, [None] * parts, 0
    for k in range(parts):
        idx = [i for i, s in enumerate(seg) if s == k]
        if not idx:
            continue
        lo, hi = max(f[i] for i in idx), min(d[i] for i in idx)
        if lo > hi:
            infeasible += 1
        host_off[k] = (lo + hi) / 2 if lo <= hi else statistics.median(d[i] for i in idx)
        dev_off[k] = min(e[i] for i in idx)
    for offs in (host_off, dev_off):  # a stretch without a launch takes its nearest neighbour's
        known = [k for k in range(parts) if offs[k] is not None]
        for k in range(parts):
            offs[k] = offs[min(known, key=lambda j: abs(j - k))]

    def host_shift(t):
        return t - host_off[part(t)]

    def shift(t):
        return host_shift(t - dev_off[part(t)])

    outside = sum(1 for sp, launch, _ in pairs if host_shift(launch[0]) < sp[1] or host_shift(launch[1]) > sp[2])
    us = lambda v: [round(x / 1e3, 1) for x in v]  # noqa: E731
    out["clock"] = {
        "host_offset_us": us(host_off), "device_offset_us": us(dev_off),
        "stretches_without_a_common_offset": infeasible, "launches_outside": outside,
        "launch_into_span_us": _deciles(xs, d, span_s),
        "kernel_after_launch_us": _deciles(xs, e, span_s),
    }
    out["after"] = counts(shift)

    # idle gaps on the host's clock, named by the harness span and the
    # innermost program span at each gap's middle
    device = sorted((shift(s), shift(e)) for _, s, e, _ in events["device"] if s >= t0)
    end = max(max(e for _, _, e in host), device[-1][1] if device else t0)
    host_sorted = sorted(host, key=lambda x: x[1])
    host_starts = [s for _, s, _ in host_sorted]
    starts = [s[1] for s in window]
    gaps, reach = {}, t0
    for s, e in device + [(end, end)]:
        if s > reach:
            mid = (reach + s) / 2
            i = bisect.bisect_right(host_starts, mid) - 1
            outer = "host"
            if i >= 0 and host_sorted[i][1] <= mid < host_sorted[i][2]:
                outer = host_sorted[i][0]
            inner = _innermost(window, starts, mid)
            key = f"{outer}/{inner[0]}" if inner is not None else outer
            gaps[key] = gaps.get(key, 0.0) + (s - reach) * 1e-9
        reach = max(reach, e)
    out["idle_gaps"] = sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])
    out["idle_s"] = sum(gaps.values())
    return out


def spans_us(program: list, calls: int, host_us: float = None) -> dict:
    """Each span's mean a call over the window's last ``calls`` processor
    calls, the processor's self time, and ``processor.host_us`` beside."""
    rec = types.SimpleNamespace(calls=calls)
    per_call = program_spans.window_calls(rec, program)
    if not per_call:
        return {}
    names = sorted({n for _, kids in per_call for n in kids})
    out = {n: program_spans.mean_us(rec, (n,), program) for n in names}
    out["processor"] = sum(t for t, _ in per_call) / len(per_call) / 1e3
    out["processor.self"] = program_spans.self_us(rec, program)
    if host_us is not None:
        out["processor.host_us"] = host_us
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.program_trace", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    from portbench import run

    run._fixed_caches(run.ROOT)
    from portbench.harness import Bench, run_cell

    captured = {}
    read = tracing.read

    def capture(prof, spans):
        captured["events"] = _events(prof)
        captured["host"] = list(spans)
        return read(prof, spans)

    tracing.read = capture
    try:
        result = run_cell(args.workload, args.seed, args.seconds, True, "cuda", bench=Bench(run.ROOT),
                          t_start=t_start)
    finally:
        tracing.read = read
    program = program_spans.read_spans() or []
    host_us = result["metrics"].get("processor.host_us", {}).get("value")
    extra = analyse(captured["events"], captured["host"], program) if "events" in captured else {}
    extra["spans_us"] = spans_us(program, result["attempted"], host_us) if program else {}
    result["program_trace"] = extra
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
