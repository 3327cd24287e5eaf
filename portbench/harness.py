"""One run of one cell: set-up, warm-up, the measured window, the check of
what the window produced, and the result line.

Everything the harness knows of a cell it finds by name:
``BENCHMARK.json`` names the cell's configuration and traffic mix;
``configs/<config>.json`` holds the configuration's sizes and
``configs/<config>.py`` its session class and how to build the program;
``traffic/<traffic>.json`` the mix's parameters; ``limits/<cell>.json`` the
limit of each number the check compares; ``metrics/<metric>.py`` the reader
of each metric. Adding a cell or a metric adds files and touches none.

The window is a closed loop with ``in_flight`` calls outstanding: each
call's newest display data is copied to pinned host memory behind it, and
the next call is handed to the program as soon as the oldest one's copy has
landed. A call's latency runs from handing it to the program to its data on
the host.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import random
import subprocess
import time
from pathlib import Path

import torch

from portbench import trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def metrics_for(self, cell: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
        return [m for m in self.spec[kind] if cell in m.get("workloads", [cell])]

    def files(self, cell: dict) -> dict:
        """The files a cell needs, by role; raises naming any that is
        missing."""
        entry = self.config(cell["config"])
        here = self.root / "portbench"
        paths = {
            "config": self.root / entry["file"],
            "session": here / "configs" / f"{entry['name']}.py",
            "traffic": here / "traffic" / f"{cell['traffic']}.json",
            "limits": here / "limits" / f"{cell['name']}.json",
        }
        for kind in ("end_to_end", "per_layer"):
            for m in self.metrics_for(cell["name"], kind):
                paths[f"metric {m['name']}"] = here / "metrics" / f"{m['name']}.py"
        missing = [f"{role}: {p}" for role, p in paths.items() if not p.is_file()]
        if missing:
            raise FileNotFoundError(f"workload {cell['name']!r} needs " + "; ".join(missing))
        return paths


def load_module(path: Path):
    """A module from a file whose name need not be an identifier."""
    name = "portbench_file_" + "".join(ch if ch.isalnum() else "_" for ch in f"{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Record:
    """What the window measured; the metric readers take their numbers
    from it. Times in seconds; ``work`` is each stage's least work a call."""

    calls: int
    frames: int
    window_s: float
    latencies_s: list
    host_call_s: list
    setup_s: float
    work: dict
    trace: tracing.Trace | None = None


class _NoEvent:
    """A CPU run's stand-in for a CUDA event: the work is done already."""

    def record(self):
        pass

    def synchronize(self):
        pass


class Keeper:
    """The outputs that the check compares: the first call's, a sample of
    ``m`` window calls drawn from the seed (reservoir sampling over a window
    of unknown length), and the window's last; with each one's read-back
    host copy."""

    def __init__(self, seed: int, m: int):
        self.rng = random.Random(seed)
        self.m = m
        self.sample = []
        self.outputs, self.host = {}, {}
        self.last = None

    def keep(self, k, out, buf):
        self.outputs[k] = out
        self.host[k] = buf.numpy().copy()

    def offer(self, i: int, k: int, out, buf):
        """Window call ``k``, the ``i``-th of the window, has landed in ``buf``."""
        self.last = (k, out, buf)
        if i < self.m:
            self.sample.append(k)
        else:
            r = self.rng.randrange(i + 1)
            if r >= self.m:
                return
            old = self.sample[r]
            self.outputs.pop(old, None)
            self.host.pop(old, None)
            self.sample[r] = k
        self.keep(k, out, buf)


def _loop(session, in_flight: int, first: int, stop, span, dev, on_done, bufs: list, events: list):
    """Calls ``first``, ``first + 1``, ... with ``in_flight`` outstanding
    until ``stop(calls_issued)`` is true; then drains. ``bufs`` and
    ``events`` (pinned host buffers and CUDA events, a slot each) are
    filled on first use and kept for the next loop. Returns the calls made,
    each call's latency and host seconds, and the window (from the first
    hand-off to the last landing)."""
    cuda = dev.type == "cuda"
    q = collections.deque()
    lat, host = [], []
    k = first
    t_first = t_last = None
    while True:
        if len(q) < in_flight and not stop(k - first):
            slot = k % in_flight
            x = session.inputs(k)
            with span("call"):
                t_hand = time.perf_counter()
                out = session.step(x)
                host.append(time.perf_counter() - t_hand)
            src = session.readback_source(out)
            if len(bufs) < in_flight:
                bufs.append(torch.empty(src.shape, dtype=src.dtype, pin_memory=cuda))
                events.append(torch.cuda.Event() if cuda else _NoEvent())
            with span("readback"):
                bufs[slot].copy_(src, non_blocking=True)
                events[slot].record()
            q.append((k, t_hand, slot, out))
            t_first = t_hand if t_first is None else t_first
            k += 1
        elif q:
            kk, t_hand, slot, out = q.popleft()
            with span("wait"):
                events[slot].synchronize()
            t_last = time.perf_counter()
            lat.append(t_last - t_hand)
            on_done(kk - first, kk, out, bufs[slot])
        else:
            break
    return k - first, lat, host, (t_last - t_first) if lat else 0.0


def _untraced(name: str):
    return contextlib.nullcontext()


def _until(seconds: float):
    """A ``stop`` for :func:`_loop` that is true ``seconds`` after it is
    first asked, at the window's first call."""
    end = []

    def stop(n: int) -> bool:
        now = time.perf_counter()
        if not end:
            end.append(now + seconds)
        return now >= end[0]

    return stop


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda", *, bench: Bench = None,
             program=None, overrides=None, t_start: float = None) -> dict:
    """One run of ``workload``; returns the result line as a dict, the
    compared numbers under ``checks``, last. ``program`` (``"control"`` or a
    stand-in object) and ``overrides`` (a function given the configuration
    and the traffic to change in place) serve the benchmark's
    own tests and its control; a run of the benchmark passes neither."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or Bench()
    cell = bench.cell(workload)
    paths = bench.files(cell)
    cfg = json.loads(paths["config"].read_text())
    traffic = json.loads(paths["traffic"].read_text())
    limits = json.loads(paths["limits"].read_text())
    if overrides is not None:
        overrides(cfg, traffic)
    mod = load_module(paths["session"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    phases = {"imports_s": time.perf_counter() - t_start}
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=dev)
    phases["context_s"] = time.perf_counter() - t_start
    session = mod.SESSION(cfg, traffic, dev, seed, program=program, build=mod.build)
    phases["session_s"] = time.perf_counter() - t_start
    in_flight = int(traffic["in_flight"])
    keeper = Keeper(seed, int(traffic["checked_calls"]))

    # warm-up: every shape the window uses, the first call's output kept
    def warm(i, k, out, buf):
        if k == 0:
            keeper.keep(k, out, buf)

    warmup = int(traffic["warmup_calls"])
    bufs, events = [], []
    first, _, _, _ = _loop(session, in_flight, 0, lambda n: n >= warmup, _untraced, dev, warm, bufs, events)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # the profiler's first start loads and sets up CUPTI, seconds on some
        # machines: paid here, not in the window
        with profile(activities=[ProfilerActivity.CUDA]):
            n, _, _, _ = _loop(session, in_flight, first, lambda n: n >= in_flight, tracing.Spans(), dev,
                               lambda *a: None, bufs, events)
        first += n
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    phases["warmup_s"] = setup_s

    tr = None
    stop = _until(seconds)
    gc.collect()
    gc.disable()
    try:
        if trace:
            spans = tracing.Spans()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                calls, lat, host, window_s = _loop(session, in_flight, first, stop, spans, dev, keeper.offer,
                                                   bufs, events)
        else:
            calls, lat, host, window_s = _loop(session, in_flight, first, stop, _untraced, dev, keeper.offer,
                                               bufs, events)
    finally:
        gc.enable()
    first += calls
    if trace:
        tr = tracing.read(prof, spans.spans)
        del prof
        if not tr.kernels():
            raise RuntimeError("the profiler recorded no kernel in the traced window")
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    keeper.keep(*keeper.last)  # its slot's buffer is not written again
    final = session.final_state()
    work = session.work()
    session.program = None  # the program's state is freed before the reference runs
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    numbers = session.check(keeper.outputs, keeper.host, final, first)
    checks = {name: {"value": v, "limit": limits[name]} for name, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    record = Record(calls=calls, frames=calls * session.frames_per_call, window_s=window_s, latencies_s=lat,
                    host_call_s=host, setup_s=setup_s, work=work, trace=tr)
    metrics = {}
    for m in bench.metrics_for(workload, "per_layer" if trace else "end_to_end"):
        value = load_module(paths[f"metric {m['name']}"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(memory_peak),
    }
    result = {"correct": correct, "attempted": calls, "failed": 0, "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["card"] = _card_line() if cuda else "cpu"
    result["setup_phases_s"] = phases  # the time since the start at the end of each phase
    if tr is not None:
        result["trace_clock"] = tr.clock_check()
    result["checks"] = checks
    return result
