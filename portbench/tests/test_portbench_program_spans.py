"""The readers of the program's spans on made-up records, on the program's
own spans from CPU calls, and the idle time of a made-up timeline named by
the program span it falls in."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, program_spans, program_trace
from portbench.harness import load_module

US = 1000  # ns


def _spans():
    """Three calls of a spectrogram step (the first a warm-up call before
    the window) as the program's ring reads them: (name, start, end,
    parent index)."""
    out = []
    for call, t in enumerate((0, 10_000 * US, 20_000 * US)):
        root = len(out)
        out.append(("spectrogram.step", t, t + 1000 * US, -1))
        out.append(("ring.update", t + 10 * US, t + 60 * US, root))
        out.append(("ring.frames", t + 60 * US, t + 100 * US, root))
        out.append(("kernel.window_fft_mag", t + 100 * US, t + 150 * US, root))
        out.append(("kernel.display_map", t + 150 * US, t + 250 * US + call * 10 * US, root))
        out.append(("colormap", t + 300 * US, t + 900 * US, root))
        out.append(("kernel.inner", t + 320 * US, t + 330 * US, len(out) - 1))  # under colormap
    return out


READERS = {"ring.host_us": 90.0, "colormap.host_us": 600.0, "window_fft_mag.host_us": 50.0,
           "display_map.host_us": 115.0, "processor.self_host_us": 145.0}


@pytest.mark.parametrize("name,want", sorted(READERS.items()))
def test_program_span_readers(name, want, monkeypatch):
    monkeypatch.setattr(program_spans, "read_spans", _spans)
    mod = load_module(harness.HERE / "metrics" / f"{name}.py")
    assert mod.read(types.SimpleNamespace(calls=2)) == pytest.approx(want)


def test_the_five_add_up_to_the_processor_span(monkeypatch):
    monkeypatch.setattr(program_spans, "read_spans", _spans)
    rec = types.SimpleNamespace(calls=2)
    total = sum(load_module(harness.HERE / "metrics" / f"{name}.py").read(rec) for name in READERS)
    assert total == pytest.approx(1000.0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_program_without_spans_gives_none(name, monkeypatch):
    mod = load_module(harness.HERE / "metrics" / f"{name}.py")
    monkeypatch.setattr(program_spans, "read_spans", lambda: None)
    assert mod.read(types.SimpleNamespace(calls=2)) is None
    monkeypatch.setattr(program_spans, "read_spans", lambda: [("other", 0, 1, -1)])
    assert mod.read(types.SimpleNamespace(calls=2)) is None


def test_the_headline_has_no_colour_map(monkeypatch):
    spans = []
    for t in (0, 10_000 * US):
        root = len(spans)
        spans.append(("spectrum.process", t, t + 400 * US, -1))
        spans.append(("ring.frames", t + 10 * US, t + 50 * US, root))
        spans.append(("kernel.window_fft_mag", t + 50 * US, t + 100 * US, root))
        spans.append(("kernel.display_map", t + 100 * US, t + 215 * US, root))
    monkeypatch.setattr(program_spans, "read_spans", lambda: spans)
    rec = types.SimpleNamespace(calls=2)
    read = {name: load_module(harness.HERE / "metrics" / f"{name}.py").read(rec) for name in READERS}
    assert read == pytest.approx({"ring.host_us": 40.0, "colormap.host_us": None, "window_fft_mag.host_us": 50.0,
                                  "display_map.host_us": 115.0, "processor.self_host_us": 195.0})


def test_readers_on_the_programs_own_spans():
    """Spectrum calls on the CPU under the profiler: the window's calls are
    the last ones, and the parts add up to the processor's span."""
    from signalizer_tpu_torch import SpectrumProcessor
    from signalizer_tpu_torch.utils import diagnostics

    p = SpectrumProcessor.create(pairs=2, device="cpu", axis_points=32, window_size=128)
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 2, 128)).astype(np.float32))
    diagnostics.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            p.process(frames)
    rec = types.SimpleNamespace(calls=3)
    calls = program_spans.window_calls(rec)
    assert len(calls) == 3
    assert all(set(kids) == {"ring.frames", "kernel.window_fft_mag", "kernel.display_map"} for _, kids in calls)
    parts = sum(program_spans.mean_us(rec, (n,)) for n in ("ring.frames", "kernel.window_fft_mag",
                                                          "kernel.display_map"))
    total = sum(t for t, _ in calls) / 3 / 1e3
    assert parts + program_spans.self_us(rec) == pytest.approx(total)
    assert program_spans.mean_us(rec, ("colormap",)) is None


def test_an_idle_gap_inside_a_program_span_is_named_by_it():
    """On one clock: a gap while the host runs the colour map inside a
    call is ``call/colormap``; one in the harness's wait, ``wait``; the
    launches fall in their spans and nothing starts before its span."""
    ms = 1_000_000
    host = [("call", 0, 10 * ms), ("readback", 10 * ms, 11 * ms), ("wait", 11 * ms, 20 * ms)]
    program = [("spectrogram.step", 1 * ms, int(9.8 * ms), -1), ("kernel.window_fft_mag", 2 * ms, 3 * ms, 0),
               ("kernel.display_map", 3 * ms, 4 * ms, 0), ("colormap", 5 * ms, int(9.5 * ms), 0)]
    events = {
        "device": [("window_fft_mag_kernel", int(2.5 * ms), 3 * ms, 1),
                   ("display_map_kernel", int(3.5 * ms), int(5.5 * ms), 2),
                   ("Memcpy DtoH (Device -> Pinned)", int(10.5 * ms), 12 * ms, 3)],
        "launches": {1: (int(2.4 * ms), int(2.5 * ms)), 2: (int(3.4 * ms), int(3.5 * ms))},
    }
    out = program_trace.analyse(events, host, program)
    # the launches sit 0.4 ms into their spans: the profiler's clock is put
    # 0.05 ms later, in the middle of what keeps both launches in their spans;
    # each kernel starts as its launch ends, so the device's clock is the
    # profiler's host clock
    clock = out["clock"]
    assert out["launches_matched"] == 2 and clock["launches_outside"] == 0
    assert clock["host_offset_us"][1] == pytest.approx(-50.0) and clock["device_offset_us"][1] == pytest.approx(0.0)
    assert out["after"]["kernels_before_their_span"] == 0 and out["after"]["copies_before_their_span"] == 0
    gaps = dict(out["idle_gaps"])
    assert gaps == pytest.approx({"call/spectrogram.step": 0.00255, "call/kernel.display_map": 0.0005,
                                  "call/colormap": 0.005, "wait": 0.00795})
