"""The port's spans and counters (``signalizer_tpu_torch.utils.diagnostics``)
on the CPU: spans record only under ``torch.profiler`` and nest with the
right parent, a spectrogram step's spans come in the order the step runs
them, the counter registry counts and resets, and a session tick records
its latency for the HUD."""

import json

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from signalizer_tpu_torch.utils import diagnostics as diag


def _names(records):
    return [s.name for s in records]


def test_no_profiler_records_nothing_and_returns_one_shared_object():
    diag.reset_spans()
    a, b = diag.span("spectrum.process"), diag.span("colormap")
    assert a is b
    with a:
        with b:
            pass
    assert diag.spans() == []


def test_spans_nest_with_their_parent_and_self_time_is_the_span_less_its_children():
    diag.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with diag.span("root"):
            with diag.span("a"):
                torch.ones(64).sum()
            with diag.span("b"):
                with diag.span("c"):
                    torch.ones(64).sum()
        with diag.span("second"):
            pass
    records = diag.spans()
    assert _names(records) == ["root", "a", "b", "c", "second"]
    assert [s.parent for s in records] == [-1, 0, 0, 2, -1]
    for s in records:
        assert s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = records[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    own = diag.self_ns(records)
    dur = [s.end_ns - s.start_ns for s in records]
    assert own == [dur[0] - dur[1] - dur[2], dur[1], dur[2] - dur[3], dur[3], dur[4]]
    assert all(v >= 0 for v in own)


def test_spans_are_read_on_the_unix_clock():
    diag.reset_spans()
    before = time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        with diag.span("x"):
            pass
    after = time_ns()
    (s,) = diag.spans()
    assert before - 1_000_000 <= s.start_ns <= s.end_ns <= after + 1_000_000


def time_ns():
    import time

    return time.time_ns()


def test_profile_trace_of_a_spectrogram_step_holds_its_spans_in_order(tmp_path):
    from signalizer_tpu_torch import SpectrogramProcessor
    from signalizer_tpu_torch.views.spectrogram import spectrogram_ring_step

    sp = SpectrogramProcessor(pairs=1, device="cpu", axis_points=32, window_size=256, overlap=0.5,
                              device_ingest=True)
    hop = sp._source.hop
    rng = np.random.default_rng(3)
    new = torch.from_numpy((rng.standard_normal((1, 2, hop)) * 0.2).astype(np.float32))
    with diag.profile_trace(str(tmp_path / "trace")) as tr:
        spectrogram_ring_step(sp.constant, sp.ring, sp.state, new, hop, 2, sp._colours, sp._ratios, hop=hop)
    records = diag.spans()
    want = ["spectrogram.step", "ring.update", "ring.frames", "kernel.window_fft_mag", "kernel.display_map",
            "colormap"]
    assert _names(records) == want
    assert [s.parent for s in records] == [-1, 0, 0, 0, 0, 0]
    events = json.loads(tr.path.read_text())["traceEvents"]
    ours = sorted((e for e in events if e.get("cat") == "program_span"), key=lambda e: e["ts"])
    assert [e["name"] for e in ours] == want
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    step = ours[0]
    # the spans sit on the profiler's own timeline, around the operations they ran
    assert any(step["ts"] <= e["ts"] <= step["ts"] + step["dur"] for e in ops)


def test_counters_count_and_reset():
    diag.reset_counters("test.a", "test.b")
    diag.count("test.a")
    diag.count("test.a", 3)
    diag.count("test.b", 2)
    assert (diag.counter("test.a"), diag.counter("test.b"), diag.counter("test.none")) == (4, 2, 0)
    diag.reset_counters("test.a")
    assert (diag.counter("test.a"), diag.counter("test.b")) == (0, 2)
    diag.reset_counters("test.b")


def test_the_plain_path_counts_no_launch():
    from signalizer_tpu_torch import SpectrumProcessor

    names = ("window_fft_mag.launches", "display_map.launches")
    before = [diag.counter(n) for n in names]
    p = SpectrumProcessor.create(pairs=1, device="cpu", axis_points=32, window_size=128)
    p.process(np.zeros((1, 2, 2, 128), np.float32))
    assert [diag.counter(n) for n in names] == before


def test_a_session_tick_records_its_latency():
    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.session import AnalysisSession
    from signalizer_tpu_torch.stream.audio_stream import Playhead

    eng = SignalizerEngine("spans", device="cpu")
    s = AnalysisSession(eng, axis_points=64, pixels=64)
    try:
        x = (0.5 * np.sin(2 * np.pi * 1000 * np.arange(3 * 800) / 48000)).astype(np.float32)
        assert eng.diagnostics.latency_percentiles()["p50_ms"] == 0.0
        for i in range(3):
            s.feed(np.stack([x, x])[:, 800 * i:800 * (i + 1)], Playhead(steady_clock=800 * (i + 1)))
            frame = s.tick()
        assert frame.diagnostics["p50_ms"] > 0.0 and frame.diagnostics["p99_ms"] >= frame.diagnostics["p50_ms"]
    finally:
        s.close()
