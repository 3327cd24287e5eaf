"""The port's fused all-views tick against its per-view tick, on the CPU.

The session's fused path (signalizer_tpu_torch/views/fused_tick.py) must be
BIT-equal to the per-view path across ticks, outputs and carried states:
both paths share the processors' ``_prep_step`` bucket and scalar math and
read the same windows of the device ring, so the same step functions see
the same inputs. Each case of tests/test_fused_tick.py is recreated here on
the port's engine and session (``device="cpu"``)."""

import numpy as np
import torch

from signalizer_tpu_torch.engine import SignalizerEngine
from signalizer_tpu_torch.session import AnalysisSession
from signalizer_tpu_torch.stream.audio_stream import Playhead

VIEWS = ("spectrum", "oscilloscope", "vectorscope")


def _record(fr, session):
    rec = {}
    if fr.spectrum is not None:
        rec["spectrum"] = np.asarray(fr.spectrum)
    if fr.oscilloscope is not None:
        rec["wave"] = fr.oscilloscope.waveform.numpy()
        rec["env_min"] = fr.oscilloscope.envelope_min.numpy()
        rec["env_max"] = fr.oscilloscope.envelope_max.numpy()
    if fr.vectorscope is not None:
        rec["verts"] = fr.vectorscope.vertices.numpy()
        rec["balance"] = fr.vectorscope.balance.numpy()
        rec["corr"] = fr.vectorscope.correlation_bars.numpy()
    # the carried states after the tick
    for view, names in (("spectrum", ("_state",)), ("oscilloscope", ("_state",)),
                        ("vectorscope", ("_state", "_peak_env"))):
        proc = session.processor(view)
        if proc is None:
            continue
        for name in names:
            for i, leaf in enumerate(_leaves(getattr(proc, name, None))):
                rec[f"{view}{name}{i}"] = leaf.clone().numpy()
    return rec


def _leaves(value):
    """The tensors of a (nested) state tuple, in order."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, tuple):
        return [leaf for v in value for leaf in _leaves(v)]
    return []


def _drive(fused, ticks=8, knobs=None, views=VIEWS, block=800):
    eng = SignalizerEngine("fused-parity", load_default_preset=False, device="cpu")
    if knobs:
        knobs(eng)
    s = AnalysisSession(eng, views=views, axis_points=128, pixels=128, fused_tick=fused)
    rng = np.random.default_rng(42)
    outs = []
    t = 0
    for _ in range(ticks):
        x = (0.5 * rng.standard_normal((2, block))).astype(np.float32)
        t += block
        s.feed(x, Playhead(steady_clock=t, bpm=120.0, is_playing=True))
        outs.append(_record(s.tick(), s))
    counters = dict(eng.diagnostics.counters)
    s.close()
    return outs, counters


def _assert_bitequal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert set(x) == set(y), (i, set(x), set(y))
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"tick {i} field {k}")


def _both(**kw):
    (fused, cf), (per_view, cp) = _drive(True, **kw), _drive(False, **kw)
    assert cf["session.failures"] == cp["session.failures"] == 0
    assert cf["session.fallbacks"] == cp["session.fallbacks"] == 0
    assert cp["session.fused_ticks"] == 0
    return fused, per_view, cf


def test_fused_tick_bitequal_default_knobs():
    fused, per_view, counters = _both()
    _assert_bitequal(fused, per_view)
    assert counters["session.fused_ticks"] == counters["session.ticks"] == 8


def test_fused_tick_bitequal_zc_trigger_rms_autogain():
    def knobs(eng):
        # zero-crossing trigger + RMS vectorscope autogain + polar mode
        eng.oscilloscope.trigger_mode.set_normalized(1.0)  # last choice
        eng.vectorscope.auto_gain.set_normalized(0.5)
        eng.vectorscope.operational_mode.set_normalized(1.0)  # polar

    fused, per_view, counters = _both(knobs=knobs)
    _assert_bitequal(fused, per_view)
    assert counters["session.fused_ticks"] == 8


def test_fused_tick_parity_across_reconfigure():
    def run(fused):
        eng = SignalizerEngine("fused-reconf", load_default_preset=False, device="cpu")
        s = AnalysisSession(eng, views=VIEWS, axis_points=128, pixels=128, fused_tick=fused)
        rng = np.random.default_rng(3)
        outs = []
        t = 0
        for i in range(6):
            if i == 3:
                eng.vectorscope.window_size.set_normalized(0.9)
                s.reconfigure()
            x = (0.5 * rng.standard_normal((2, 640))).astype(np.float32)
            t += 640
            s.feed(x, Playhead(steady_clock=t, bpm=120.0, is_playing=True))
            fr = s.tick()
            outs.append({
                "spectrum": np.asarray(fr.spectrum),
                "wave": fr.oscilloscope.waveform.numpy(),
                "balance": fr.vectorscope.balance.numpy(),
            })
        assert eng.diagnostics.counters["session.fused_ticks"] == (6 if fused else 0)
        s.close()
        return outs

    _assert_bitequal(run(True), run(False))


def test_fused_falls_back_for_rsnt_spectrum():
    def knobs(eng):
        eng.spectrum.algorithm.set_normalized(1.0)  # RESONATOR

    outs, counters = _drive(True, ticks=4, knobs=knobs)
    # RSNT makes the fused path ineligible; the per-view path must still
    # produce every view's output (ineligible is not a fallback)
    assert all("wave" in r and "verts" in r for r in outs)
    assert any("spectrum" in r for r in outs[1:])
    assert counters["session.fused_ticks"] == 0 and counters["session.fallbacks"] == 0


def test_fused_disabled_views_subset_still_ticks():
    outs, counters = _drive(True, ticks=3, views=("spectrum", "vectorscope"))
    assert all("verts" in r and "spectrum" in r for r in outs)
    assert all("wave" not in r for r in outs)
    assert counters["session.fused_ticks"] == 0


def test_fused_tick_bitequal_cycles_spectral_and_separate():
    """Cycles time mode with the spectral trigger (the fused tick reads the
    cycle feedback back at its end), SEPARATE on every view, peak-decay
    autogain on both scopes."""

    def knobs(eng):
        eng.oscilloscope.trigger_mode.set_normalized(0.25)  # spectral
        eng.oscilloscope.time_mode.set_normalized(0.5)  # cycles
        eng.oscilloscope.channel_configuration.set_normalized(4 / 5)  # separate
        eng.oscilloscope.auto_gain.set_normalized(1.0)  # peak decay
        eng.spectrum.channel_configuration.set_normalized(5 / 7)  # separate
        eng.vectorscope.auto_gain.set_normalized(1.0)  # peak decay

    fused, per_view, counters = _both(knobs=knobs)
    _assert_bitequal(fused, per_view)
    assert counters["session.fused_ticks"] == 8


def test_a_failing_fused_tick_falls_back_and_is_counted(monkeypatch):
    """A fused tick that raises is contained: the tick takes the per-view
    path, and the fallback is counted (never a silent carry-on)."""
    import signalizer_tpu_torch.views.fused_tick as ft

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(ft, "run_fused_tick", boom)
    outs, counters = _drive(True, ticks=3)
    assert all({"spectrum", "wave", "verts"} <= set(r) for r in outs)
    assert counters["session.fallbacks"] == counters["session.fallback.fused-tick"] == 3
    assert counters["session.fused_ticks"] == 0 and counters["session.failures"] == 0
