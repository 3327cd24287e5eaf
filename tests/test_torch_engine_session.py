"""The port's SignalizerEngine and AnalysisSession against the JAX package's,
on the CPU: the same seeded stereo blocks feed a JAX engine and session and
a port engine and session (``device="cpu"``, the kernels' plain versions),
tick by tick at 128 px, and archives cross between the two engines both
ways.

Tolerances are the per-view tests' (none widened):

* spectrum display values rtol/atol 1e-5 (tests/test_torch_spectrum.py);
* oscilloscope waveform and envelopes 2e-6 x max(1, gain), SPECTRAL
  trigger 1e-4 x max(1, gain) (tests/test_torch_osc_view.py);
* vectorscope vertices 2e-6 x gain, bars 2e-6, gain rtol 1e-6
  (tests/test_torch_vectorscope.py);
* spectrogram bytes within 1 LSB on at most 0.1% of the bytes
  (tests/test_torch_spectrogram.py);
* tracker frequency rtol 1e-5;
* RSNT: the bank state to 1e-6 of its peak and the display row at the
  spectrum's 1e-5, the JAX session's power-of-two bucket with its validity
  mask against the port's exact pending chunks
  (tests/test_torch_resonator.py).
"""

import numpy as np
import pytest

from signalizer_tpu.engine import SignalizerEngine as JEngine
from signalizer_tpu.session import AnalysisSession as JSession
from signalizer_tpu.state.serialize import Archive as JArchive
from signalizer_tpu.stream.audio_stream import Playhead as JPlayhead
from signalizer_tpu_torch.engine import SignalizerEngine as TEngine
from signalizer_tpu_torch.session import AnalysisSession as TSession
from signalizer_tpu_torch.state.serialize import Archive as TArchive
from signalizer_tpu_torch.stream.audio_stream import Playhead as TPlayhead

FS = 48_000.0
BLOCK = 800
ALL = ("spectrum", "oscilloscope", "vectorscope", "spectrogram")


def _blocks(seed, ticks, block=BLOCK, f=(1000.0, 1500.0)):
    """Seeded stereo blocks: a sine a channel plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(ticks * block) / FS
    x = np.stack([0.5 * np.sin(2 * np.pi * f[0] * t), 0.4 * np.sin(2 * np.pi * f[1] * t + 0.3)])
    x = x + 0.02 * rng.standard_normal(x.shape)
    return [x[:, i * block : (i + 1) * block].astype(np.float32) for i in range(ticks)]


def _choice(param, index, count):
    param.set_normalized(index / (count - 1))


def _pair(knobs=None, *, views=ALL, default_preset=True, cursor=None):
    jeng = JEngine("cmp", load_default_preset=default_preset)
    teng = TEngine("cmp", load_default_preset=default_preset, device="cpu")
    if knobs is not None:
        knobs(jeng)
        knobs(teng)
    kw = dict(views=views, axis_points=128, pixels=128, cursor_fraction=cursor)
    return JSession(jeng, **kw), TSession(teng, **kw)


def _run(js, ts, blocks):
    """Feed both sessions the same blocks; yield both frames per tick."""
    clock = 0
    try:
        for x in blocks:
            clock += x.shape[1]
            js.feed(x, JPlayhead(steady_clock=clock, bpm=120.0, is_playing=True))
            ts.feed(x, TPlayhead(steady_clock=clock, bpm=120.0, is_playing=True))
            yield js.tick(), ts.tick()
    finally:
        js.close()
        ts.close()


def _check_spectrum(jf, tf, tick, atol=1e-5):
    assert (jf.spectrum is None) == (tf.spectrum is None), tick
    if jf.spectrum is not None:
        np.testing.assert_allclose(tf.spectrum, np.asarray(jf.spectrum), rtol=1e-5, atol=atol, err_msg=f"tick {tick}")


def _check_osc(jf, tf, tick, wave_atol=2e-6):
    jo, to = jf.oscilloscope, tf.oscilloscope
    assert (jo is None) == (to is None), tick
    if jo is None:
        return
    gain = np.asarray(jo.gain)
    np.testing.assert_allclose(to.gain.numpy(), gain, rtol=2e-6, err_msg=f"tick {tick} gain")
    scale = np.maximum(1.0, np.abs(gain))[:, None, None]
    for name in ("waveform", "envelope_min", "envelope_max"):
        got, want = getattr(to, name).numpy(), np.asarray(getattr(jo, name))
        assert got.shape == want.shape, name
        assert np.all(np.abs(got - want) <= wave_atol * scale), (tick, name, float(np.abs(got - want).max()))
    assert np.array_equal(to.trigger_found.numpy(), np.asarray(jo.trigger_found)), tick


def _check_vs(jf, tf, tick):
    jv, tv = jf.vectorscope, tf.vectorscope
    assert (jv is None) == (tv is None), tick
    if jv is None:
        return
    gain = np.asarray(jv.gain)
    np.testing.assert_allclose(tv.gain.numpy(), gain, rtol=1e-6, err_msg=f"tick {tick} gain")
    scale = max(1.0, float(np.abs(gain).max()))
    np.testing.assert_allclose(tv.vertices.numpy(), np.asarray(jv.vertices), atol=2e-6 * scale, rtol=0)
    for name in ("balance", "correlation_bars"):
        np.testing.assert_allclose(getattr(tv, name).numpy(), np.asarray(getattr(jv, name)), atol=2e-6, rtol=0)


def _check_columns(jf, tf, tick):
    jc, tc = jf.spectrogram_columns, tf.spectrogram_columns
    assert (jc is None) == (tc is None), tick
    if jc is None:
        return 0
    jc = np.asarray(jc)
    assert tc.shape == jc.shape and tc.dtype == jc.dtype == np.uint8, (tick, tc.shape, jc.shape)
    diff = np.abs(tc.astype(np.int16) - jc.astype(np.int16))
    assert diff.max(initial=0) <= 1 and np.count_nonzero(diff) <= 1e-3 * max(diff.size, 1), tick
    return tc.shape[0]


def _tracker_sel(source):
    def knobs(eng):
        _choice(eng.spectrum.frequency_tracker, ("none", "transform", "graph0").index(source), 4)

    return knobs


def _separate_zero_crossing(eng):
    _choice(eng.spectrum.channel_configuration, 5, 8)  # separate
    _choice(eng.oscilloscope.channel_configuration, 4, 6)  # separate
    _choice(eng.oscilloscope.trigger_mode, 4, 5)  # zero crossing
    eng.oscilloscope.trigger_threshold.set_normalized(0.01)


def _spectral(eng):
    _choice(eng.oscilloscope.trigger_mode, 1, 5)  # spectral


def _rsnt(eng):
    _choice(eng.spectrum.algorithm, 1, 2)  # resonator


CASES = {
    # the factory default preset (default.main), every view
    "default": dict(),
    "separate_zero_crossing": dict(knobs=_separate_zero_crossing),
    "spectral_trigger": dict(knobs=_spectral, wave_atol=1e-4),
    # the cursor on the left channel's 1000 Hz sine (a fraction of fs / 2)
    "tracker_transform": dict(knobs=_tracker_sel("transform"), cursor=1000.0 / 24_000.0),
    "tracker_graph0": dict(knobs=_tracker_sel("graph0"), cursor=0.3),
    "spectrogram_alone": dict(views=("spectrogram",)),
    "construction_defaults": dict(default_preset=False, views=("spectrum", "oscilloscope", "vectorscope")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_session_matches_the_jax_session(case):
    """Ten ticks of the same blocks: every view's output within the
    per-view tolerances at every tick; the tracker reads the same
    frequency; the spectrogram's columns arrive on the same ticks."""
    spec = dict(CASES[case])
    wave_atol = spec.pop("wave_atol", 2e-6)
    js, ts = _pair(spec.get("knobs"), views=spec.get("views", ALL),
                   default_preset=spec.get("default_preset", True), cursor=spec.get("cursor"))
    columns = trackers = 0
    for tick, (jf, tf) in enumerate(_run(js, ts, _blocks(7, 10))):
        _check_spectrum(jf, tf, tick)
        _check_osc(jf, tf, tick, wave_atol)
        _check_vs(jf, tf, tick)
        columns += _check_columns(jf, tf, tick)
        assert (jf.tracker is None) == (tf.tracker is None), tick
        if jf.tracker is not None:
            trackers += 1
            assert tf.tracker["note"] == jf.tracker["note"] and tf.tracker["source"] == jf.tracker["source"]
            np.testing.assert_allclose(tf.tracker["frequency"], jf.tracker["frequency"], rtol=1e-5)
    views = spec.get("views", ALL)
    if "spectrogram" in views:
        assert columns > 0
    if "cursor" in spec:
        assert trackers == 10
    if case == "tracker_transform":  # the sine under the cursor, within one bin
        assert abs(tf.tracker["frequency"] - 1000.0) < FS / 4096
    counters = tf.diagnostics
    assert counters["session.failures"] == 0 and counters["session.fallbacks"] == 0
    if {"spectrum", "oscilloscope", "vectorscope"} <= set(views):
        assert counters["session.fused_ticks"] == counters["session.ticks"] == 10


def test_rsnt_session_matches_the_masked_jax_session():
    """RSNT: the JAX session pads the pending chunks to a power of two with
    a validity mask; the port passes exactly the pending chunks. The bank
    state agrees to 1e-6 of its peak and the display row to 1e-5 at every
    tick (blocks of 1300 samples leave a sub-chunk remainder to carry)."""
    js, ts = _pair(_rsnt, views=("spectrum", "oscilloscope", "vectorscope"))
    shown = 0
    for tick, (jf, tf) in enumerate(_run(js, ts, _blocks(11, 10, block=1300))):
        assert (jf.spectrum is None) == (tf.spectrum is None), tick
        if jf.spectrum is not None:
            shown += 1
            # the display row at the spectrum's tolerance (as the resonator
            # processor's test holds it), the bank to 1e-6 of its peak
            _check_spectrum(jf, tf, tick)
            jstate = np.asarray(js.processor("spectrum").res_state)
            tstate = ts.processor("spectrum").res_state.numpy()
            assert np.abs(tstate - jstate).max() <= 1e-6 * np.abs(jstate).max(), tick
        _check_osc(jf, tf, tick)
        _check_vs(jf, tf, tick)
    assert shown >= 9
    assert ts.engine.diagnostics.counters["session.fused_ticks"] == 0  # RSNT takes the per-view path


def test_phase_session_matches_the_jax_session():
    """PHASE: the mid row at the spectrum's 1e-5; the cancellation row, a
    ratio of nearly equal numbers whose dB swings with another FFT's
    rounding, in linear units at atol 2e-3 (as tests/test_torch_spectrum.py
    holds it)."""

    def knobs(eng):
        _choice(eng.spectrum.channel_configuration, 4, 8)  # phase

    js, ts = _pair(knobs, views=("spectrum", "oscilloscope", "vectorscope"))
    tc = ts.processor("spectrum").constant
    lower, dyr = (float(v) for v in tc.display_scalars[1:3])

    def linear(v):
        return np.where(v == float(tc.clip_db), 0.0, np.exp(np.asarray(v, np.float64) / dyr) * lower)

    for tick, (jf, tf) in enumerate(_run(js, ts, _blocks(13, 8))):
        want = np.asarray(jf.spectrum)
        assert tf.spectrum.shape == want.shape == (2, 2, 128)
        np.testing.assert_allclose(tf.spectrum[:, 0], want[:, 0], rtol=1e-5, atol=1e-5, err_msg=f"tick {tick}")
        np.testing.assert_allclose(linear(tf.spectrum[:, 1]), linear(want[:, 1]), atol=2e-3, err_msg=f"tick {tick}")
        _check_osc(jf, tf, tick)
        _check_vs(jf, tf, tick)


def test_tracker_transform_refuses_complex_as_the_jax_helper_does():
    """COMPLEX has no real half spectrum: the JAX Transform tracker fails
    (contained, no readout) and so does the port's, counted as a failure."""
    def knobs(eng):
        _choice(eng.spectrum.channel_configuration, 7, 8)  # complex
        _tracker_sel("transform")(eng)

    js, ts = _pair(knobs, views=("spectrum",), cursor=0.3)
    for tick, (jf, tf) in enumerate(_run(js, ts, _blocks(3, 3))):
        assert jf.tracker is None and tf.tracker is None
        _check_spectrum(jf, tf, tick)
    assert ts.engine.diagnostics.counters["session.failure.tracker"] == 3


# ---------------------------------------------------------------------------
# archives: JAX engine <-> port engine
# ---------------------------------------------------------------------------


def _normalized(eng):
    return [eng.get_parameter(i) for i in range(eng.num_parameters())]


def _scramble(eng, seed):
    rng = np.random.default_rng(seed)
    for i in range(eng.num_parameters()):
        eng.set_parameter(i, float(rng.random()))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("state", ["default_preset", "scrambled"])
def test_archives_cross_between_the_engines(direction, state):
    """Archive bytes written by one engine load into the other with equal
    normalized values for all 201 parameters, equal names and texts; the
    engine subtree (history capacity) crosses too."""
    jeng = JEngine("src", load_default_preset=True)
    teng = TEngine("src", load_default_preset=True, device="cpu")
    assert jeng.num_parameters() == teng.num_parameters() == 201
    assert _normalized(jeng) == _normalized(teng)
    src, dst = (jeng, teng) if direction == "jax_to_port" else (teng, jeng)
    if state == "scrambled":
        _scramble(src, 5)
        src._apply_history_capacity(24_000)
    archive = (JArchive if src is jeng else TArchive)()
    src.serialize(archive)
    data = archive.to_bytes()
    fresh = (TEngine("dst", device="cpu") if dst is teng else JEngine("dst"))
    fresh.deserialize((TArchive if dst is teng else JArchive).from_bytes(data))
    assert _normalized(fresh) == _normalized(src)
    for i in range(src.num_parameters()):
        assert fresh.get_parameter_name(i) == src.get_parameter_name(i)
        assert fresh.get_parameter_text(i) == src.get_parameter_text(i), src.get_parameter_name(i)
    assert fresh.config.history_capacity == src.config.history_capacity
    again = (TArchive if dst is teng else JArchive)()
    fresh.serialize(again)
    rt = (JArchive if src is jeng else TArchive).from_bytes(again.to_bytes())
    assert rt.find_child("Parameters").to_bytes() == archive.find_child("Parameters").to_bytes()
    for e in (jeng, teng, fresh):
        e.close()


def test_restored_port_engine_gives_the_same_next_frames():
    """A port engine serialized, closed and restored into a fresh engine
    (which takes over its host-graph identity) builds processors that give
    the same frames on the same blocks."""

    def frames(eng):
        s = TSession(eng, axis_points=64, pixels=64)
        out, clock = [], 0
        for x in _blocks(4, 4):
            clock += x.shape[1]
            s.feed(x, TPlayhead(steady_clock=clock, bpm=120.0, is_playing=True))
            f = s.tick()
            out.append((f.spectrum, f.oscilloscope.waveform.numpy(), f.vectorscope.vertices.numpy()))
        s.close()
        return out

    a = TEngine("a", device="cpu")
    _scramble(a, 9)
    _choice(a.spectrum.algorithm, 0, 2)  # the FFT
    _choice(a.oscilloscope.trigger_mode, 4, 5)
    a.spectrum.window_size.set_normalized(2048 / 48_000)
    ar = TArchive()
    a.serialize(ar)
    want = frames(a)  # closes a
    b = TEngine("b", device="cpu")
    b.deserialize(TArchive.from_bytes(ar.to_bytes()))
    assert b.host_graph.node_id == a.host_graph.node_id
    for tick, (w, g) in enumerate(zip(want, frames(b))):
        for x, y in zip(w, g):
            np.testing.assert_array_equal(y, x, err_msg=f"tick {tick}")


def test_engine_builds_every_processor_on_its_device():
    """Every factory builds on the engine's device; the default preset's
    normalized values equal the JAX engine's; the spectrum constant keeps
    host copies that match the JAX constant's host mirror."""
    from signalizer_tpu.core.constant import host_view as jhost_view
    from signalizer_tpu_torch.core.constant import host_view

    teng = TEngine("dev", device="cpu")
    jeng = JEngine("dev")
    assert _normalized(teng) == _normalized(jeng)
    sp = teng.make_spectrum_processor(axis_points=64)
    procs = [sp, teng.make_oscilloscope_processor(pixels=64), teng.make_vectorscope_processor(),
             teng.make_spectrogram_processor(axis_points=64)]
    assert all(str(p.device) == "cpu" for p in procs)
    jsp = jeng.make_spectrum_processor(axis_points=64)
    for name in ("mapped_frequencies", "inv_size", "low_dbs", "high_dbs"):
        got, want = host_view(sp.constant, name), jhost_view(jsp.constant, name)
        assert np.asarray(got).dtype == np.float64 and np.array_equal(np.ravel(got), np.ravel(want)), name
        assert np.array_equal(host_view(sp.constant.to("cpu"), name), got)
    with pytest.raises(KeyError):
        host_view(sp.constant, "band_idx")
    teng.close()
    jeng.close()


def test_spectrogram_feed_on_the_delivery_thread_makes_no_torch_call(monkeypatch):
    """The spectrogram's stream listener runs on the audio delivery thread:
    it only queues host samples (both ingest routes), and every launch
    stays on the tick thread."""
    import torch

    routes = []
    for blob_ms in (10.0, 10.01):  # a hop of 480 samples (device ingest), of 480.48 (the host batcher)
        eng = TEngine("feed", device="cpu")
        eng.spectrum.blob_size.set_transformed(blob_ms)
        s = TSession(eng, views=("spectrogram",), axis_points=64)
        sg = s.processor("spectrogram")
        routes.append(sg.device_ingest)

        def refuse(*a, **k):
            raise AssertionError("torch called on the delivery thread")

        with monkeypatch.context() as m:
            for name in ("from_numpy", "as_tensor", "tensor", "empty", "zeros", "cat"):
                m.setattr(torch, name, refuse)
            for i, x in enumerate(_blocks(2, 6)):
                s.feed(x, TPlayhead(steady_clock=BLOCK * (i + 1)))
        assert sg.batcher.frames_ready() > 0
        cols = s.tick().spectrogram_columns
        assert cols.shape[0] > 0 and eng.diagnostics.counters["session.failures"] == 0
        s.close()
    assert routes == [True, False]


def test_peak_trigger_preset_session_matches_the_jax_session():
    """The factory preset ``peak trigger.oscilloscope`` (the ENVELOPE_HOLD
    trigger, kernel D's path): ten ticks of bursts at the per-view
    tolerances, the trigger found on the same ticks."""
    from signalizer_tpu_torch.views.oscilloscope import TriggerMode

    def knobs(eng):
        assert eng.load_preset("peak trigger.oscilloscope")

    js, ts = _pair(knobs)
    assert ts.processor("oscilloscope").trigger_mode == TriggerMode.ENVELOPE_HOLD
    blocks = _blocks(17, 10)
    gate = (np.arange(10 * BLOCK) // 600) % 2  # 600-sample bursts
    blocks = [b * gate[i * BLOCK : (i + 1) * BLOCK] for i, b in enumerate(blocks)]
    found = 0
    for tick, (jf, tf) in enumerate(_run(js, ts, blocks)):
        _check_spectrum(jf, tf, tick)
        _check_osc(jf, tf, tick)
        _check_vs(jf, tf, tick)
        found += int(tf.oscilloscope.trigger_found.any())
    assert found > 0
    counters = tf.diagnostics
    assert counters["session.failures"] == 0 and counters["session.fused_ticks"] == 10
