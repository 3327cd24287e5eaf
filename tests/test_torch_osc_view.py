"""The PyTorch port's OscilloscopeProcessor against the JAX package's, on
the CPU (kernel C's plain version), and against the oscilloscope golden.

Each case streams a seeded stereo signal (a distinct sine per pair plus
noise 34 dB below it) at 48 kHz through both processors: 2 pairs, a
4096-sample history, 256 pixels, 3 calls 800 samples apart with state
carried. Bounds, from what was measured when the port was brought up:

* trigger_found equal; fundamental rtol 1e-6; gain rtol 2e-6;
* waveform and envelopes atol 2e-6 x max(1, gain) (measured <= 1.5e-6: the
  same f32 operations, Lanczos taps summed in another order);
* colours atol 1e-3: the colour track divides smoothed band energies from
  the crossover, where JAX's f32 associative scan sits 2.5e-5 from a
  float64 filter and the port's 6.4e-6 (``test_torch_filters.py``), and
  the ratios amplify that (measured 3.0e-4);
* SPECTRAL trigger, waveform and envelopes atol 1e-4 x max(1, gain): the
  window start is a phase lock formed from the FFT's interpolated bin
  offset and a 2048-point Goertzel sum rotated by up to ~30 rad, and two
  FFT libraries (and XLA's ``jit``, which contracts products into FMAs)
  round those differently, so the start moves by up to ~1e-3 samples
  (measured: 2.9e-5 with MIDSIDE rows at gain ~2, 1.5e-5 in the Cycles
  time mode, on sines of slope <= 0.03 per sample). A custom trigger
  frequency skips the FFT but not the phase lock, and the second pair's
  sine is not at that frequency: its Goertzel sum is a small residual of
  leakage and noise whose angle carries the rounding of 2048 terms, so
  the port's offset sits 2e-4 samples from jitted JAX's (while equal to
  eager JAX's) and the waveform 1.8e-5 from JAX's (measured).
"""

SPECTRAL_ATOL = 1e-4

import numpy as np
import pytest
import torch

from signalizer_tpu.core.config import OscChannels
from signalizer_tpu.params.transformatters import TimeMode
from signalizer_tpu.views import oscilloscope as jv
from signalizer_tpu_torch.utils.diagnostics import counter
from signalizer_tpu_torch.views import oscilloscope as tv

from test_golden import GOLDEN_DIR

FS = 48_000.0
TM = tv.TriggerMode
SI = tv.SubSampleInterpolation
PAIRS, H, HOP, CALLS, PIXELS = 2, 4096, 800, 3, 256


def _stream(pairs=PAIRS, seed=0, silent_last=False):
    rng = np.random.default_rng(seed)
    length = H + HOP * CALLS
    n = np.arange(length)
    out = np.zeros((pairs, 2, length), np.float32)
    for p in range(pairs - int(silent_last)):
        f = 301.37 * (p + 1)
        for c in range(2):
            out[p, c] = 0.5 * np.sin(2 * np.pi * f * n / FS + 0.3 * c + 0.1 * p) + 0.01 * rng.standard_normal(length)
    return out


def _calls(stream):
    return [stream[..., i * HOP : i * HOP + H] for i in range(CALLS)]


def _pair(proc_kw=None, **constant_kw):
    kw = dict(sample_rate=FS, pixels=PIXELS, lookahead=2048, trigger_threshold=0.1)
    kw.update(constant_kw)
    pk = dict(pairs=PAIRS, window_samples=700.0)
    pk.update(proc_kw or {})
    return jv.OscilloscopeProcessor(**pk, **kw), tv.OscilloscopeProcessor.create(device="cpu", **pk, **kw)


def _assert_frames_match(jf, tf, wave_atol=2e-6):
    for name in ("trigger_found",):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)), err_msg=name)
    np.testing.assert_allclose(tf.fundamental.numpy(), np.asarray(jf.fundamental), rtol=1e-6, err_msg="fundamental")
    np.testing.assert_allclose(tf.gain.numpy(), np.asarray(jf.gain), rtol=2e-6, err_msg="gain")
    scale = max(1.0, float(np.abs(np.asarray(jf.gain)).max()))
    for name in ("waveform", "envelope_min", "envelope_max"):
        got, want = getattr(tf, name).numpy(), np.asarray(getattr(jf, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=wave_atol * scale, err_msg=name)
    assert tf.colours.shape == np.asarray(jf.colours).shape
    np.testing.assert_allclose(tf.colours.numpy(), np.asarray(jf.colours), rtol=0, atol=1e-3, err_msg="colours")


def _run(jp, tp, stream, wave_atol=2e-6, transport=None):
    if tp.trigger_mode == TM.SPECTRAL:
        wave_atol = SPECTRAL_ATOL
    frames = []
    for i, h in enumerate(_calls(stream)):
        tpos = 0.0 if transport is None else transport * i
        jf = jp.process(h, transport_position=tpos, new_samples=HOP)
        tf = tp.process(h, transport_position=tpos, new_samples=HOP)
        _assert_frames_match(jf, tf, wave_atol)
        frames.append(tf)
    return frames


@pytest.mark.parametrize("interp", list(SI), ids=lambda i: i.name)
@pytest.mark.parametrize("trigger", list(TM), ids=lambda t: t.name)
def test_processor_matches_jax_per_trigger_and_interpolation(trigger, interp):
    """SEPARATE rows, every trigger mode x every interpolation."""
    jp, tp = _pair(channel_mode=OscChannels.SEPARATE, trigger_mode=trigger, interpolation=interp)
    before = counter("banded_resample.launches")
    frames = _run(jp, tp, _stream(), transport=1000.0)
    assert counter("banded_resample.launches") == before  # CPU tensors take the plain version
    for f in frames:
        assert f.waveform.shape == (PAIRS, 2, PIXELS)
        assert torch.isfinite(f.waveform).all()


@pytest.mark.parametrize("trigger", list(TM), ids=lambda t: t.name)
def test_processor_matches_jax_midside_with_peak_decay(trigger):
    jp, tp = _pair(
        channel_mode=OscChannels.MIDSIDE, trigger_mode=trigger,
        interpolation=SI.LANCZOS, autogain=tv.AutoGain.PEAK_DECAY,
    )
    _run(jp, tp, _stream(seed=1), transport=777.0)


@pytest.mark.parametrize("mode", [OscChannels.LEFT, OscChannels.SIDE, OscChannels.SEPARATE])
def test_processor_matches_jax_with_rms_autogain(mode):
    jp, tp = _pair(
        channel_mode=mode, trigger_mode=TM.ZERO_CROSSING, autogain=tv.AutoGain.RMS,
        envelope_window_ms=50.0, trigger_channel=1,
    )
    _run(jp, tp, _stream(seed=2))


def test_processor_matches_jax_with_colour():
    """Spectral colouring with per-pair hue-rotated key colours, MIDSIDE
    rows, RMS autogain; the colour track's nearest pick is kernel C with
    rows x 3 rows."""
    jp, tp = _pair(
        channel_mode=OscChannels.MIDSIDE, trigger_mode=TM.ZERO_CROSSING, autogain=tv.AutoGain.RMS,
        colour_enabled=True, key_colour=(0.9, 0.4, 0.2), secondary_colour=(0.2, 0.5, 1.0), colour_blend=0.6,
    )
    frames = _run(jp, tp, _stream(seed=3))
    assert frames[-1].colours.shape == (PAIRS, 2, PIXELS, 3)


def test_processor_matches_jax_upsampling_with_the_dual_output():
    """A 200-sample window over 256 px: step < 1, so env_os = 1 and the
    Lanczos wave and the envelope's nearest pick come from one resample."""
    jp, tp = _pair(proc_kw=dict(window_samples=200.0), trigger_mode=TM.ZERO_CROSSING)
    _run(jp, tp, _stream(seed=4))


def test_processor_matches_jax_with_a_custom_trigger_frequency():
    jp, tp = _pair(
        trigger_mode=TM.SPECTRAL, custom_trigger=True, custom_trigger_frequency=301.37,
        trigger_phase_degrees=45.0,
    )
    _run(jp, tp, _stream(seed=5))


@pytest.mark.parametrize(
    "time_mode,proc_kw,trigger",
    [
        (TimeMode.TIME, dict(), TM.WINDOW),
        (TimeMode.CYCLES, dict(window_value=3.0), TM.SPECTRAL),
        (TimeMode.BEATS, dict(window_value=4.0, bpm=600.0), TM.WINDOW),
    ],
    ids=["window", "cycles", "beats"],
)
def test_processor_matches_jax_per_time_mode(time_mode, proc_kw, trigger):
    """The WINDOW trigger's transport-synced scroll, the Cycles mode's
    detected-period feedback and the Beats mode's bpm-derived window."""
    jp, tp = _pair(proc_kw=dict(time_mode=time_mode, **proc_kw), trigger_mode=trigger)
    _run(jp, tp, _stream(seed=6), transport=1234.5)
    assert tp.effective_window_samples() == pytest.approx(jp.effective_window_samples(), rel=1e-6)


@pytest.mark.parametrize("trigger", [TM.ENVELOPE_HOLD, TM.SPECTRAL], ids=lambda t: t.name)
def test_processor_continues_from_a_jax_state(trigger):
    """Two JAX calls settle a state (envelope-hold queue, median history,
    crossover, colour smoothing, RMS envelope); the port takes it through
    oscilloscope_state_from_arrays and both continue for two calls."""
    jp, tp = _pair(trigger_mode=trigger, autogain=tv.AutoGain.RMS, colour_enabled=True)
    calls = _calls(_stream(seed=7))
    for h in calls[:2]:
        jp.process(h, new_samples=HOP)
    leaves = {k: np.asarray(v) if k != "crossover" else np.asarray(v.z) for k, v in jp.state._asdict().items()}
    tp.state = tv.oscilloscope_state_from_arrays(leaves, "cpu")
    for name, want in leaves.items():
        got = tp.state.crossover.z if name == "crossover" else getattr(tp.state, name)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    tp.state = tv.oscilloscope_state_from_arrays(jp.state, "cpu")  # the named tuple itself
    atol = SPECTRAL_ATOL if trigger == TM.SPECTRAL else 2e-6
    for h in (calls[2], calls[1]):
        _assert_frames_match(jp.process(h, new_samples=HOP), tp.process(h, new_samples=HOP), atol)
    np.testing.assert_allclose(tp.state.peak_fire_ages.numpy(), np.asarray(jp.state.peak_fire_ages))
    np.testing.assert_allclose(tp.state.median_history.numpy(), np.asarray(jp.state.median_history), rtol=1e-6)


def test_processor_matches_the_oscilloscope_golden():
    """The inputs of tests/test_golden.py's oscilloscope case (SPECTRAL
    trigger, LANCZOS, RMS autogain, colour, second call) against its
    golden at that test's atol 2e-5 (measured 4.8e-7 on the waveform)."""
    rng = np.random.default_rng(11)
    t = np.arange(8192)
    x = (0.4 * np.sin(2 * np.pi * 441.3 * t / 48_000.0)
         + 0.1 * np.sin(2 * np.pi * 1323.9 * t / 48_000.0)
         + 0.01 * rng.standard_normal(8192)).astype(np.float32)
    hist = np.stack([x, np.roll(x, 3)])[None]
    proc = tv.OscilloscopeProcessor.create(
        device="cpu", pairs=1, channel_mode=OscChannels.SEPARATE, trigger_mode=TM.SPECTRAL,
        interpolation=SI.LANCZOS, window_samples=700.0, pixels=160, lookahead=4096,
        autogain=tv.AutoGain.RMS, envelope_window_ms=50.0, colour_enabled=True,
    )
    proc.process(hist)
    frame = proc.process(hist)
    want = np.load(GOLDEN_DIR / "oscilloscope_spectral_frame.npz")
    for key in ("waveform", "colours", "gain", "fundamental"):
        np.testing.assert_allclose(getattr(frame, key).numpy(), want[key], atol=2e-5, err_msg=key)


def test_zero_crossing_centres_the_window_and_silence_stays_zero():
    """Physics on the port alone: ZERO_CROSSING puts a rising crossing of
    each sounding pair's sine at the window's centre pixel; the silent pair
    draws an all-zero, finite waveform."""
    proc = tv.OscilloscopeProcessor.create(
        device="cpu", pairs=3, sample_rate=FS, trigger_mode=TM.ZERO_CROSSING,
        interpolation=SI.LANCZOS, pixels=PIXELS, trigger_threshold=0.1, window_samples=1024.0,
    )
    stream = _stream(pairs=3, silent_last=True)
    for h in _calls(stream):
        frame = proc.process(h, new_samples=HOP)
    wave = frame.waveform.numpy()
    mid = (PIXELS - 1) // 2
    for p in range(2):
        assert frame.trigger_found[p]
        assert wave[p, 0, mid] <= 0.05 < wave[p, 0, mid + 3]  # rising through zero at the centre
    assert not frame.trigger_found[2]
    assert (wave[2] == 0).all() and np.isfinite(wave).all()


def test_reconfigure_resets_on_a_row_change_and_reset_clears_state():
    proc = tv.OscilloscopeProcessor.create(device="cpu", pairs=2, autogain=tv.AutoGain.PEAK_DECAY, pixels=64)
    proc.process(_calls(_stream())[0])
    assert proc.state.peak_env.abs().sum() > 0
    proc.reconfigure(tv.make_oscilloscope_constant(device="cpu", channel_mode=OscChannels.SEPARATE, pixels=32))
    assert proc.state.peak_env.abs().sum() > 0  # same rows: state kept
    proc.reconfigure(tv.make_oscilloscope_constant(device="cpu", channel_mode=OscChannels.LEFT, pixels=32))
    assert proc.state.peak_env.shape == (2, 1) and not proc.state.peak_env.any()
    proc.process(_calls(_stream())[0])
    proc.reset()
    assert not proc.state.peak_env.any()
    assert proc.process(np.zeros((2, 2, 512), np.float32)).waveform.shape == (2, 1, 32)
