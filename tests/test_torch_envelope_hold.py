"""The ENVELOPE_HOLD trigger of the port's oscilloscope step
(``kernels/peak_hold.py::envelope_hold_trigger``, on the CPU its plain
version ``envelope_hold_trigger_plain``) against the JAX package's step
(``signalizer_tpu/views/oscilloscope.py``'s ENVELOPE_HOLD branch of
``osc_step_impl``, through its ``OscilloscopeProcessor``), on the CPU.

Each case streams 3 stereo pairs through both processors for 8 ticks with
the state carried: the left channel is the trigger's audio, the right a
ramp (sample index), so that the right row's first pixel (LINEAR
interpolation, no autogain) reads the window's start off either frame.
Tolerances: the fire-age queue, ``holding`` and ``trigger_found`` exact;
the envelope-hold state rtol 1e-6 (the same f32 operations in order, as in
``test_peak_hold_triggers_equal_jax``); the start atol 2e-6 and the
waveform atol 2e-6 x max(1, gain) (``test_processor_continues_from_a_jax_state``'s
bound; the starts are exact in f32, so that is equality).
"""

import numpy as np
import pytest
import torch

from signalizer_tpu.core.config import OscChannels
from signalizer_tpu.views import oscilloscope as jv
from signalizer_tpu_torch.kernels import peak_hold as ph
from signalizer_tpu_torch.views import oscilloscope as tv

FS = 48_000.0
PAIRS, H, TICKS, PIXELS, WINDOW = 3, 4096, 8, 256, 700.0
TM = tv.TriggerMode

# (hop a tick or a list of them, signal, hysteresis)
CASES = {
    "noise": (800, "noise", 0.3),
    "no_fire": (800, "quiet", 0.3),
    # spikes of one height re-arm only without hysteresis: each rises 1%
    # above the peak decayed since the last
    "over_8_fires": (1600, "spikes", 0.0),
    "fractional_new_samples": (800.5, "noise", 0.3),
    "new_samples_over_chunk": ([800, 3000, 800, 3000, 800, 3000, 800, 3000], "noise", 0.3),
    "nan_sample": (800, "nan", 0.3),
}


def _audio(kind, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    env = 0.55 + 0.45 * np.sin(2 * np.pi * t / 2500.0 + rng.uniform(0, 6.3, (PAIRS, 1)))
    x = (env * rng.standard_normal((PAIRS, n))).astype(np.float32)
    if kind == "quiet":
        x *= 0.01
    elif kind == "spikes":
        x[:, 50::100] = 4.0  # each spike rises above the decayed peak: a fire every 100 samples
    elif kind == "nan":
        x[1, H + 3 * 800 - 1] = np.nan  # the last sample of the third tick: that tick's state is NaN
    return x


def _histories(hops, kind, seed=3):
    """The history [pairs, 2, H] of each tick: audio left, a ramp right."""
    total = H + int(np.ceil(sum(hops)))
    audio = _audio(kind, total, seed)
    out, end = [], H
    for hop in hops:
        end += hop
        e = int(np.floor(end))
        h = np.empty((PAIRS, 2, H), np.float32)
        h[:, 0] = audio[:, e - H : e]
        h[:, 1] = np.arange(H, dtype=np.float32)
        out.append(h)
    return out


def _processors(**kw):
    common = dict(
        pairs=PAIRS, sample_rate=FS, pixels=PIXELS, window_samples=WINDOW, lookahead=2048,
        trigger_mode=TM.ENVELOPE_HOLD, trigger_threshold=0.1, trigger_hysteresis=0.3, trigger_channel=0,
        channel_mode=OscChannels.SEPARATE, interpolation=tv.SubSampleInterpolation.LINEAR,
        autogain=tv.AutoGain.NONE,
    )
    common.update(kw)
    return jv.OscilloscopeProcessor(**common), tv.OscilloscopeProcessor.create(device="cpu", **common)


class _Recorder:
    """Wraps the step's trigger and keeps what it returned."""

    def __init__(self, fn):
        self.fn, self.out = fn, None

    def __call__(self, *args, **kw):
        self.out = self.fn(*args, **kw)
        return self.out


@pytest.mark.parametrize("case", list(CASES))
def test_envelope_hold_trigger_plain_matches_the_jax_step(case, monkeypatch):
    """Eight ticks: the port's step (its trigger ``envelope_hold_trigger``,
    on the CPU the plain version) against the JAX step: state, queue,
    found, window start, waveform."""
    hop, kind, hyst = CASES[case]
    hops = hop if isinstance(hop, list) else [hop] * TICKS
    jp, tp = _processors(trigger_hysteresis=hyst)
    rec = _Recorder(ph.envelope_hold_trigger)
    monkeypatch.setattr(tv, "envelope_hold_trigger", rec)
    saw = {"found": 0, "full_queue": 0, "empty_queue": 0, "past_history": 0, "nan_state": 0}
    for i, h in enumerate(_histories(hops, kind)):
        jf = jp.process(h, new_samples=hops[i])
        tf = tp.process(h, new_samples=hops[i])
        js, ts = jp.state, tp.state
        np.testing.assert_array_equal(ts.peak_fire_ages.numpy(), np.asarray(js.peak_fire_ages), err_msg=f"ages {i}")
        np.testing.assert_array_equal(ts.peak_holding.numpy(), np.asarray(js.peak_holding), err_msg=f"holding {i}")
        np.testing.assert_allclose(ts.peak_hold_state.numpy(), np.asarray(js.peak_hold_state), rtol=1e-6,
                                   err_msg=f"state {i}")
        np.testing.assert_array_equal(tf.trigger_found.numpy(), np.asarray(jf.trigger_found), err_msg=f"found {i}")
        # the start the trigger returned is what the frame shows, and the JAX frame's
        start = rec.out[4].numpy()
        np.testing.assert_array_equal(tf.waveform[:, 1, 0].numpy(), start)
        np.testing.assert_allclose(start, np.asarray(jf.waveform)[:, 1, 0], rtol=0, atol=2e-6, err_msg=f"start {i}")
        np.testing.assert_allclose(tf.waveform.numpy(), np.asarray(jf.waveform), rtol=0, atol=2e-6 * H,
                                   err_msg=f"waveform {i}")
        ages = ts.peak_fire_ages.numpy()
        saw["found"] += int(tf.trigger_found.sum())
        saw["full_queue"] += int((ages < ph.FIRE_AGE_NONE).all(-1).sum())
        saw["empty_queue"] += int((ages == ph.FIRE_AGE_NONE).all(-1).sum())
        saw["past_history"] += int(((ages >= H) & (ages < ph.FIRE_AGE_NONE)).any(-1).sum())
        saw["nan_state"] += int(torch.isnan(ts.peak_hold_state).sum())
    # each case reaches what it is for
    if kind == "quiet":
        assert saw["found"] == 0 and saw["empty_queue"] == PAIRS * TICKS
    elif kind == "spikes":
        assert saw["full_queue"] == PAIRS * TICKS  # the newest 8, all in this tick's chunk
    else:
        assert saw["found"] > 0 and saw["past_history"] > 0
    # a NaN sample is the state until the next consumed sample replaces it
    assert saw["nan_state"] == (1 if kind == "nan" else 0)


def _old_envelope_hold_branch(region, threshold, hysteresis, state, holding, fire_ages, *, first, new_samples,
                              window, hf):
    """The step's ENVELOPE_HOLD branch as it was written inline before the
    fused entry: the scan, then the queue's torch operations."""
    F32 = np.float32
    chunk = region.shape[-1]
    fires, new_ph_state, new_holding = ph.peak_hold_triggers(region, threshold, hysteresis, state, holding,
                                                             first=first)
    idx = torch.arange(chunk, dtype=torch.float32, device=region.device)
    age = (chunk - 1.0) - idx
    cand = torch.where(fires, age, 1.0e9)
    k_new = min(8, chunk)
    newest = torch.topk(cand, k_new, dim=-1, largest=False, sorted=True).values
    carried = torch.clamp(fire_ages + float(new_samples), max=1.0e9)
    merged = torch.cat([newest, carried], dim=-1)
    new_fire_ages = torch.topk(merged, 8, dim=-1, largest=False, sorted=True).values
    mature = (new_fire_ages >= float(window * F32(0.5) - F32(1.0))) & (new_fire_ages < float(hf))
    age_sel = torch.amin(torch.where(mature, new_fire_ages, 1.0e9), dim=-1)
    found = age_sel < 1.0e9
    trigger_pos = float(hf - F32(1.0)) - torch.where(found, age_sel, 0.0)
    start = trigger_pos - float((window - F32(1.0)) * F32(0.5))
    start = torch.clamp(start, 0.0, float(hf - window))
    start = torch.where(found, start, float(hf - window))
    return new_ph_state, new_holding, new_fire_ages, found, start


@pytest.mark.parametrize("case", ["noise", "over_8_fires", "fractional_new_samples", "new_samples_over_chunk"])
def test_osc_step_is_unchanged_by_the_fused_entry(case, monkeypatch):
    """The port's step with its trigger through ``envelope_hold_trigger``
    against the same step with the branch as it was written inline before:
    every frame field and every state field equal, at 0 difference."""
    hop, kind, hyst = CASES[case]
    hops = hop if isinstance(hop, list) else [hop] * TICKS
    kw = dict(trigger_hysteresis=hyst, autogain=tv.AutoGain.RMS, colour_enabled=True)
    (_, new), (_, old) = _processors(**kw), _processors(**kw)
    for i, h in enumerate(_histories(hops, kind)):
        got = new.process(h, new_samples=hops[i])
        with monkeypatch.context() as m:
            m.setattr(tv, "envelope_hold_trigger", _old_envelope_hold_branch)
            want = old.process(h, new_samples=hops[i])
        for name in got._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), f"{name} {i}"
        for name in new.state._fields:
            a, b = getattr(new.state, name), getattr(old.state, name)
            if name == "crossover":
                a, b = a.z, b.z
            assert torch.equal(a, b), f"state {name} {i}"
