"""The PyTorch port's oscilloscope functions (triggers, spectral
fundamental, median filter, Goertzel phase lock, colour track) against the
JAX package on the CPU. Inputs are made with numpy from a seed and handed to
both. Trigger booleans must be equal exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.kernels import oscilloscope as jk
from signalizer_tpu_torch.kernels import oscilloscope as tk

from test_oscilloscope import _peak_hold_oracle, _zc_oracle

FS = 48_000.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("threshold", [0.0, 0.2, 0.7])
def test_zero_crossing_triggers_equal_jax_and_the_oracle(threshold):
    rng = np.random.default_rng(int(threshold * 10))
    x = (rng.standard_normal((3, 2, 2000)) * 0.5).astype(np.float32)
    x[0, 0, :100] = 0.0  # a flat stretch: no crossing, nothing hot
    got = tk.zero_crossing_triggers(_t(x), threshold).numpy()
    want = np.asarray(jk.zero_crossing_triggers(jnp.asarray(x), threshold))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1, 1], _zc_oracle(x[1, 1].astype(np.float64), threshold))
    idx, found = tk.last_zero_crossing_trigger(_t(x), threshold)
    jidx, jfound = jk.last_zero_crossing_trigger(jnp.asarray(x), threshold)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))


def test_zero_crossing_threshold_may_be_a_tensor():
    t = np.arange(4096)
    x = np.sin(2 * np.pi * 10 * t / 4096).astype(np.float32)
    got = tk.zero_crossing_triggers(_t(x), torch.tensor(0.5))
    assert got.sum() == 9  # every rising crossing but the one at sample 0
    assert not tk.last_zero_crossing_trigger(_t(np.zeros(64, np.float32)), 0.1)[1]


@pytest.mark.parametrize("with_valid", [False, True, "first"])
@pytest.mark.parametrize("hysteresis", [0.0, 0.3])
def test_peak_hold_triggers_equal_jax(hysteresis, with_valid):
    """Fires equal, carried state rtol 1e-6 (the same f32 operations in
    order) over two blocks; with a valid mask only the trailing 300
    samples are consumed ("first": the port's form of that mask, the
    index of the first consumed sample, which the oscilloscope step
    passes to kernel D)."""
    rng = np.random.default_rng(int(hysteresis * 10) + bool(with_valid))
    x = (rng.standard_normal((2, 2, 1024)) * 0.5).astype(np.float32)
    valid = (np.arange(1024) >= 1024 - 300) if with_valid else None
    st, hold = None, None
    jst, jhold = None, None
    for block in range(2):
        if with_valid == "first":
            fires, st, hold = tk.peak_hold_triggers(_t(x[block]), 0.1, hysteresis, st, hold, first=1024 - 300)
        else:
            fires, st, hold = tk.peak_hold_triggers(
                _t(x[block]), 0.1, hysteresis, st, hold,
                valid=None if valid is None else _t(valid),
            )
        jfires, jst, jhold = jk.peak_hold_triggers(
            jnp.asarray(x[block]), 0.1, hysteresis, jst, jhold,
            valid=None if valid is None else jnp.asarray(valid),
        )
        np.testing.assert_array_equal(fires.numpy(), np.asarray(jfires))
        np.testing.assert_array_equal(hold.numpy(), np.asarray(jhold))
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-6)
    if not with_valid and hysteresis == 0.0:
        one, _, _ = tk.peak_hold_triggers(_t(x[0, 0]), 0.1, 0.0)
        want = _peak_hold_oracle(x[0, 0].astype(np.float64), 0.1, 0.0)
        np.testing.assert_array_equal(one.numpy()[:-1], want[:-1])


def _tones(freqs, amps, n=8192, fs=FS, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = sum(a * np.sin(2 * np.pi * f * t / fs + 0.3 * i) for i, (f, a) in enumerate(zip(freqs, amps)))
    return (x + noise * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("threshold,hysteresis", [(0.0, 0.0), (0.1, 0.0), (0.0, 0.4)])
def test_spectral_fundamental_matches_jax(threshold, hysteresis):
    """Batched: a pure sine, a sine with strong harmonics, a two-note chord,
    noise and silence. Record index equal; value, offset and fundamental
    rtol 1e-5 (two FFTs, rounded differently); the walk ends after as many
    iterations as the records it accepted plus one."""
    x = np.stack([
        _tones([441.3], [0.5]),
        _tones([220.0, 440.0, 660.0, 880.0], [0.3, 0.25, 0.2, 0.1]),
        _tones([261.6, 329.6], [0.4, 0.35], noise=0.01),
        (np.random.default_rng(1).standard_normal(8192) * 0.1).astype(np.float32),
        np.zeros(8192, np.float32),
    ])
    f, c, rec = tk.spectral_fundamental(_t(x), FS, threshold=threshold, hysteresis=hysteresis)
    jf_, jc, jrec = jk.spectral_fundamental(jnp.asarray(x), FS, threshold=threshold, hysteresis=hysteresis)
    np.testing.assert_array_equal(rec.index.numpy(), np.asarray(jrec.index))
    np.testing.assert_allclose(rec.value.numpy(), np.asarray(jrec.value), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rec.offset.numpy(), np.asarray(jrec.offset), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf_), rtol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5)
    assert 1 <= tk.walk_iterations <= tk.MAX_WALK_ITERATIONS
    if threshold == 0.0 and hysteresis == 0.0:
        assert abs(float(f[0]) - 441.3) < FS / 8192  # within one bin


def test_quad_delta_matches_jax():
    spec = np.fft.rfft(_tones([1000.0, 3000.0], [0.5, 0.2], n=1024, noise=0.01)).astype(np.complex64)
    spec[5] = 0.0
    got = tk._quad_delta(_t(spec)).numpy()
    want = np.asarray(jk._quad_delta(jnp.asarray(spec)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_median_record_filter_matches_jax():
    rng = np.random.default_rng(2)
    hist = np.where(rng.random((4, 8)) < 0.3, -1.0, rng.uniform(10, 40, (4, 8))).astype(np.float32)
    hist[0] = -1.0
    index = np.array([12, 30, 7, 25], np.int32)
    offset = np.array([0.25, 0.9, 0.1, 0.6], np.float32)
    value = np.ones(4, np.float32)
    hist_t, rec_t, use_t = tk.median_record_filter(_t(hist), tk.BinRecord(_t(index), _t(value), _t(offset)))
    hist_j, rec_j, use_j = jk.median_record_filter(
        jnp.asarray(hist), jk.BinRecord(jnp.asarray(index), jnp.asarray(value), jnp.asarray(offset))
    )
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))
    np.testing.assert_array_equal(use_t.numpy(), np.asarray(use_j))
    np.testing.assert_array_equal(rec_t.index.numpy(), np.asarray(rec_j.index))
    np.testing.assert_array_equal(rec_t.offset.numpy(), np.asarray(rec_j.offset))


def test_goertzel_and_phase_offset_match_jax():
    """Goertzel rtol 1e-5 of the correlation's magnitude (a 4096-term f32
    sum in another order); the phase-lock offset atol 1e-3 samples."""
    x = np.stack([_tones([441.3], [0.4], n=4096), _tones([1323.9], [0.2], n=4096, noise=0.01)])
    omega = np.array([37.66, 112.96], np.float32)
    radians = (2 * np.pi * omega / 4096).astype(np.float32)
    z = tk.goertzel(_t(x), _t(radians)).numpy()
    jz = np.asarray(jk.goertzel(jnp.asarray(x), jnp.asarray(radians)))
    np.testing.assert_allclose(z, jz, rtol=0, atol=1e-5 * float(np.abs(jz).max()))
    fund = (FS * omega / 4096).astype(np.float32)
    cycles = (FS / fund).astype(np.float32)
    offs = (omega - np.floor(omega)).astype(np.float32)
    got = tk.trigger_phase_offset(_t(x), _t(omega), _t(cycles), 700.0, FS, _t(fund), _t(offs), torch.tensor(30.0))
    want = jk.trigger_phase_offset(
        jnp.asarray(x), jnp.asarray(omega), jnp.asarray(cycles), jnp.float32(700.0), FS,
        jnp.asarray(fund), jnp.asarray(offs), jnp.float32(30.0),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


def test_spectral_colour_track_matches_jax_on_the_same_bands():
    """Given the same bands the colour track is elementwise plus a 3-band
    scan: colours and state within 1e-5 of JAX's."""
    rng = np.random.default_rng(3)
    bands = (rng.standard_normal((2, 2, 3, 2048)) * 0.3).astype(np.float32)
    bands[1, 1] = 0.0  # silence: colours fall back to the key colour
    band_colours = np.array([[1.0, 0.1, 0.1], [0.1, 1.0, 0.1], [0.1, 0.1, 1.0]], np.float32)
    key = rng.random((2, 2, 3)).astype(np.float32)
    s0 = np.zeros((2, 2, 3), np.float32)
    got, gs = tk.spectral_colour_track(_t(bands), torch.tensor(0.979), _t(band_colours), _t(key), torch.tensor(0.7), _t(s0))
    want, ws = jk.spectral_colour_track(
        jnp.asarray(bands), jnp.float32(0.979), jnp.asarray(band_colours), jnp.asarray(key), jnp.float32(0.7), jnp.asarray(s0)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got[1, 1].numpy(), np.broadcast_to(key[1, 1] * 0.3, (2048, 3)), rtol=1e-6)
