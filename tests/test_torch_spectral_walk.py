"""Kernel F's plain versions (the spectral trigger's candidate walk and the
median filter, ``signalizer_tpu_torch/kernels/spectral_walk.py``; the
spectrum entries' also form the magnitudes and offsets from the rfft)
against
the JAX package's ``spectral_fundamental`` and ``median_record_filter`` on
the CPU, and a ``cycles.oscilloscope`` session (the walk once a tick)
against the JAX session. Inputs are made with numpy from a seed.

Tolerances: the record's index equal; value and offset rtol 1e-5 where
each side takes its own FFT (two FFTs round differently); the median
filter's history and record equal on the same walk record. Each case also
holds the walk to the reference's per-bin loop (OscilloscopeDSP.inl:134-184,
bin by bin in float32 numpy): the same index, and as many passes a row as
that loop accepted bins, plus the one that accepts nothing.

The long chains (dozens and hundreds of acceptances, each a doubling) come
from bins no FFT of float32 samples gives: they are fed to both walks
directly, the JAX one through a stand-in for its rfft and offsets. XLA on
the CPU flushes subnormals to zero, so the chain held to JAX starts at the
smallest normal float; the longest chain float32 allows (from the smallest
subnormal) is held to the per-bin loop alone.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.kernels import oscilloscope as jk
from signalizer_tpu_torch.kernels import oscilloscope as tk
from signalizer_tpu_torch.kernels import spectral_walk as sw

FS = 48_000.0
N = 8192
QS = 2.0 ** (0.25 / 12.0) - 1.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tones(freqs, amps, n=N, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = sum(a * np.sin(2 * np.pi * f * t / FS + 0.3 * i) for i, (f, a) in enumerate(zip(freqs, amps)))
    return (x + noise * rng.standard_normal(n)).astype(np.float32)


def _signals():
    """The rows of tests/test_torch_oscilloscope.py's spectral case: a pure
    sine, a sine with strong harmonics, a two-note chord, noise, silence."""
    return np.stack([
        _tones([441.3], [0.5]),
        _tones([220.0, 440.0, 660.0, 880.0], [0.3, 0.25, 0.2, 0.1]),
        _tones([261.6, 329.6], [0.4, 0.35], noise=0.01),
        (np.random.default_rng(1).standard_normal(N) * 0.1).astype(np.float32),
        np.zeros(N, np.float32),
    ])


def _per_bin_walk(mags, offsets, n, threshold, hysteresis):
    """The reference's walk, one bin at a time in float32, each row at
    once: (index, value, offset, accepted bins) per row."""
    mags = np.asarray(mags, np.float32)
    offs = np.asarray(offsets, np.float32)
    one, two = np.float32(1.0), np.float32(2.0)
    inv_h = np.float32(1.0 - hysteresis)
    iq = np.float32((1.0 - hysteresis) * QS)
    qs = np.float32(QS)
    floor = np.float32(threshold) * np.float32(n) / np.float32(6.0)
    rows = mags.shape[0]
    index = np.ones(rows, np.int32)
    value = np.maximum(floor, mags[:, 1])
    offset = offs[:, 1].copy()
    accepted = np.zeros(rows, np.int64)
    with np.errstate(all="ignore"):
        for i in range(2, n // 2):
            v = mags[:, i]
            max_omega = index.astype(np.float32) + offset
            positive = max_omega > 0
            factor = (np.float32(i) + offs[:, i]) / np.where(positive, max_omega, one)
            sensitivity = v / np.maximum(value, np.float32(1e-30))
            ok = (inv_h * sensitivity > np.float32(20.0)) | (np.abs(one - factor) < iq)
            ok |= inv_h * np.abs(factor - np.floor(factor + np.float32(0.5))) > qs
            take = (inv_h * v > value * two) & np.where(positive, ok, True)
            index = np.where(take, i, index).astype(np.int32)
            value = np.where(take, v, value)
            offset = np.where(take, offs[:, i], offset)
            accepted += take
    return index, value, offset, accepted


def _check_against_per_bin(rec, passes, mags, offsets, n, threshold, hysteresis):
    index, value, offset, accepted = _per_bin_walk(mags, offsets, n, threshold, hysteresis)
    np.testing.assert_array_equal(rec.index.numpy(), index)
    np.testing.assert_array_equal(rec.value.numpy(), value)
    np.testing.assert_array_equal(rec.offset.numpy(), offset)
    want = np.minimum(accepted + 1, sw.MAX_WALK_ITERATIONS)
    np.testing.assert_array_equal(passes.numpy(), want)
    return accepted


@pytest.mark.parametrize("threshold,hysteresis", [(0.0, 0.0), (0.1, 0.0), (0.0, 0.4), (0.1, 0.4)])
def test_plain_walk_matches_jax_spectral_fundamental(threshold, hysteresis):
    """The five signals through the port's rfft and plain walk against the
    JAX ``spectral_fundamental``; ``spectral_fundamental`` on CPU tensors
    takes the plain walk and counts its iterations."""
    x = _signals()
    mags, offsets = tk.spectral_bins(_t(x))
    rec, passes = sw.spectral_walk_plain(mags, offsets, N, threshold, hysteresis)
    _, _, jrec = jk.spectral_fundamental(jnp.asarray(x), FS, threshold=threshold, hysteresis=hysteresis)
    np.testing.assert_array_equal(rec.index.numpy(), np.asarray(jrec.index))
    np.testing.assert_allclose(rec.value.numpy(), np.asarray(jrec.value), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rec.offset.numpy(), np.asarray(jrec.offset), rtol=1e-5, atol=1e-5)
    accepted = _check_against_per_bin(rec, passes, mags.numpy(), offsets.numpy(), N, threshold, hysteresis)
    assert accepted[-1] == 0 and passes[-1] == 1  # silence accepts nothing
    # the module's dispatch and spectral_fundamental's iteration count
    rec2, passes2 = sw.spectral_walk(mags, offsets, N, threshold, hysteresis)
    assert all(torch.equal(a, b) for a, b in zip(rec, rec2)) and torch.equal(passes, passes2)
    _, _, rec3 = tk.spectral_fundamental(_t(x), FS, threshold=threshold, hysteresis=hysteresis)
    assert torch.equal(rec3.index, rec.index)
    assert tk.walk_iterations == int(passes.max()) == int(accepted.max()) + 1


SETTINGS = [(0.0, 0.0), (0.1, 0.0), (0.0, 0.4), (0.1, 0.4)]


def _history(rows, seed):
    """-1 sentinels in the first row, half of the second, far omegas after."""
    rng = np.random.default_rng(seed)
    hist = np.full((rows, sw.MEDIAN_FILTER_SIZE), -1.0, np.float32)
    hist[1, 4:] = rng.uniform(10, 40, 4)
    hist[2:] = rng.uniform(100, 400, (rows - 2, sw.MEDIAN_FILTER_SIZE))
    return _t(hist)


@pytest.mark.parametrize("threshold,hysteresis", SETTINGS)
def test_spectrum_plain_matches_jax_spectral_fundamental_and_median_filter(threshold, hysteresis):
    """The spectrum entries' plain versions (``spec.abs()``, ``_quad_delta``
    and the plain loop on the rfft, then the median filter) on the five
    signals against the JAX ``spectral_fundamental`` and
    ``median_record_filter`` from the same numpy x, over three carried
    calls: the index equal, value and offset rtol 1e-5 (two FFTs), the
    history (omegas) rtol 1e-5; on CPU tensors the entries take them."""
    x = _signals()
    spec = torch.fft.rfft(_t(x), dim=-1)
    rec, passes = sw.spectral_walk_spectrum_plain(spec, N, threshold, hysteresis)
    _, _, jrec = jk.spectral_fundamental(jnp.asarray(x), FS, threshold=threshold, hysteresis=hysteresis)
    np.testing.assert_array_equal(rec.index.numpy(), np.asarray(jrec.index))
    np.testing.assert_allclose(rec.value.numpy(), np.asarray(jrec.value), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rec.offset.numpy(), np.asarray(jrec.offset), rtol=1e-5, atol=1e-5)
    assert passes[-1] == 1  # silence accepts nothing
    rec2, passes2 = sw.spectral_walk_spectrum(spec, N, threshold, hysteresis)
    assert all(torch.equal(a, b) for a, b in zip(rec, rec2)) and torch.equal(passes, passes2)
    hist, jhist = _history(5, 11), jnp.asarray(_history(5, 11).numpy())
    for _ in range(3):
        hist, filtered, _ = sw.spectral_walk_filtered_spectrum(spec, N, hist, threshold, hysteresis)
        jhist, jfiltered, _ = jk.median_record_filter(jhist, jrec)
        np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(filtered.index.numpy(), np.asarray(jfiltered.index))
        np.testing.assert_allclose(filtered.value.numpy(), np.asarray(jfiltered.value), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(filtered.offset.numpy(), np.asarray(jfiltered.offset), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("threshold,hysteresis", SETTINGS)
def test_spectrum_plain_is_bit_equal_to_spectral_bins_and_the_plain_loop(threshold, hysteresis):
    """The spectrum entries' plain versions on the rfft of the five signals
    are ``spectral_bins`` followed by the bins entries' plain versions, bit
    for bit: record and passes, and over three carried calls the filtered
    record and history; ``spectral_fundamental`` on CPU tensors gives the
    same record."""
    x = _t(_signals())
    spec = torch.fft.rfft(x, dim=-1)
    mags, offsets = tk.spectral_bins(x)
    rec, passes = sw.spectral_walk_spectrum_plain(spec, N, threshold, hysteresis)
    want, want_passes = sw.spectral_walk_plain(mags, offsets, N, threshold, hysteresis)
    assert all(torch.equal(a, b) for a, b in zip(rec, want)) and torch.equal(passes, want_passes)
    _, _, rec3 = tk.spectral_fundamental(x, FS, threshold=threshold, hysteresis=hysteresis)
    assert all(torch.equal(a, b) for a, b in zip(rec3, want))
    hist = want_hist = _history(5, 13)
    for _ in range(3):
        hist, filtered, p = sw.spectral_walk_filtered_spectrum_plain(spec, N, hist, threshold, hysteresis)
        want_hist, want_filtered, wp = sw.spectral_walk_filtered_plain(mags, offsets, N, want_hist, threshold,
                                                                       hysteresis)
        assert torch.equal(hist, want_hist) and torch.equal(p, wp)
        assert all(torch.equal(a, b) for a, b in zip(filtered, want_filtered))


def _chain_bins(rows_start, length, ratio, start_value, seed, m=N // 2 + 1):
    """Bins [len(rows_start), m]: small noise everywhere (offsets in
    [-0.5, 0.5)), then in each row a chain of ``length`` bins from
    ``rows_start[r]`` on, each ``ratio`` times the last from ``start_value``
    (offset 0); bin 1's offset 0.5, so that bin 2 is no harmonic of it.
    A start of None leaves the row silent."""
    rng = np.random.default_rng(seed)
    rows = len(rows_start)
    mags = (rng.random((rows, m)) * 1e-12).astype(np.float32)
    offsets = rng.uniform(-0.5, 0.5, (rows, m)).astype(np.float32)
    offsets[:, 1] = 0.5
    for r, start in enumerate(rows_start):
        if start is None:
            mags[r] = 0.0
            continue
        v = np.float32(start_value)
        for k in range(length):
            mags[r, start + k] = v
            offsets[r, start + k] = 0.0
            v = np.float32(v * np.float32(ratio))
    return mags, offsets


def _doubling_chain(first: float, rows: int = 2, m=N // 2 + 1):
    """Each bin from 2 on just over twice the last (the next float32 above
    2x), from ``first`` until float32 overflows, then one inf bin (never
    accepted: twice the last finite bin is inf already): the longest chain
    of acceptances float32 allows from ``first``. The last row is silent."""
    mags = np.zeros((rows, m), np.float32)
    offsets = np.zeros((rows, m), np.float32)
    offsets[:, 1] = 0.5
    v, i = np.float32(first), 2
    with np.errstate(over="ignore"):
        while np.isfinite(v):
            mags[:, i] = v
            v = np.nextafter(np.float32(v * np.float32(2.0)), np.float32(np.inf))
            i += 1
    mags[:, i] = np.inf
    mags[-1] = 0.0
    return mags, offsets


def _jax_walk(mags, offsets, threshold, hysteresis):
    """The JAX ``spectral_fundamental``'s record on the given bins: its
    rfft, magnitude and offsets replaced by these arrays for the call."""
    spec = jnp.zeros(mags.shape, jnp.complex64)
    mags_j, offs_j = jnp.asarray(mags), jnp.asarray(offsets)
    stand_in = types.SimpleNamespace(
        fft=types.SimpleNamespace(rfft=lambda x, axis=-1: spec),
        abs=lambda a: mags_j if a is spec else jnp.abs(a),
    )

    class Jnp:
        def __getattr__(self, name):
            return getattr(stand_in, name, None) or getattr(jnp, name)

    saved = jk.jnp, jk._quad_delta
    jk.jnp, jk._quad_delta = Jnp(), (lambda s: offs_j)
    try:
        n = 2 * (mags.shape[-1] - 1)
        _, _, rec = jk.spectral_fundamental(jnp.zeros((mags.shape[0], n), jnp.float32), FS,
                                            threshold=threshold, hysteresis=hysteresis)
    finally:
        jk.jnp, jk._quad_delta = saved
    return rec


@pytest.mark.parametrize("threshold,hysteresis", [(0.0, 0.0), (0.1, 0.4)])
def test_plain_walk_long_chain_matches_jax(threshold, hysteresis):
    """Chains of 36 bins 4x apart (so that 1 - hysteresis = 0.6 still sees
    each bin beat the last twice over): low bins (no harmonics of each
    other), high bins (the same partial), a silent row. At threshold 0
    the first row accepts 36 bins."""
    mags, offsets = _chain_bins([2, 300, None], 36, 4.0, 1e-10, seed=5)
    rec, passes = sw.spectral_walk_plain(_t(mags), _t(offsets), N, threshold, hysteresis)
    jrec = _jax_walk(mags, offsets, threshold, hysteresis)
    np.testing.assert_array_equal(rec.index.numpy(), np.asarray(jrec.index))
    np.testing.assert_allclose(rec.value.numpy(), np.asarray(jrec.value), rtol=1e-5)
    np.testing.assert_allclose(rec.offset.numpy(), np.asarray(jrec.offset), rtol=1e-5, atol=1e-6)
    accepted = _check_against_per_bin(rec, passes, mags, offsets, N, threshold, hysteresis)
    if threshold == 0.0:
        assert accepted[0] >= 30
    assert accepted[-1] == 0


def test_plain_walk_near_the_float32_doubling_limit_matches_jax():
    """A doubling chain from the smallest normal float32 past 2^127: 254
    acceptances, the longest run that XLA's flushed subnormals leave the
    JAX loop."""
    mags, offsets = _doubling_chain(np.finfo(np.float32).tiny)
    rec, passes = sw.spectral_walk_plain(_t(mags), _t(offsets), N, 0.0, 0.0)
    jrec = _jax_walk(mags, offsets, 0.0, 0.0)
    np.testing.assert_array_equal(rec.index.numpy(), np.asarray(jrec.index))
    np.testing.assert_array_equal(rec.value.numpy(), np.asarray(jrec.value))
    np.testing.assert_array_equal(rec.offset.numpy(), np.asarray(jrec.offset))
    accepted = _check_against_per_bin(rec, passes, mags, offsets, N, 0.0, 0.0)
    assert accepted.tolist() == [254, 0] and passes.tolist() == [255, 1]
    assert float(rec.value[0]) > 2.0 ** 127


def test_plain_walk_longest_float32_chain_matches_the_per_bin_walk():
    """From the smallest subnormal float32 past 2^127: 276 acceptances, 277
    passes, under the 280-pass cap (``MAX_WALK_ITERATIONS``); the
    walk-only and filtered plain entries agree."""
    mags, offsets = _doubling_chain(np.float32(2.0 ** -149))
    rec, passes = sw.spectral_walk_plain(_t(mags), _t(offsets), N, 0.0, 0.0)
    accepted = _check_against_per_bin(rec, passes, mags, offsets, N, 0.0, 0.0)
    assert accepted.tolist() == [276, 0] and passes.tolist() == [277, 1]
    assert int(passes.max()) < sw.MAX_WALK_ITERATIONS
    history = torch.full((2, sw.MEDIAN_FILTER_SIZE), -1.0)
    hist, filtered, passes2 = sw.spectral_walk_filtered_plain(_t(mags), _t(offsets), N, history)
    want_hist, want, _ = sw.median_record_filter(history, rec)
    assert torch.equal(hist, want_hist) and torch.equal(passes2, passes)
    assert all(torch.equal(a, b) for a, b in zip(filtered, want))


def test_plain_walk_stops_at_the_pass_cap_as_jax():
    """No float32 spectrum reaches 280 acceptances at a hysteresis in the
    knob's range; at hysteresis -1 (1 - hysteresis = 2) every bin that
    merely beats the last is vastly better, so a rising run of 300 bins
    reaches the cap: both walks stop after their 280th pass, at the 280th
    bin of the run (the per-bin loop, which has no cap, goes on)."""
    mags, offsets = _chain_bins([2, 40, None], 300, 1.01, 1.0, seed=6)
    mags[1, 2:40] = 0.0  # nothing ahead of the second row's run
    rec, passes = sw.spectral_walk_plain(_t(mags), _t(offsets), N, 0.0, -1.0)
    jrec = _jax_walk(mags, offsets, 0.0, -1.0)
    np.testing.assert_array_equal(rec.index.numpy(), np.asarray(jrec.index))
    np.testing.assert_array_equal(rec.value.numpy(), np.asarray(jrec.value))
    np.testing.assert_array_equal(rec.offset.numpy(), np.asarray(jrec.offset))
    assert passes.tolist() == [sw.MAX_WALK_ITERATIONS, sw.MAX_WALK_ITERATIONS, 1]
    assert rec.index.tolist()[:2] == [2 + 279, 40 + 279]
    assert _per_bin_walk(mags, offsets, N, 0.0, -1.0)[3].tolist() == [300, 300, 0]


@pytest.mark.parametrize("threshold,hysteresis", [(0.0, 0.0), (0.1, 0.4)])
def test_filtered_plain_walk_matches_jax_median_record_filter(threshold, hysteresis):
    """The filtered entry's plain version: the walk (held to JAX above),
    then the median filter, equal to the JAX ``median_record_filter`` on
    the same walk record over three carried calls, from a history of -1
    sentinels (the median skipped), one half full, and one full of far
    omegas (the median taken)."""
    rng = np.random.default_rng(9)
    x = _signals()
    mags, offsets = tk.spectral_bins(_t(x))
    hist = np.full((5, sw.MEDIAN_FILTER_SIZE), -1.0, np.float32)
    hist[1, 4:] = rng.uniform(10, 40, 4)
    hist[2:] = rng.uniform(100, 400, (3, sw.MEDIAN_FILTER_SIZE))
    hist = _t(hist)
    for _ in range(3):
        new_hist, filtered, _ = sw.spectral_walk_filtered_plain(mags, offsets, N, hist, threshold, hysteresis)
        rec, _ = sw.spectral_walk_plain(mags, offsets, N, threshold, hysteresis)
        jhist, jrec, use = jk.median_record_filter(
            jnp.asarray(hist.numpy()),
            jk.BinRecord(jnp.asarray(rec.index.numpy()), jnp.asarray(rec.value.numpy()),
                         jnp.asarray(rec.offset.numpy())),
        )
        np.testing.assert_array_equal(new_hist.numpy(), np.asarray(jhist))
        np.testing.assert_array_equal(filtered.index.numpy(), np.asarray(jrec.index))
        np.testing.assert_array_equal(filtered.value.numpy(), np.asarray(jrec.value))
        np.testing.assert_array_equal(filtered.offset.numpy(), np.asarray(jrec.offset))
        hist = new_hist
    assert bool(np.asarray(use)[2:4].any())  # far history: the median replaced the detection


def test_kernel_entries_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device is refused, not walked."""
    mags = torch.zeros((2, 33), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sw.spectral_walk(mags, mags, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        sw.spectral_walk_filtered(mags, mags, 64, torch.zeros((2, 8), device="meta"))
    spec = torch.zeros((2, 33), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sw.spectral_walk_spectrum(spec, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        sw.spectral_walk_filtered_spectrum(spec, 64, torch.zeros((2, 8), device="meta"))


def test_cycles_preset_session_matches_the_jax_session():
    """The factory preset ``cycles.oscilloscope`` (the SPECTRAL trigger, the
    window locked to the detected cycles: the walk and the median filter
    once a tick) on the CPU against the JAX session, ten ticks, at the
    spectral-trigger tolerances of tests/test_torch_engine_session.py; the
    fundamental rtol 1e-5 and the Cycles window equal (it feeds the next
    tick: an ulp off, it moved the next trace by 1.8e-4)."""
    from test_torch_engine_session import _blocks, _check_osc, _check_spectrum, _check_vs, _pair, _run

    from signalizer_tpu_torch.params.transformatters import TimeMode
    from signalizer_tpu_torch.views.oscilloscope import TriggerMode

    def knobs(eng):
        assert eng.load_preset("cycles.oscilloscope")

    js, ts = _pair(knobs)
    osc = ts.processor("oscilloscope")
    assert osc.trigger_mode == TriggerMode.SPECTRAL and osc.time_mode == TimeMode.CYCLES
    windows = set()
    josc = js.processor("oscilloscope")
    for tick, (jf, tf) in enumerate(_run(js, ts, _blocks(23, 10))):
        _check_spectrum(jf, tf, tick)
        _check_osc(jf, tf, tick, wave_atol=1e-4)
        _check_vs(jf, tf, tick)
        np.testing.assert_allclose(tf.oscilloscope.fundamental.numpy(), np.asarray(jf.oscilloscope.fundamental),
                                   rtol=1e-5)
        assert osc._cycle_window == float(np.asarray(josc._cycle_window_dev)), tick
        windows.add(osc._cycle_window)
    assert len(windows) > 1  # the window followed the detected cycles
    counters = tf.diagnostics
    assert counters["session.failures"] == 0 and counters["session.fused_ticks"] == 10
