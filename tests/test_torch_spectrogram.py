"""The PyTorch port's SpectrogramProcessor, its step functions, image and
pacer against the JAX package on the CPU. Audio is made with numpy from a
seed and pushed into both. Columns are compared by the byte rule (every byte
within 1 LSB, at most 0.1% of bytes different, alpha exactly 255: the
quantization truncates); the carried LineGraphState at rtol 1e-5 / atol 1e-7,
the bound tests/test_torch_spectrum.py holds analyze_frames to (the two
packages run different FFT libraries); counters and lags exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.core.config import SpectrumChannels as JChannels
from signalizer_tpu.core.config import ViewScaling as JScaling
from signalizer_tpu.kernels.spectrum import LineGraphState as JaxState
from signalizer_tpu.views import spectrogram as jv
from signalizer_tpu_torch import ColumnPacer, SpectrogramImage, SpectrogramProcessor, SpectrumChannels, ViewScaling
from signalizer_tpu_torch.kernels.spectrum import line_graph_state_from_arrays
from signalizer_tpu_torch.views import spectrogram as tv

from test_torch_colormap import assert_bytes_close

FS = 48_000.0
P = 64
WINDOW = 256


def pair(pairs=2, **kw):
    """(JAX processor, port processor) with the same settings."""
    kw = dict(pairs=pairs, axis_points=P, window_size=WINDOW, sample_rate=FS, blob_ms=1.0, **kw)
    jkw = dict(kw, fft_backend="xla")
    if "view_scaling" in kw:
        jkw["view_scaling"] = JScaling(kw["view_scaling"])
    if "configuration" in kw:
        jkw["configuration"] = JChannels(kw["configuration"])
    return jv.SpectrogramProcessor(**jkw), SpectrogramProcessor(device="cpu", **kw)


def audio(rng, pairs, n):
    """[pairs*2, n]: tones plus noise; with more than one pair the last is
    silent."""
    t = np.arange(n) / FS
    x = (rng.standard_normal((pairs * 2, n)) * 0.05).astype(np.float32)
    for ch in range(pairs * 2):
        x[ch] += 0.4 * np.sin(2 * np.pi * (500.0 + 1700.0 * ch) * t).astype(np.float32)
    if pairs > 1:
        x[-2:] = 0.0
    return x


def assert_state_close(tp, jp):
    np.testing.assert_allclose(tp.state.magnitude.numpy(), np.asarray(jp._state.magnitude), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("route", ["device", "host"])
def test_processor_matches_jax_over_ragged_pushes(route):
    """Ragged pushes, a pull after each (some capped), three pairs so that
    the colour rotation and the blend run."""
    jp, tp = pair(pairs=3, device_ingest=(route == "device"))
    assert tp.device_ingest == jp.device_ingest == (route == "device")
    rng = np.random.default_rng(11)
    stream = audio(rng, 3, 6000)
    at, total = 0, 0
    for i, n in enumerate([300, 48, 1, 700, 95, 1500, 47, 640, 13, 1200]):
        block = stream[:, at : at + n]
        at += n
        jp.push(block)
        tp.push(block)
        cap = 4 if i % 4 == 3 else None
        want, got = jp.pull(cap), tp.pull(cap)
        assert got.shape == want.shape and got.dtype == np.uint8
        if got.size:
            assert_bytes_close(got, want)
        total += got.shape[0]
        assert tp.batcher.frames_ready() == jp.batcher.frames_ready()
        assert tp.batcher.dropped_frames == jp.batcher.dropped_frames
        assert tp.freshness_lag() == jp.freshness_lag()
        if route == "device":
            assert tp.batcher.frames_produced == jp.batcher.frames_produced
        assert_state_close(tp, jp)
    assert total > 60
    assert_bytes_close(tp.image.snapshot(), jp.image.snapshot())
    if route == "device":
        np.testing.assert_array_equal(tp.ring.numpy(), np.asarray(jp._ring))


def test_fractional_hop_takes_the_host_batcher_and_matches_jax():
    jp = jv.SpectrogramProcessor(pairs=1, axis_points=P, window_size=WINDOW, blob_ms=1.01, fft_backend="xla")
    tp = SpectrogramProcessor(pairs=1, device="cpu", axis_points=P, window_size=WINDOW, blob_ms=1.01)
    assert not tp.device_ingest and not jp.device_ingest and tp.ring is None
    stream = audio(np.random.default_rng(12), 1, 3000)
    for at in range(0, 3000, 600):
        jp.push(stream[:, at : at + 600])
        tp.push(stream[:, at : at + 600])
        want, got = jp.pull(), tp.pull()
        assert_bytes_close(got, want)
        assert tp.freshness_lag() == jp.freshness_lag()
    assert_state_close(tp, jp)


def test_both_ingest_routes_give_the_same_bytes():
    """The package's own contract: the hop-only device route and the host
    batcher emit the same columns byte for byte, and carry the same state
    bit for bit."""
    dev = SpectrogramProcessor(pairs=2, device="cpu", axis_points=P, window_size=WINDOW, blob_ms=1.0, device_ingest=True)
    host = SpectrogramProcessor(pairs=2, device="cpu", axis_points=P, window_size=WINDOW, blob_ms=1.0, device_ingest=False)
    stream = audio(np.random.default_rng(13), 2, 5000)
    at = 0
    for n in [255, 1, 300, 48, 2000, 96, 1000, 700, 600]:
        for p in (dev, host):
            p.push(stream[:, at : at + n])
        at += n
        a, b = dev.pull(), host.pull()
        assert a.shape == b.shape and np.array_equal(a, b)
        assert dev.freshness_lag() == host.freshness_lag()
    assert torch.equal(dev.state.magnitude, host.state.magnitude)
    assert dev.batcher.dropped_frames == host.batcher.dropped_frames == 0
    # one readback per upload unit against one per pull
    assert dev.readbacks >= host.readbacks > 0


def test_drops_and_reprime_match_jax():
    """A burst beyond the pending limit drops frames and re-primes the
    device route on the absolute frame grid, as in the JAX package."""
    jp, tp = pair(pairs=1, device_ingest=True)
    stream = audio(np.random.default_rng(14), 1, 12000)
    at = 0
    for n in [500, 9000, 300, 2000]:
        jp.push(stream[:, at : at + n])
        tp.push(stream[:, at : at + n])
        at += n
        want, got = jp.pull(), tp.pull()
        assert got.shape == want.shape
        assert_bytes_close(got, want)
        assert tp.batcher.dropped_frames == jp.batcher.dropped_frames
        assert tp.freshness_lag() == jp.freshness_lag()
    assert tp.batcher.dropped_frames > 0
    assert_state_close(tp, jp)


@pytest.mark.parametrize("mode", [SpectrumChannels.LEFT, SpectrumChannels.MIDSIDE], ids=lambda m: m.name)
def test_step_with_valid_mask_matches_jax_from_a_carried_state(mode):
    """spectrogram_step on a padded batch (T = 8 with 5 valid) from a
    carried-over state."""
    jp, tp = pair(pairs=2, configuration=mode, view_scaling=ViewScaling.LOGARITHMIC)
    rng = np.random.default_rng(15)
    frames = (rng.standard_normal((2, 8, 2, WINDOW)) * 0.2).astype(np.float32)
    valid = np.array([True, True, False, True, True, False, True, False])
    rows = tp.constant.state_channels
    mag0 = (rng.random((2, 2, rows, P)) * 0.02).astype(np.float32)
    phase0 = np.zeros((2, 2, P), np.float32)
    state = line_graph_state_from_arrays(mag0, phase0, "cpu")
    cols, out_state = tv.spectrogram_step(
        tp.constant, state, torch.from_numpy(frames), tp._colours, tp._ratios, valid
    )
    want, jstate = jv._spectrogram_step(
        jp.constant, JaxState(jnp.asarray(mag0), jnp.asarray(phase0)), jnp.asarray(frames),
        jp._colours, jp._ratios, jnp.asarray(valid),
    )
    assert out_state is state and cols.shape == (8, P, 4)
    assert_bytes_close(cols.numpy()[valid], np.asarray(want)[valid])
    np.testing.assert_allclose(state.magnitude.numpy(), np.asarray(jstate.magnitude), rtol=1e-5, atol=1e-7)


def test_ring_step_matches_jax_from_a_carried_ring():
    """spectrogram_ring_step on a padded upload unit (t_max = 4, 3 valid)
    from a carried ring and state: the same ring bit for bit, the valid
    frames' columns by the byte rule."""
    jp, tp = pair(pairs=2, device_ingest=True)
    rng = np.random.default_rng(16)
    hop, h = tp._source.hop, tp._source.history
    ring0 = (rng.standard_normal((2, 2, h)) * 0.2).astype(np.float32)
    new = np.zeros((2, 2, 4 * hop), np.float32)
    new[..., : 3 * hop] = (rng.standard_normal((2, 2, 3 * hop)) * 0.2).astype(np.float32)
    frame_valid = np.array([False, True, True, True])
    mag0 = (rng.random((2, 2, 1, P)) * 0.02).astype(np.float32)
    phase0 = np.zeros((2, 2, P), np.float32)
    tp.load_state(line_graph_state_from_arrays(mag0, phase0, "cpu"), ring=ring0)
    cols, ring, state = tv.spectrogram_ring_step(
        tp.constant, tp.ring, tp.state, torch.from_numpy(new), 3 * hop, 3, tp._colours, tp._ratios, hop=hop
    )
    want, jring, jstate = jv._spectrogram_ring_step(
        jp.constant, jnp.asarray(ring0), JaxState(jnp.asarray(mag0), jnp.asarray(phase0)), jnp.asarray(new),
        jnp.int32(3 * hop), jnp.asarray(frame_valid), jp._colours, jp._ratios, hop=hop,
    )
    assert np.array_equal(ring.numpy(), np.asarray(jring))
    assert_bytes_close(cols.numpy(), np.asarray(want)[frame_valid])
    np.testing.assert_allclose(state.magnitude.numpy(), np.asarray(jstate.magnitude), rtol=1e-5, atol=1e-7)


def test_colour_tables_and_ratios_equal_jax():
    jp, tp = pair(pairs=5)
    assert np.array_equal(tp._colours.numpy(), np.asarray(jp._colours))
    assert np.array_equal(tp._ratios.numpy(), np.asarray(jp._ratios))
    assert np.array_equal(tp._bounds.numpy(), np.asarray(jnp.cumsum(jp._ratios)))


def test_image_equals_jax():
    rng = np.random.default_rng(17)
    for width, stretch in ((32, 1.0), (40, 2.0), (33, 3.0)):
        ours, theirs = SpectrogramImage(width, 16, stretch), jv.SpectrogramImage(width, 16, stretch)
        for t in (1, 5, 0, 31, 64, 7):
            cols = rng.integers(0, 256, (t, 16, 4)).astype(np.uint8)
            ours.push_columns(cols)
            theirs.push_columns(cols)
            assert np.array_equal(ours.snapshot(), theirs.snapshot())
        ours.push_debug_checkerboard(6)
        theirs.push_debug_checkerboard(6)
        assert np.array_equal(ours.snapshot(), theirs.snapshot())
        assert ours.snapshot().shape == (width, 16, 4)


@pytest.mark.parametrize("smoothing", [0.0, 0.5, 0.9])
def test_pacer_equals_jax(smoothing):
    rng = np.random.default_rng(18)
    ours, theirs = ColumnPacer(smoothing), jv.ColumnPacer(smoothing)
    for available in rng.integers(0, 12, 200):
        assert ours.columns_for_tick(int(available)) == theirs.columns_for_tick(int(available))


def test_pacer_paces_pulls_as_in_jax():
    jp, tp = pair(pairs=1, device_ingest=True)
    jp.pacer, tp.pacer = jv.ColumnPacer(0.8), ColumnPacer(0.8)
    stream = audio(np.random.default_rng(19), 1, 8000)
    for at in range(0, 8000, 800):
        jp.push(stream[:, at : at + 800])
        tp.push(stream[:, at : at + 800])
        want, got = jp.pull(), tp.pull()
        assert got.shape == want.shape
        if got.size:
            assert_bytes_close(got, want)


def test_physical_checks():
    """A sine's column peaks at its pixel, silence gives the black column
    with alpha 255, the lag after a pull stays under one hop, nothing is
    dropped."""
    p = SpectrogramProcessor(
        pairs=1, device="cpu", axis_points=128, window_size=1024, sample_rate=FS, blob_ms=10.0,
        view_scaling=ViewScaling.LINEAR,
    )
    n = np.arange(4800)
    tone = (0.8 * np.sin(2 * np.pi * 6000.0 * n / FS)).astype(np.float32)
    cols = []
    for at in range(0, 4800, 800):
        p.push(np.stack([tone[at : at + 800], np.zeros(800, np.float32)]))
        cols.append(p.pull())
        lag = p.freshness_lag()
        assert lag is None or 0 <= lag < 480
    cols = np.concatenate(cols)
    assert cols.shape[0] == 1 + (4800 - 1024) // 480 and p.batcher.dropped_frames == 0
    brightness = cols[-1, :, :3].astype(int).sum(-1)
    expect = int(np.argmin(np.abs(p.constant.mapped_frequencies.numpy() - 6000.0)))
    assert abs(int(np.argmax(brightness)) - expect) <= 1
    assert (cols[..., 3] == 255).all()
    quiet = SpectrogramProcessor(pairs=2, device="cpu", axis_points=P, window_size=WINDOW, blob_ms=1.0)
    quiet.push(np.zeros((4, 1000), np.float32))
    black = quiet.pull()
    assert black.shape[0] > 0 and (black[..., :3] == 0).all() and (black[..., 3] == 255).all()


def test_reset_and_empty_pull():
    tp = SpectrogramProcessor(pairs=1, device="cpu", axis_points=P, window_size=WINDOW, blob_ms=1.0)
    assert tp.pull().shape == (0, P, 4) and tp.freshness_lag() is None
    tp.push(audio(np.random.default_rng(20), 1, 600))
    assert tp.pull().shape[0] > 0 and tp.state.magnitude.any() and tp.ring.any()
    tp.reset()
    assert not tp.state.magnitude.any() and not tp.ring.any()


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU refusal is not reachable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        SpectrogramProcessor(pairs=1, axis_points=P, window_size=WINDOW)
