"""The PyTorch port's Spectrum step and SpectrumProcessor against the JAX
package, the goldens and the physics, on the CPU (plain versions of the
kernels). Inputs are made with numpy from a seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.core.config import BinInterpolation, SpectrumChannels, ViewScaling
from signalizer_tpu.core.constant import make_spectrum_constant as jax_make
from signalizer_tpu.kernels.spectrum import LineGraphState as JaxState
from signalizer_tpu.kernels.spectrum import analyze_frames as jax_analyze
from signalizer_tpu.kernels.spectrum import post_process as jax_post_process
from signalizer_tpu.kernels.spectrum import spectrum_values as jax_values
from signalizer_tpu_torch import SpectrumProcessor
from signalizer_tpu_torch.core.constant import make_spectrum_constant
from signalizer_tpu_torch.kernels.spectrum import (
    analyze_frames,
    init_line_graph_state,
    line_graph_state_from_arrays,
    post_process,
    spectrum_values,
    stitch_preliminary,
)
from signalizer_tpu_torch.utils.diagnostics import counter

from test_golden import CASES as GOLDEN_CASES
from test_golden import GOLDEN_DIR
from test_golden import _input as golden_input

FS = 48_000.0
MODES = [
    SpectrumChannels.LEFT,
    SpectrumChannels.RIGHT,
    SpectrumChannels.MERGE,
    SpectrumChannels.SIDE,
    SpectrumChannels.PHASE,
    SpectrumChannels.SEPARATE,
    SpectrumChannels.MIDSIDE,
    SpectrumChannels.COMPLEX,
]
INTERPS = [BinInterpolation.NONE, BinInterpolation.LINEAR, BinInterpolation.LANCZOS]
CPU = torch.device("cpu")


def _pair(**kw):
    kw.setdefault("sample_rate", FS)
    return jax_make(fft_backend="xla", **kw), make_spectrum_constant(device=CPU, **kw)


def _undb(tc, results):
    """Display values back to linear magnitudes (clip_db -> 0): the
    cancellation row of PHASE is compared here, because it is
    1 - |l+r|/(|l|+|r|) of nearly equal numbers, whose log swings to the
    clip under any other FFT's rounding."""
    lower, dyr = (float(v) for v in tc.display_scalars[1:3])
    lin = np.exp(np.asarray(results, np.float64) / dyr) * lower
    return np.where(np.asarray(results) == float(tc.clip_db), 0.0, lin)


@pytest.mark.parametrize("interp", INTERPS, ids=lambda i: i.name)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_analyze_frames_matches_jax(mode, interp):
    """T=12 frames for 2 pairs from a carried random state. Magnitude
    modes: rtol/atol 1e-5 against JAX's linear decay (the same operations,
    another order of pole products) and 2e-4 against its default log-domain
    form (the bound the JAX package holds its two forms to,
    tests/test_spectrum.py:488-490). PHASE: the magnitude row at 1e-5; the
    cancellation row and phase state at atol 2e-3 in linear units, the
    bound tests/test_spectrum.py:98 holds PHASE values to."""
    jc, tc = _pair(
        axis_points=64, window_size=256, configuration=mode,
        bin_interpolation=interp, view_scaling=ViewScaling.LOGARITHMIC, min_freq=40.0,
    )
    rng = np.random.default_rng(100 + 3 * int(mode) + int(interp))
    frames = (rng.standard_normal((2, 12, 2, 256)) * 0.3).astype(np.float32)
    mag0 = (rng.random((2, 2, tc.state_channels, 64)) * 0.05).astype(np.float32)
    phase0 = (rng.random((2, 2, 64)) * 0.05).astype(np.float32)

    state = line_graph_state_from_arrays(mag0, phase0, CPU)
    got = analyze_frames(tc, state, torch.from_numpy(frames))
    assert got.state is state
    res = got.results.numpy()
    jstate = JaxState(jnp.asarray(mag0), jnp.asarray(phase0))
    lin = jax_analyze(jc, jstate, jnp.asarray(frames), decay_domain="linear")
    want = np.asarray(lin.results)
    assert res.shape == want.shape == (2, 12, 2, tc.state_channels, 64)

    if mode == SpectrumChannels.PHASE:
        np.testing.assert_allclose(res[..., 0, :], want[..., 0, :], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_undb(tc, res[..., 1, :]), _undb(tc, want[..., 1, :]), atol=2e-3)
        np.testing.assert_allclose(state.magnitude.numpy(), np.asarray(lin.state.magnitude), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(state.phase.numpy(), np.asarray(lin.state.phase), atol=2e-3)
        vals = spectrum_values(tc, torch.from_numpy(frames)).numpy()
        np.testing.assert_allclose(vals, np.asarray(jax_values(jc, jnp.asarray(frames))), rtol=2e-3, atol=2e-3)
        return

    np.testing.assert_allclose(res, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.magnitude.numpy(), np.asarray(lin.state.magnitude), rtol=1e-5, atol=1e-7)
    auto = jax_analyze(jc, jstate, jnp.asarray(frames))  # T=12 takes the log form
    np.testing.assert_allclose(res, np.asarray(auto.results), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state.magnitude.numpy(), np.asarray(auto.state.magnitude), rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("mode", [m for m in MODES if m != SpectrumChannels.PHASE], ids=lambda m: m.name)
def test_magnitude_values_and_post_process_match_jax_on_cpu(mode):
    """The two halves of the magnitude tail on the CPU: spectrum_values then
    post_process, against JAX's with its linear decay, T=3 with a padded
    frame. rtol/atol 1e-5, as for analyze_frames."""
    jc, tc = _pair(
        axis_points=64, window_size=256, configuration=mode,
        bin_interpolation=BinInterpolation.LANCZOS, view_scaling=ViewScaling.LOGARITHMIC,
    )
    rng = np.random.default_rng(300 + int(mode))
    frames = (rng.standard_normal((2, 3, 2, 256)) * 0.3).astype(np.float32)
    mag0 = (rng.random((2, 2, tc.state_channels, 64)) * 0.05).astype(np.float32)
    phase0 = np.zeros((2, 2, 64), np.float32)
    valid = np.array([True, False, True])
    vals = spectrum_values(tc, torch.from_numpy(frames))
    jvals = jax_values(jc, jnp.asarray(frames))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-5, atol=1e-5)
    state = line_graph_state_from_arrays(mag0, phase0, CPU)
    got = post_process(tc, state, vals, valid=valid)
    want = jax_post_process(
        jc, JaxState(jnp.asarray(mag0), jnp.asarray(phase0)), jvals, valid=valid, decay_domain="linear"
    )
    np.testing.assert_allclose(got.results.numpy(), np.asarray(want.results), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.magnitude.numpy(), np.asarray(want.state.magnitude), rtol=1e-5, atol=1e-7)


def _recording(monkeypatch, module, name, result):
    """Replace ``module.name`` by a stand-in that records its tensor
    arguments' devices and returns ``result``."""
    calls = []

    def stand_in(*args, **kwargs):
        calls.append([a.device.type for a in args if isinstance(a, torch.Tensor)])
        return result

    monkeypatch.setattr(module, name, stand_in)
    return calls


def test_spectrum_values_dispatches_a_device_tensor_to_the_remap_entry(monkeypatch):
    """Off the CPU the magnitude modes' values come from kernel A's wrapper
    and then kernel B's remap entry, never from ``_remap_mag`` (checked on
    the meta device, which needs no GPU, with the wrappers replaced by
    recorders)."""
    from signalizer_tpu_torch.kernels import spectrum as ts

    tc = make_spectrum_constant(axis_points=64, window_size=256, device=CPU)
    mags = torch.empty((1, 1, 129), device="meta")
    out = torch.empty((1, 1, 64), device="meta")
    stage1 = _recording(monkeypatch, ts, "window_fft_mag", mags)
    remap = _recording(monkeypatch, ts, "display_remap", out)
    monkeypatch.setattr(ts, "_remap_mag", lambda *a: pytest.fail("the plain remap ran"))
    assert spectrum_values(tc, torch.empty((1, 2, 256), device="meta")) is out
    assert stage1 == [["meta"]] and remap == [["meta"]]


def test_post_process_dispatches_a_device_tensor_to_the_decay_db_entry(monkeypatch):
    """Off the CPU the magnitude modes' decay and dB map go to kernel B's
    decay-and-dB entry with the state it updates in place, never to
    ``decay_db``; the wrappers themselves refuse a device that is neither
    the CPU nor CUDA."""
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import spectrum as ts

    tc = make_spectrum_constant(axis_points=64, window_size=256, device=CPU)
    vals = torch.empty((1, 1, 1, 64), device="meta")
    state = ts.LineGraphState(torch.empty((1, 2, 1, 64), device="meta"), torch.empty((1, 2, 64), device="meta"))
    out = torch.empty((1, 1, 2, 1, 64), device="meta")
    calls = _recording(monkeypatch, ts, "display_decay_db", out)
    monkeypatch.setattr(ts, "decay_db", lambda *a, **k: pytest.fail("the plain decay ran"))
    got = post_process(tc, state, vals)
    assert got.results is out and got.state is state and calls == [["meta", "meta"]]
    with pytest.raises(ValueError, match="unsupported device"):
        dm.display_decay_db(tc, state.magnitude, vals)
    with pytest.raises(ValueError, match="unsupported device"):
        dm.display_remap(tc, torch.empty((1, 1, 129), device="meta"))
    assert (counter("display_map.remap_launches"), counter("display_map.decay_db_launches")) == (0, 0)


@pytest.mark.parametrize("name", list(GOLDEN_CASES))
def test_goldens_reproduced(name):
    """The JAX package's spectrum goldens, at test_golden.py's tolerance
    (rtol 1e-4, atol 1e-5); PHASE's cancellation row in linear units at
    atol 2e-3 (see _undb)."""
    tc = make_spectrum_constant(sample_rate=FS, device=CPU, **GOLDEN_CASES[name])
    frames = torch.from_numpy(golden_input(tc.window_size))
    got = analyze_frames(tc, init_line_graph_state(tc, (1,)), frames).results.numpy()[0, 0, 0]
    want = np.load(GOLDEN_DIR / f"{name}.npz")["results"]
    if tc.configuration == SpectrumChannels.PHASE:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_undb(tc, got[1]), _undb(tc, want[1]), atol=2e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _seps(**kw):
    kw.setdefault("axis_points", 64)
    kw.setdefault("window_size", 256)
    kw.setdefault("configuration", SpectrumChannels.SEPARATE)
    kw.setdefault("view_scaling", ViewScaling.LOGARITHMIC)
    return make_spectrum_constant(sample_rate=FS, device=CPU, **kw)


@pytest.mark.parametrize("mode", [SpectrumChannels.SEPARATE, SpectrumChannels.PHASE], ids=lambda m: m.name)
def test_valid_masking_leaves_state_untouched(mode):
    """Invalid (padded) frames leave every filter state as it was: the
    state after [f0, pad, f1, pad] equals the state after [f0, f1], and the
    valid frames' results agree (exactly: the same operations)."""
    tc = _seps(configuration=mode)
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((2, 4, 2, 256)).astype(np.float32)
    valid = np.array([True, False, True, False])
    s_masked = init_line_graph_state(tc, (2,))
    masked = analyze_frames(tc, s_masked, torch.from_numpy(frames), valid=valid).results
    s_plain = init_line_graph_state(tc, (2,))
    plain = analyze_frames(tc, s_plain, torch.from_numpy(frames[:, valid])).results
    assert torch.equal(masked[:, valid], plain)
    assert torch.equal(s_masked.magnitude, s_plain.magnitude)
    assert torch.equal(s_masked.phase, s_plain.phase)
    # a padded frame repeats the previous frame's display
    assert torch.equal(masked[:, 1], masked[:, 0])


def test_chained_calls_equal_one_call():
    """Three calls of T=4 carry the decay state exactly like one of T=12
    (atol 1e-7: torch.fft may batch rows differently per call size)."""
    tc = _seps(bin_interpolation=BinInterpolation.LANCZOS)
    frames = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 12, 2, 256)).astype(np.float32))
    one_state = init_line_graph_state(tc, (2,))
    one = analyze_frames(tc, one_state, frames).results
    state = init_line_graph_state(tc, (2,))
    chained = torch.cat([analyze_frames(tc, state, frames[:, i : i + 4]).results for i in (0, 4, 8)], dim=1)
    torch.testing.assert_close(chained, one, rtol=0, atol=1e-7)
    torch.testing.assert_close(state.magnitude, one_state.magnitude, rtol=0, atol=1e-7)


def test_stitch_preliminary_bit_equal_to_framing_after_commit():
    tc = _seps()
    rng = np.random.default_rng(9)
    stream = torch.from_numpy(rng.standard_normal((2, 2, 1000)).astype(np.float32))
    history, block = stream[..., :900], stream[..., 900:]
    for num in (None, 60, 100):
        n = 100 if num is None else num
        committed = torch.cat([history, block[..., :n]], dim=-1)[..., -256:]
        got = stitch_preliminary(tc, history, block, num)
        assert torch.equal(got, committed)
        s1, s2 = init_line_graph_state(tc, (2,)), init_line_graph_state(tc, (2,))
        assert torch.equal(
            analyze_frames(tc, s1, got[:, None]).results,
            analyze_frames(tc, s2, committed[:, None]).results,
        )
    with pytest.raises(ValueError):
        stitch_preliminary(tc, history[..., :10], block, 100)


def test_processor_process_reset_reconfigure():
    proc = SpectrumProcessor.create(
        pairs=2, device="cpu", axis_points=64, window_size=256,
        configuration=SpectrumChannels.SEPARATE, view_scaling=ViewScaling.LOGARITHMIC,
    )
    rng = np.random.default_rng(10)
    frames = rng.standard_normal((2, 3, 2, 256)).astype(np.float32)
    out = proc.process(frames)
    assert out.shape == (2, 3, 2, 2, 64) and out.device == CPU
    # one step given as [pairs, 2, W]
    step = proc.process(frames[:, 0])
    assert step.shape == (2, 1, 2, 2, 64)
    # the carried state is the functional result's
    state = init_line_graph_state(proc.constant, (2,))
    analyze_frames(proc.constant, state, torch.from_numpy(np.concatenate([frames, frames[:, :1]], 1)))
    assert torch.equal(proc.state.magnitude, state.magnitude)
    proc.reset()
    assert not proc.state.magnitude.any()
    assert np.array_equal(proc.process_to_host(frames), out.numpy())
    # same shapes keep the state; another axis resets it
    kept = proc.state.magnitude
    proc.reconfigure(_seps(low_dbs=-80.0))
    assert proc.state.magnitude is kept
    proc.reconfigure(_seps(axis_points=32))
    assert proc.state.magnitude.shape == (2, 2, 2, 32) and not proc.state.magnitude.any()
    # process_with_preliminary equals committing first
    hist = rng.standard_normal((2, 2, 300)).astype(np.float32)
    blk = rng.standard_normal((2, 2, 64)).astype(np.float32)
    proc.reset()
    a = proc.process_with_preliminary(hist, blk)
    proc.reset()
    b = proc.process(np.concatenate([hist, blk], -1)[..., -256:][:, None])
    assert torch.equal(a, b)


def test_sine_peak_tracks_frequency():
    """The verify recipe's physical check: a 6 kHz sine peaks at the pixel
    of 6 kHz on a linear axis (within one pixel)."""
    proc = SpectrumProcessor.create(
        pairs=1, device="cpu", axis_points=512, window_size=1024,
        configuration=SpectrumChannels.LEFT, bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LINEAR,
    )
    t = np.arange(1024) / FS
    x = np.sin(2 * np.pi * 6000 * t).astype(np.float32)
    row = proc.process(np.stack([x, 0 * x])[None])[0, 0, 0, 0].numpy()
    assert abs(int(np.argmax(row)) * (FS / 2) / 511 - 6000.0) <= FS / 2 / 511
    assert row.max() > -0.05 / 96.0 * 2  # a full-scale sine reads ~0 dB (display 1.0)
    assert abs(row.max() - 1.0) < 0.05


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_silence_reads_clip_db(mode):
    proc = SpectrumProcessor.create(pairs=2, device="cpu", axis_points=48, window_size=128, configuration=mode)
    out = proc.process(np.zeros((2, 3, 2, 128), np.float32))
    assert torch.isfinite(out).all()
    assert (out == float(proc.constant.clip_db)).all()


def test_create_cuda_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU refusal is not reachable")
    with pytest.raises(RuntimeError, match="cuda"):
        SpectrumProcessor.create(pairs=1, device="cuda", axis_points=32, window_size=128)
