"""The port's multi-device layer (``signalizer_tpu_torch.parallel``) against
the JAX package's, on the CPU: every sharded step builder and
``ShardedAnalysisPipeline`` in every view, on a port mesh of ``["cpu"]`` and
of ``["cpu", "cpu"]`` against the JAX step on a 1- and a 2-device CPU mesh
(tests/conftest.py gives jax 8 host devices), from the same numpy inputs
made from a seed. The cases follow tests/test_parallel.py.

Tolerances are the single-device tests' (none widened): spectrum display
values rtol/atol 1e-5 (tests/test_torch_spectrum.py); oscilloscope waveform
2e-6 x max(1, gain), the colour track 1e-3 and key colours 1e-6, the
SPECTRAL trigger's waveform 1e-4 (tests/test_torch_osc_view.py);
vectorscope vertices 2e-6 x gain and bars 2e-6
(tests/test_torch_vectorscope.py); spectrogram columns within one
8-bit step (the JAX sharded test's own bound for its log-domain blend);
the resonator's display 1e-5 (tests/test_torch_resonator.py); the mix to
1e-5 of the float64 oracle's peak and the resample to 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from signalizer_tpu.core.config import BinInterpolation, OscChannels, SpectrumChannels, ViewScaling
from signalizer_tpu.core.constant import make_spectrum_constant as jconstant
from signalizer_tpu.parallel import mesh as jm
from signalizer_tpu.parallel import pipeline as jp
from signalizer_tpu_torch.core.constant import make_spectrum_constant as tconstant
from signalizer_tpu_torch.parallel import mesh as tm
from signalizer_tpu_torch.parallel import pipeline as tp

PAIRS = 4
FS = 48_000.0


@pytest.fixture(params=[1, 2], ids=["one_device", "two_devices"])
def n(request):
    return request.param


def _meshes(n):
    return jm.make_analysis_mesh(n), ["cpu"] * n


def _whole(v):
    """A port value in the mesh's sharded form as one CPU tensor (or tuple)."""
    if isinstance(v, list):
        if isinstance(v[0], torch.Tensor):
            return torch.cat(v)
        return type(v[0])(*(_whole(list(parts)) for parts in zip(*v)))
    return v


def _np(v):
    return _whole(v).numpy() if isinstance(_whole(v), torch.Tensor) else np.asarray(v)


def _frames(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _spec_kw(**over):
    kw = dict(axis_points=64, window_size=256, configuration=SpectrumChannels.SEPARATE,
              bin_interpolation=BinInterpolation.LINEAR, view_scaling=ViewScaling.LOGARITHMIC)
    kw.update(over)
    return kw


def _osc_kw(**over):
    from signalizer_tpu_torch.views.oscilloscope import AutoGain, TriggerMode

    kw = dict(channel_mode=OscChannels.SEPARATE, trigger_mode=TriggerMode.ZERO_CROSSING, pixels=128,
              lookahead=512, trigger_threshold=0.1, autogain=AutoGain.PEAK_DECAY, colour_enabled=True)
    kw.update(over)
    return kw


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_make_analysis_mesh_raises_without_cuda_and_fails_fast(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.make_analysis_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(RuntimeError, match="requested 9"):
        tm.make_analysis_mesh(9)
    assert tm.make_analysis_mesh(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert len(tm.make_analysis_mesh()) == 8


def test_shard_batch_one_device_is_the_tensor_two_devices_contiguous_chunks():
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    assert tm.shard_batch(x, ["cpu"]) is x
    parts = tm.shard_batch(x, ["cpu", "cpu"])
    assert len(parts) == 2 and torch.equal(parts[0], x[:2]) and torch.equal(parts[1], x[2:])
    from signalizer_tpu_torch.kernels.vectorscope import init_meter_state

    st = tm.shard_batch(init_meter_state((4,), device="cpu"), ["cpu", "cpu"])
    assert [tuple(s.envelope.shape) for s in st] == [(2, 2), (2, 2)]
    with pytest.raises(ValueError, match="divide"):
        tm.shard_batch(torch.zeros(3, 2), ["cpu", "cpu"])


# ---------------------------------------------------------------------------
# the step builders
# ---------------------------------------------------------------------------


def test_sharded_spectrum_step_matches_jax_with_padded_frames_masked(n):
    from signalizer_tpu.kernels.spectrum import init_line_graph_state as jinit
    from signalizer_tpu_torch.kernels.spectrum import init_line_graph_state as tinit

    jmesh, tmesh = _meshes(n)
    kw = _spec_kw(axis_points=64, window_size=128, view_scaling=ViewScaling.LINEAR)
    jc, tc = jconstant(**kw), tconstant(device="cpu", **kw)
    jstep, tstep = jm.sharded_spectrum_step(jc, jmesh), tm.sharded_spectrum_step(tc, tmesh)
    padded = np.zeros((PAIRS, 4, 2, 128), np.float32)
    padded[:, :2] = _frames((PAIRS, 2, 2, 128), 3)
    valid = np.arange(4) < 2
    js = jm.shard_batch(jinit(jc, (PAIRS,)), jmesh)
    ts = tm.shard_batch(tinit(tc, (PAIRS,)), tmesh)
    for call in range(2):
        jr, js, jpeak = jstep(js, jm.shard_batch(jnp.asarray(padded), jmesh), jnp.asarray(valid))
        tr, ts, tpeak = tstep(ts, tm.shard_batch(padded, tmesh), valid)
        np.testing.assert_allclose(_np(tr), np.asarray(jr), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_whole(ts).magnitude.numpy(), np.asarray(js.magnitude), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(tpeak), float(jpeak), rtol=1e-5)
    # the padding left the state as the real frames alone leave it
    ts_real = tm.shard_batch(tinit(tc, (PAIRS,)), tmesh)
    for call in range(2):
        _, ts_real, _ = tstep(ts_real, tm.shard_batch(padded[:, :2].copy(), tmesh), None)
    assert torch.equal(_whole(ts_real).magnitude, _whole(ts).magnitude)
    assert float(tm.global_peak_level(tr)) == float(tpeak)


def test_sharded_mix_step_matches_jax_and_the_oracle(n):
    jmesh, tmesh = _meshes(n)
    sources, in_ch, out_ch, t = 8, 2, 16, 256
    src = _frames((sources, in_ch, t), 3)
    routing = np.zeros((sources, in_ch, out_ch), np.float32)
    for s in range(sources):
        for c in range(in_ch):
            routing[s, c, (2 * s + c) % out_ch] = 0.5 + 0.5 * (s % 3 == 0)
    jmixed, jpeak = jm.sharded_mix_step(jmesh)(jm.shard_batch(src, jmesh), jm.shard_batch(routing, jmesh))
    tmixed, tpeak = tm.sharded_mix_step(tmesh)(tm.shard_batch(src, tmesh), tm.shard_batch(routing, tmesh))
    oracle = np.einsum("sct,sco->ot", src.astype(np.float64), routing.astype(np.float64))
    scale = np.abs(oracle).max()
    assert tuple(tmixed.shape) == (out_ch, t)
    np.testing.assert_allclose(tmixed.numpy(), oracle, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(tmixed.numpy(), np.asarray(jmixed), atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(float(tpeak), float(jpeak), rtol=1e-6)


def test_mix_step_enforces_max_channels(n):
    _, tmesh = _meshes(n)
    step = tm.sharded_mix_step(tmesh, max_channels=4)
    with pytest.raises(ValueError, match="max_channels"):
        step(tm.shard_batch(torch.zeros(8, 2, 64), tmesh), tm.shard_batch(torch.zeros(8, 2, 8), tmesh))


def _check_osc_frame(tf, jf, wave_atol=2e-6, colour_atol=1e-3):
    tf = _whole(tf)
    gain = np.asarray(jf.gain)
    np.testing.assert_allclose(_np(tf.gain), gain, rtol=2e-6)
    scale = np.maximum(1.0, np.abs(gain))[:, None, None]
    for name in ("waveform", "envelope_min", "envelope_max"):
        got, want = _np(getattr(tf, name)), np.asarray(getattr(jf, name))
        assert np.all(np.abs(got - want) <= wave_atol * scale), (name, float(np.abs(got - want).max()))
    np.testing.assert_allclose(_np(tf.colours), np.asarray(jf.colours), atol=colour_atol, rtol=0)
    np.testing.assert_array_equal(_np(tf.trigger_found), np.asarray(jf.trigger_found))


def _osc_pair(n, over, pairs_arg=None):
    from signalizer_tpu.views import oscilloscope as jo
    from signalizer_tpu_torch.views import oscilloscope as to

    jmesh, tmesh = _meshes(n)
    jc = jo.make_oscilloscope_constant(**_osc_kw(**over))
    tc = to.make_oscilloscope_constant(device="cpu", **_osc_kw(**over))
    jstep = jm.sharded_oscilloscope_step(jc, jmesh, pairs=pairs_arg)
    tstep = tm.sharded_oscilloscope_step(tc, tmesh, pairs=pairs_arg)
    js = jm.shard_batch(jo.OscilloscopeProcessor(jc, pairs=PAIRS)._state, jmesh)
    ts = tm.shard_batch(to.init_oscilloscope_state(tc, PAIRS), tmesh)
    return (jmesh, jstep, js), (tmesh, tstep, ts)


def test_sharded_oscilloscope_step_matches_jax(n):
    (jmesh, jstep, js), (tmesh, tstep, ts) = _osc_pair(n, {})
    h = 2048
    hist = np.sin(2 * np.pi * 440.0 * np.arange(h) / FS + np.arange(PAIRS)[:, None, None] * 0.3).astype(
        np.float32) * np.ones((PAIRS, 2, h), np.float32)
    f32 = jnp.float32
    for call in range(2):
        jf, js, jlevel = jstep(js, jm.shard_batch(jnp.asarray(hist), jmesh), f32(500.0), f32(0.0), f32(h))
        tf, ts, tlevel = tstep(ts, tm.shard_batch(hist, tmesh), 500.0, 0.0, float(h))
        _check_osc_frame(tf, jf)
        np.testing.assert_allclose(_whole(ts).peak_env.numpy(), np.asarray(js.peak_env), rtol=2e-6)
        assert float(tlevel) == float(jlevel) == float(np.abs(hist).max())


def test_sharded_oscilloscope_spectral_custom_trigger_matches_jax(n):
    from signalizer_tpu_torch.views.oscilloscope import TriggerMode

    over = dict(channel_mode=OscChannels.LEFT, trigger_mode=TriggerMode.SPECTRAL, lookahead=1024,
                custom_trigger=True, custom_trigger_frequency=441.3, autogain=0, colour_enabled=False)
    (jmesh, jstep, js), (tmesh, tstep, ts) = _osc_pair(n, over)
    h = 4096
    hist = np.sin(2 * np.pi * 441.3 * np.arange(h) / FS + (np.arange(PAIRS) * 0.37)[:, None, None]).astype(
        np.float32) * np.ones((PAIRS, 2, h), np.float32)
    f32 = jnp.float32
    jf, _, _ = jstep(js, jm.shard_batch(jnp.asarray(hist), jmesh), f32(500.0), f32(0.0), f32(h))
    tf, _, _ = tstep(ts, tm.shard_batch(hist, tmesh), 500.0, 0.0, float(h))
    _check_osc_frame(tf, jf, wave_atol=1e-4)
    np.testing.assert_allclose(_np(_whole(tf).fundamental), 441.3, rtol=1e-6)


def test_multipair_hue_rotation_matches_jax(n):
    from signalizer_tpu_torch.views.oscilloscope import TriggerMode

    over = dict(trigger_mode=TriggerMode.NONE, pixels=64, lookahead=128, key_colour=(0.2, 0.9, 0.3),
                secondary_colour=(0.9, 0.2, 0.3), colour_enabled=False, autogain=0)
    (jmesh, jstep, js), (tmesh, tstep, ts) = _osc_pair(n, over, pairs_arg=PAIRS)
    hist = _frames((PAIRS, 2, 256), 0)
    f32 = jnp.float32
    jf, _, _ = jstep(js, jm.shard_batch(jnp.asarray(hist), jmesh), f32(128.0), f32(0.0), f32(256.0))
    tf, _, _ = tstep(ts, tm.shard_batch(hist, tmesh), 128.0, 0.0, 256.0)
    cols = _np(_whole(tf).colours)
    np.testing.assert_allclose(cols, np.asarray(jf.colours), atol=1e-6, rtol=0)
    assert len({tuple(np.round(cols[p, 0, 0], 4)) for p in range(PAIRS)}) == PAIRS
    with pytest.raises(ValueError, match="per-shard history rows"):
        tstep(tm.shard_batch(ts, tmesh) if n == 1 else ts, tm.shard_batch(np.concatenate([hist, hist]), tmesh),
              128.0, 0.0, 256.0)


def test_sharded_vectorscope_step_matches_jax(n):
    from signalizer_tpu.kernels.vectorscope import init_meter_state as jinit
    from signalizer_tpu.views.vectorscope import AutoGain, OperationalMode
    from signalizer_tpu_torch.kernels.vectorscope import init_meter_state as tinit

    jmesh, tmesh = _meshes(n)
    kw = dict(mode=OperationalMode.LISSAJOUS, autogain=AutoGain.PEAK_DECAY, rotation=0.0, scale_to_fill=False)
    jstep, tstep = jm.sharded_vectorscope_step(jmesh, **kw), tm.sharded_vectorscope_step(tmesh, **kw)
    frames = _frames((PAIRS, 2, 256), 1)
    ep, sp, pc = 0.999, 0.99, float(np.float32(0.999) ** np.float32(256 / 60.0))
    js, jpk = jm.shard_batch(jinit((PAIRS,)), jmesh), jm.shard_batch(jnp.zeros((PAIRS, 2), jnp.float32), jmesh)
    ts, tpk = tm.shard_batch(tinit((PAIRS,), device="cpu"), tmesh), tm.shard_batch(torch.zeros(PAIRS, 2), tmesh)
    f32 = jnp.float32
    for call in range(2):
        jf, js, jpk, jlevel = jstep(js, jpk, jm.shard_batch(jnp.asarray(frames), jmesh), f32(ep), f32(sp),
                                   f32(1.0), f32(pc), f32(100.0))
        tf, ts, tpk, tlevel = tstep(ts, tpk, tm.shard_batch(frames, tmesh), ep, sp, 1.0, pc, 100.0)
        tf = _whole(tf)
        scale = max(1.0, float(np.abs(np.asarray(jf.gain)).max()))
        np.testing.assert_allclose(_np(tf.vertices), np.asarray(jf.vertices), atol=2e-6 * scale, rtol=0)
        for name in ("balance", "correlation_bars"):
            np.testing.assert_allclose(_np(getattr(tf, name)), np.asarray(getattr(jf, name)), atol=2e-6, rtol=0)
        np.testing.assert_allclose(_np(tpk), np.asarray(jpk), rtol=1e-6)
        assert float(tlevel) == float(jlevel)


def test_sharded_spectrogram_step_matches_jax(n):
    from signalizer_tpu.kernels.colormap import normalize_ratios
    from signalizer_tpu.kernels.spectrum import init_line_graph_state as jinit
    from signalizer_tpu.views.spectrogram import DEFAULT_GRADIENT, DEFAULT_RATIOS
    from signalizer_tpu_torch.kernels.spectrum import init_line_graph_state as tinit

    jmesh, tmesh = _meshes(n)
    kw = _spec_kw(configuration=SpectrumChannels.LEFT)
    jc, tc = jconstant(**kw), tconstant(device="cpu", **kw)
    t = 3
    frames = _frames((PAIRS, t, 2, 256), 2) * 0.5
    colours = np.broadcast_to(DEFAULT_GRADIENT, (PAIRS, 6, 3)).copy()
    ratios = normalize_ratios(DEFAULT_RATIOS)
    jcols, js = jm.sharded_spectrogram_step(jc, jmesh)(
        jm.shard_batch(jinit(jc, (PAIRS,)), jmesh), jm.shard_batch(jnp.asarray(frames), jmesh),
        jm.shard_batch(jnp.asarray(colours), jmesh), jnp.asarray(ratios, jnp.float32), jnp.ones((t,), bool))
    tcols, ts = tm.sharded_spectrogram_step(tc, tmesh)(
        tm.shard_batch(tinit(tc, (PAIRS,)), tmesh), tm.shard_batch(frames, tmesh),
        tm.shard_batch(colours, tmesh), torch.tensor(ratios, dtype=torch.float32), np.ones(t, bool))
    assert tcols.shape == (t, 64, 4) and tcols.dtype == torch.uint8
    assert np.abs(tcols.numpy().astype(int) - np.asarray(jcols).astype(int)).max() <= 1
    np.testing.assert_allclose(_whole(ts).magnitude.numpy(), np.asarray(js.magnitude), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_sharded_fused_step_matches_jax(n, padded):
    from signalizer_tpu.kernels.oscilloscope import sinc_resample_matrix as jmatrix
    from signalizer_tpu.kernels.spectrum import init_line_graph_state as jinit
    from signalizer_tpu.kernels.vectorscope import init_meter_state as jminit
    from signalizer_tpu_torch.kernels.oscilloscope import sinc_resample_matrix as tmatrix
    from signalizer_tpu_torch.kernels.spectrum import init_line_graph_state as tinit
    from signalizer_tpu_torch.kernels.vectorscope import init_meter_state as tminit

    jmesh, tmesh = _meshes(n)
    kw = _spec_kw()
    jc, tc = jconstant(**kw), tconstant(device="cpu", **kw)
    pixels, t = 32, 3
    frames = _frames((PAIRS, t, 2, 256), 3)
    valid = np.arange(t) < (2 if padded else t)
    if padded:
        frames[:, 2] = 0.0
    jstep = jm.sharded_fused_step(jc, jmatrix(256, 0.0, 256.0 / pixels, pixels), jmesh, pixels=pixels)
    tstep = tm.sharded_fused_step(tc, tmatrix(256, 0.0, 256.0 / pixels, pixels, device="cpu"), tmesh,
                                  pixels=pixels)
    js, jv = jm.shard_batch(jinit(jc, (PAIRS,)), jmesh), jm.shard_batch(jminit((PAIRS,)), jmesh)
    ts, tv = tm.shard_batch(tinit(tc, (PAIRS,)), tmesh), tm.shard_batch(tminit((PAIRS,), device="cpu"), tmesh)
    jout = jstep(js, jv, jm.shard_batch(jnp.asarray(frames), jmesh), jnp.asarray(valid))
    tout = tstep(ts, tv, tm.shard_batch(frames, tmesh), torch.from_numpy(valid) if padded else valid)
    np.testing.assert_allclose(_np(tout[0]), np.asarray(jout[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tout[1]), np.asarray(jout[1]), atol=1e-5, rtol=0)
    for k in (2, 3):  # min-max envelopes: exact
        np.testing.assert_array_equal(_np(tout[k]), np.asarray(jout[k]))
    np.testing.assert_allclose(_np(tout[4]), np.asarray(jout[4]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_whole(tout[5]).magnitude.numpy(), np.asarray(jout[5].magnitude), rtol=1e-5, atol=1e-5)
    for a, b in zip(_whole(tout[6]), jout[6]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    if padded:  # the newest frame is a pad: the meters hold
        for a, b in zip(_whole(tout[6]), tminit((PAIRS,), device="cpu")):
            assert torch.equal(a, b)
    np.testing.assert_allclose(float(tout[7]), float(jout[7]), rtol=1e-5)


def test_sharded_resonator_step_matches_jax(n):
    from signalizer_tpu.core.config import TransformAlgorithm
    from signalizer_tpu.views.spectrum import ResonatorSpectrumProcessor as JRes
    from signalizer_tpu_torch.views.spectrum import ResonatorSpectrumProcessor as TRes

    jmesh, tmesh = _meshes(n)
    kw = dict(axis_points=64, window_size=1024, configuration=SpectrumChannels.SEPARATE,
              algo=TransformAlgorithm.RESONATOR)
    jproc, tproc = JRes(jconstant(**kw), pairs=PAIRS), TRes(tconstant(device="cpu", **kw), pairs=PAIRS)
    t, w = 4, 512
    valid = np.array([True, True, True, False])
    jstep = jm.sharded_resonator_step(jproc.constant, jproc.resonator, jproc.block_plan(w), jmesh)
    tstep = tm.sharded_resonator_step(tproc.constant, tproc.resonator, tproc.block_plan(w), tmesh)
    jr, jg = jm.shard_batch(jproc.res_state, jmesh), jm.shard_batch(jproc.graph_state, jmesh)
    tr, tg = tm.shard_batch(tproc.res_state, tmesh), tm.shard_batch(tproc.graph_state, tmesh)
    for call in range(2):
        blocks = _frames((PAIRS, 2, t, w), 5 + call)
        jout, jr, jg, jpeak = jstep(jr, jg, jm.shard_batch(jnp.asarray(blocks), jmesh), jnp.asarray(valid))
        tout, tr, tg, tpeak = tstep(tr, tg, tm.shard_batch(blocks, tmesh), valid)
        np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=1e-5, atol=1e-5)
        bank = np.asarray(jr)
        assert np.abs(_np(tr) - bank).max() <= 1e-6 * np.abs(bank).max()
        np.testing.assert_allclose(float(tpeak), float(jpeak), rtol=1e-5)


def test_init_sharded_state_shapes(n):
    _, tmesh = _meshes(n)
    tc = tconstant(device="cpu", **_spec_kw())
    st = _whole(tm.init_sharded_state(tc, PAIRS, tmesh))
    assert tuple(st.magnitude.shape) == (PAIRS, tc.num_line_graphs, tc.state_channels, 64)
    assert not bool(st.magnitude.any())


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _pipes(n, view, **kw):
    jmesh, tmesh = _meshes(n)
    spec = _spec_kw(axis_points=128, window_size=512, view_scaling=ViewScaling.LINEAR)
    if view == "oscilloscope":
        from signalizer_tpu.views.oscilloscope import make_oscilloscope_constant as jmake
        from signalizer_tpu_torch.views.oscilloscope import TriggerMode
        from signalizer_tpu_torch.views.oscilloscope import make_oscilloscope_constant as tmake

        okw = dict(channel_mode=OscChannels.SEPARATE, trigger_mode=kw.pop("trigger", TriggerMode.ZERO_CROSSING),
                   pixels=64, lookahead=256, trigger_threshold=0.1)
        kw.update(window_samples=128.0, history_samples=1024)
        jkw, tkw = dict(kw, osc_constant=jmake(**okw)), dict(kw, osc_constant=tmake(device="cpu", **okw))
    else:
        if view == "vectorscope":
            kw.update(history_samples=1024)
        jkw, tkw = dict(kw), dict(kw)
    framed = view in tp.FRAMED_VIEWS
    jpipe = jp.ShardedAnalysisPipeline(jconstant(**spec) if framed else None, pairs=PAIRS, mesh=jmesh,
                                       view=view, frames_per_tick=2, pixels=64, **jkw)
    tpipe = tp.ShardedAnalysisPipeline(tconstant(device="cpu", **spec) if framed else None, pairs=PAIRS,
                                       mesh=tmesh, view=view, frames_per_tick=2, pixels=64, **tkw)
    return jpipe, tpipe


@pytest.mark.parametrize("view", ["fused", "spectrum", "spectrogram", "oscilloscope", "vectorscope"])
def test_pipeline_every_view_matches_jax(n, view):
    """Three ticks of the same pushes: None before any audio, then every
    output at the step's tolerance; the state stays sharded across ticks."""
    jpipe, tpipe = _pipes(n, view)
    assert jpipe.tick() is None and tpipe.tick() is None
    rng = np.random.default_rng(17)
    for tick in range(3):
        block = (rng.standard_normal((PAIRS * 2, 1024)) * 0.5).astype(np.float32)
        jpipe.push(block)
        tpipe.push(block)
        jout, tout = jpipe.tick(), tpipe.tick()
        assert type(tout).__name__ == type(jout).__name__ and tpipe.ticks == tick + 1
        if view == "fused":
            np.testing.assert_allclose(_np(tout.results), np.asarray(jout.results), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(_np(tout.waveform), np.asarray(jout.waveform), atol=1e-5, rtol=0)
            np.testing.assert_array_equal(_np(tout.envelope_max), np.asarray(jout.envelope_max))
            np.testing.assert_allclose(_np(tout.correlation), np.asarray(jout.correlation), atol=1e-5, rtol=0)
            np.testing.assert_allclose(float(tout.global_peak), float(jout.global_peak), rtol=1e-5)
        elif view == "spectrum":
            np.testing.assert_allclose(_np(tout.results), np.asarray(jout.results), rtol=1e-5, atol=1e-5)
        elif view == "spectrogram":
            assert np.abs(tout.columns.numpy().astype(int) - np.asarray(jout.columns).astype(int)).max() <= 1
        elif view == "oscilloscope":
            _check_osc_frame(tout.frame, jout.frame)
            assert float(tout.global_level) == float(jout.global_level)
        else:
            frame = _whole(tout.frame)
            np.testing.assert_allclose(_np(frame.vertices), np.asarray(jout.frame.vertices),
                                       atol=2e-6 * max(1.0, float(np.asarray(jout.frame.gain).max())), rtol=0)
            np.testing.assert_allclose(_np(frame.balance), np.asarray(jout.frame.balance), atol=2e-6)
    state = tpipe._state
    assert isinstance(state, list) == (n == 2)
    if view in ("fused", "vectorscope"):
        assert tpipe.meter_state is not None


def test_pipeline_fused_sines_land_on_their_pixels(n):
    """Per-pair sines land on their own spectral peaks; identical channels
    correlate to 1; a second tick of silence decays from the first."""
    _, tmesh = _meshes(n)
    tc = tconstant(device="cpu", axis_points=256, window_size=1024, sample_rate=FS,
                   configuration=SpectrumChannels.SEPARATE, bin_interpolation=BinInterpolation.LINEAR,
                   view_scaling=ViewScaling.LINEAR)
    pipe = tp.ShardedAnalysisPipeline(tc, pairs=PAIRS, mesh=tmesh, pixels=64, frames_per_tick=2)
    t = np.arange(2048) / FS
    block = np.stack([np.sin(2 * np.pi * 1000.0 * (p // 2 + 1) * t) for p in range(PAIRS * 2)]).astype(np.float32)
    pipe.push(block)
    out = pipe.tick()
    res = _np(out.results)
    assert _np(out.waveform).shape == (PAIRS, 2, 64)
    for p in range(PAIRS):
        assert abs(int(np.argmax(res[p, -1, 0, 0])) - (p + 1) * 1000.0 / (FS / 2) * 255) <= 2
    np.testing.assert_allclose(_np(out.correlation)[..., 8:], 1.0, atol=1e-3)
    pipe.push(np.zeros_like(block))
    out2 = pipe.tick()
    assert pipe.ticks == 2 and _np(out2.results)[0, -1, 0, 0].max() <= res[0, -1, 0, 0].max() + 1e-5


def test_pipeline_oscilloscope_transport_position(n):
    """TriggerMode.WINDOW scrolls against the playhead: two transport
    positions draw different windows, each as the JAX pipeline draws it."""
    from signalizer_tpu_torch.views.oscilloscope import TriggerMode

    block = _frames((PAIRS * 2, 2048), 5)
    waves = {}
    for transport in (0.0, 300.0):
        jpipe, tpipe = _pipes(n, "oscilloscope", trigger=TriggerMode.WINDOW)
        jpipe.push(block)
        tpipe.push(block)
        jout, tout = jpipe.tick(transport_position=transport), tpipe.tick(transport_position=transport)
        _check_osc_frame(tout.frame, jout.frame)
        waves[transport] = _np(_whole(tout.frame).waveform)
    assert not np.array_equal(waves[0.0], waves[300.0])


def test_pipeline_refuses_pairs_that_do_not_divide_and_unknown_views():
    tc = tconstant(device="cpu", **_spec_kw())
    with pytest.raises(ValueError, match="must divide over 2 devices"):
        tp.ShardedAnalysisPipeline(tc, pairs=3, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="unknown view"):
        tp.ShardedAnalysisPipeline(tc, pairs=2, mesh=["cpu"], view="nope")
    with pytest.raises(ValueError, match="needs a SpectrumConstant"):
        tp.ShardedAnalysisPipeline(None, pairs=2, mesh=["cpu"], view="spectrum")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.ShardedAnalysisPipeline(tc, pairs=2)


def test_pipeline_padded_short_batch_is_masked(n):
    """A pull short of frames_per_tick (frames dropped under backpressure)
    is zero-padded and masked: the state equals a tick of the real frames
    alone."""
    _, tmesh = _meshes(n)
    tc = tconstant(device="cpu", **_spec_kw(axis_points=64, window_size=128))
    a = tp.ShardedAnalysisPipeline(tc, pairs=PAIRS, mesh=tmesh, view="spectrum", frames_per_tick=4)
    b = tp.ShardedAnalysisPipeline(tc, pairs=PAIRS, mesh=tmesh, view="spectrum", frames_per_tick=2)
    block = _frames((PAIRS * 2, 256), 9)
    a.push(block)
    b.push(block)
    frames = a.batcher.pull(4)  # two frames ready
    assert frames.shape[0] == 2
    a.batcher._next_frame -= 2
    a.batcher.frames_ready = lambda: 4  # a short batch under backpressure
    staged, valid = a._pull_framed()
    assert valid.tolist() == [True, True, False, False]
    _, state_a, _ = a._step(a._state, staged, valid)
    out_b = b.tick()
    assert torch.equal(_whole(state_a).magnitude, _whole(b._state).magnitude)
    assert out_b is not None
