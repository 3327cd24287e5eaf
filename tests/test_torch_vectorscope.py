"""The PyTorch port's vectorscope functions and VectorscopeProcessor against
the JAX package on the CPU. Inputs are made with numpy from a seed and
handed to both. Tolerances: vertices, bars and gains 2e-6 absolute (scaled
by the gain where a vertex carries it), states 1e-6 relative: the same
float32 operations, with the power ramp's ``pow`` and the trigonometric
functions rounded differently by the two libraries in the last place."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.kernels import vectorscope as jk
from signalizer_tpu.views import vectorscope as jv
from signalizer_tpu_torch import OperationalMode, VectorscopeAutoGain, VectorscopeProcessor
from signalizer_tpu_torch.kernels import vectorscope as tk
from signalizer_tpu_torch.views import vectorscope as tv

CPU = torch.device("cpu")
W = 512


def degenerate_frames(rng, pairs=8, w=W):
    """[pairs, 2, w]: noise, hard-left, hard-right, mono, inverted stereo,
    silence, a pair with exact zeros sprinkled in both channels and one
    whose left is zero where the right is not (x == 0, y != 0 cases)."""
    x = (rng.standard_normal((pairs, 2, w)) * 0.3).astype(np.float32)
    x[1, 1] = 0.0  # hard left: right exactly silent
    x[2, 0] = 0.0  # hard right
    x[3, 1] = x[3, 0]  # mono
    x[4, 1] = -x[4, 0]  # inverted
    x[5] = 0.0  # silence
    x[6, :, ::3] = 0.0  # both zero on every third sample
    x[7, 1, ::2] = -x[7, 0, ::2]  # L + R == 0 with L - R != 0 on even samples
    return x


def jstate(env, bal, ph, gain):
    return jk.VectorscopeMeterState(*(jnp.asarray(a) for a in (env, bal, ph, gain)))


def random_state(rng, pairs):
    return (
        (rng.random((pairs, 2)) * 0.05).astype(np.float32),
        (rng.random((pairs, 2, 2)) * 0.05).astype(np.float32),
        (rng.random((pairs, 2)) * 2 - 1).astype(np.float32),
        (rng.random(pairs) * 3 + 0.5).astype(np.float32),
    )


def assert_state_close(got, want):
    """1e-6 relative; the phase filter sums correlations of both signs in
    [-1, 1], so a state near zero is held to 1e-7 absolute, an ulp of the
    terms it sums."""
    for name, g, w in zip(got._fields, got, want):
        atol = 1e-7 if name == "phase" else 1e-9
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=atol, err_msg=name)


def test_enums_and_coefficient_equal_the_jax_package():
    assert {m.name: int(m) for m in tv.OperationalMode} == {m.name: int(m) for m in jv.OperationalMode}
    assert {m.name: int(m) for m in tv.AutoGain} == {m.name: int(m) for m in jv.AutoGain}
    for norm, fs in ((0.1, 48000.0), (0.02, 44100.0), (1.0, 96000.0)):
        assert tk.filter_coefficient(norm, fs) == jk.filter_coefficient(norm, fs)
    assert tk.SQRT_HALF == jk.SQRT_HALF


def test_correlation_matches_jax_with_degenerate_samples():
    """2e-6 absolute; exact zeros read 0 (the cosine of twice float32's
    pi/4, -4.4e-8), x == 0 with y != 0 reads -1 (atan of +-inf)."""
    x = degenerate_frames(np.random.default_rng(1))
    got = tk.correlation(torch.from_numpy(x)).numpy()
    want = np.asarray(jk.correlation(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert np.isfinite(got).all()
    assert (np.abs(got[5]) < 1e-7).all() and (np.abs(got[6, ::3]) < 1e-7).all()
    np.testing.assert_allclose(got[3], 1.0, atol=2e-6)  # mono
    np.testing.assert_allclose(got[4], -1.0, atol=2e-6)  # inverted
    np.testing.assert_allclose(got[7, ::2], -1.0, atol=2e-6)


@pytest.mark.parametrize("rotation", [0.0, 0.125, 0.37])
def test_lissajous_vertices_match_jax(rotation):
    x = degenerate_frames(np.random.default_rng(2))
    gain = np.linspace(0.5, 3.0, 8).astype(np.float32)[:, None]
    got = tk.lissajous_vertices(torch.from_numpy(x), rotation=rotation, gain=torch.from_numpy(gain)).numpy()
    want = np.asarray(jk.lissajous_vertices(jnp.asarray(x), rotation=jnp.float32(rotation), gain=jnp.asarray(gain)))
    assert got.shape == want.shape == (8, W, 3)
    np.testing.assert_allclose(got, want, atol=2e-6 * 3.0, rtol=0)
    # the age ramp: the two linspaces differ by an ulp of 1
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=1.2e-7, rtol=0)
    assert got[0, 0, 2] == -1.0 and got[0, -1, 2] == 0.0


@pytest.mark.parametrize("fill", [False, True])
def test_polar_vertices_match_jax(fill):
    x = degenerate_frames(np.random.default_rng(3))
    got = tk.polar_vertices(torch.from_numpy(x), gain=2.0, scale_to_fill=fill).numpy()
    want = np.asarray(jk.polar_vertices(jnp.asarray(x), gain=2.0, scale_to_fill=fill))
    np.testing.assert_allclose(got, want, atol=2e-6 * 2.0, rtol=0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("new_samples", [None, 0.0, 100.0, float(W)])
def test_update_meters_and_readout_match_jax(new_samples):
    rng = np.random.default_rng(4)
    x = degenerate_frames(rng)
    s0 = random_state(rng, 8)
    got = tk.update_meters(
        tk.meter_state_from_arrays(*s0, device=CPU), torch.from_numpy(x),
        envelope_pole=0.999, stereo_pole=0.99, new_samples=new_samples,
    )
    want = jk.update_meters(
        jstate(*s0), jnp.asarray(x), envelope_pole=0.999, stereo_pole=0.99,
        new_samples=None if new_samples is None else jnp.float32(new_samples),
    )
    assert_state_close(got, want)
    bars, jbars = tk.meter_readout(got), jk.meter_readout(want)
    for key in ("balance", "correlation"):
        np.testing.assert_allclose(bars[key].numpy(), np.asarray(jbars[key]), atol=2e-6, rtol=0)


def test_meter_readout_snaps():
    """An exactly-zero ratio snaps to 0.5, a zero left envelope with a
    positive right one reads 1.0, 0/0 reads 0.5: equal to JAX's bit for bit
    apart from atan's last place."""
    bal = np.zeros((5, 2, 2), np.float32)
    bal[0] = [[1.0, 0.0], [0.5, 0.0]]  # right exactly 0: snaps to 0.5
    bal[1] = [[0.0, 1.0], [0.0, 0.3]]  # left 0, right > 0: 1.0
    bal[2] = 0.0  # 0/0: 0.5
    bal[3] = [[1.0, 1.0], [2.0, 2.0]]  # centre
    bal[4] = [[1.0, 1e-30], [1e-30, 1.0]]  # tiny but not zero
    s = (np.zeros((5, 2), np.float32), bal, np.zeros((5, 2), np.float32), np.ones(5, np.float32))
    got = tk.meter_readout(tk.meter_state_from_arrays(*s, device=CPU))["balance"].numpy()
    want = np.asarray(jk.meter_readout(jstate(*s))["balance"])
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert (got[0] == 0.5).all() and (got[1] == 1.0).all() and (got[2] == 0.5).all()
    np.testing.assert_allclose(got[3], 0.5, atol=2e-6)
    assert got[4, 0] < 1e-6 and got[4, 1] > 1 - 1e-6


def test_autogains_hold_the_carried_gain_when_degenerate():
    rng = np.random.default_rng(5)
    x = degenerate_frames(rng)
    s0 = list(random_state(rng, 8))
    s0[0][5] = 0.0  # a zero envelope: 1/0
    s0[0][6] = np.inf
    ts, js = tk.meter_state_from_arrays(*s0, device=CPU), jstate(*s0)
    got, want = tk.rms_autogain(ts).numpy(), np.asarray(jk.rms_autogain(js))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[5] == s0[3][5] and got[6] == s0[3][6]
    penv = (rng.random((8, 2)) * 0.01).astype(np.float32)
    penv[5] = 0.0
    e, g = tk.peak_autogain_update(torch.from_numpy(penv), torch.from_numpy(x), 0.97, fallback=ts.gain)
    je, jg = jk.peak_autogain_update(jnp.asarray(penv), jnp.asarray(x), jnp.float32(0.97), fallback=js.gain)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    assert g[5] == s0[3][5]  # silence holds the gain


def test_apply_transform_matches_jax():
    rng = np.random.default_rng(6)
    v = rng.standard_normal((3, 100, 3)).astype(np.float32)
    m = rng.standard_normal((3, 3)).astype(np.float32)
    tr = rng.standard_normal(3).astype(np.float32)
    got = tk.apply_transform(torch.from_numpy(v), m, tr).numpy()
    want = np.asarray(jk.apply_transform(jnp.asarray(v), m, tr))
    np.testing.assert_allclose(got, want, atol=2e-6 * 4, rtol=0)


@pytest.mark.parametrize("autogain", list(jv.AutoGain), ids=lambda a: a.name)
@pytest.mark.parametrize("mode", list(jv.OperationalMode), ids=lambda m: m.name)
def test_processor_matches_jax_over_a_stream(mode, autogain):
    """Three calls on a seeded stream with the degenerate pairs, from a
    carried-over state: whole windows, then an overlapping window with
    ``new_samples``, then with a shorter ``meter_frames`` whose width clamps
    ``new_samples``. Vertices 2e-6 x gain, bars and gains 2e-6 (relative for
    the gain, which is unbounded), states 1e-6 relative."""
    rng = np.random.default_rng(20 + 3 * int(mode) + int(autogain))
    kw = dict(pairs=8, sample_rate=48000.0, envelope_window=0.02, stereo_window=0.002,
              rotation=0.125, user_gain=1.5, scale_to_fill=True)
    jp = jv.VectorscopeProcessor(mode=jv.OperationalMode(mode), autogain=jv.AutoGain(autogain), **kw)
    tp = VectorscopeProcessor(mode=OperationalMode(mode), autogain=VectorscopeAutoGain(autogain), device="cpu", **kw)
    s0 = random_state(rng, 8)
    penv = (rng.random((8, 2)) * 0.01).astype(np.float32)
    jp._state, jp._peak_env = jstate(*s0), jnp.asarray(penv)
    tp.load_state(tk.meter_state_from_arrays(*s0, device=CPU), penv)
    stream = np.concatenate([degenerate_frames(rng), degenerate_frames(rng)], axis=-1)
    calls = [
        dict(frames=stream[..., :W]),
        dict(frames=stream[..., 200 : 200 + W], new_samples=200),
        dict(frames=stream[..., 400 : 400 + W], new_samples=200, meter_frames=stream[..., 400 + W - 128 : 400 + W]),
    ]
    for call in calls:
        got = tp.process(**call)
        want = jp.process(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in call.items()})
        gain = np.asarray(want.gain)
        assert got.vertices.shape == (8, W, 3) and got.vertices.device == CPU
        np.testing.assert_allclose(got.gain.numpy(), gain, rtol=2e-6)
        np.testing.assert_allclose(
            got.vertices.numpy(), np.asarray(want.vertices), atol=2e-6 * float(max(gain.max(), 1.0)), rtol=2e-6
        )
        np.testing.assert_allclose(got.balance.numpy(), np.asarray(want.balance), atol=2e-6, rtol=0)
        np.testing.assert_allclose(got.correlation_bars.numpy(), np.asarray(want.correlation_bars), atol=2e-6, rtol=0)
        assert torch.isfinite(got.vertices).all()
        assert_state_close(tp.state, jp.state)
        np.testing.assert_allclose(tp.peak_envelope.numpy(), np.asarray(jp._peak_env), rtol=1e-6)


def test_prep_step_scalars_equal_the_jax_processor():
    """The host scalar arithmetic of ``_prep_step`` (poles, the peak decay
    per visible buffer, the clamp of ``new_samples`` to the meter slice)."""
    kw = dict(pairs=1, sample_rate=44100.0, envelope_window=0.3, stereo_window=0.05, rotation=0.2, user_gain=0.7)
    jp, tp = jv.VectorscopeProcessor(**kw), VectorscopeProcessor(device="cpu", **kw)
    for w, ns, mw in ((512, None, None), (512, 100, None), (4096, 5000, None), (4096, 800, 256), (4096, 100, 256)):
        js, jns = jp._prep_step(w, ns, meter_w=mw)
        ts, tns = tp._prep_step(w, ns, meter_w=mw)
        assert [float(v) for v in js] == list(ts)
        assert (jns is None and tns is None) or float(jns) == tns


def test_physical_checks():
    """The verify recipe's checks: balance ~0 / 0.5 / 1 for hard-left /
    centre / hard-right, an exactly silent right snapping hard-left to 0.5,
    correlation 1.0 for mono and 0.0 for inverted stereo, silence giving
    finite vertices and a held gain."""
    n = np.arange(4096)
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * n / 48000.0)).astype(np.float32)
    x = np.zeros((6, 2, 4096), np.float32)
    x[0, 0], x[0, 1] = tone, 1e-4 * tone  # hard left, right merely tiny
    x[1, 0], x[1, 1] = tone, tone  # centre / mono
    x[2, 0], x[2, 1] = 1e-4 * tone, tone  # hard right
    x[3, 0] = tone  # right exactly silent
    x[4, 0], x[4, 1] = tone, -tone  # inverted
    p = VectorscopeProcessor(pairs=6, device="cpu", autogain=VectorscopeAutoGain.RMS, stereo_window=0.002)
    for _ in range(3):
        f = p.process(x)
    bal, corr = f.balance[:, 0].numpy(), f.correlation_bars[:, 0].numpy()
    assert bal[0] < 0.01 and abs(bal[1] - 0.5) < 0.01 and bal[2] > 0.99
    assert bal[3] == 0.5
    assert abs(corr[1] - 1.0) < 0.01 and abs(corr[4]) < 0.01
    assert torch.isfinite(f.vertices).all() and float(f.gain[5]) == 1.0
    assert (f.vertices[5, :, :2] == 0).all()


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU refusal is not reachable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        VectorscopeProcessor(pairs=1)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tk.init_meter_state((1,))
