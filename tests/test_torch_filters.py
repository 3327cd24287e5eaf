"""The PyTorch port's IIR filters against the JAX package and a float64
oracle (scipy's ``lfilter``, whose zi is the same transposed direct form
II state), on the CPU. Inputs are made with numpy from a seed and handed to
both.

The JAX package solves each biquad with an associative scan over f32 2×2
matrix products; the port with a doubling scan whose matrix powers are
squared in float64. Both are float32 solutions of the same recurrence, so
where the two are compared the bound is each one's own distance from the
float64 oracle, measured in the test: the port must be within its stated
bound of the oracle, and within (JAX's oracle error + the port's) of JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from signalizer_tpu.kernels import filters as jf
from signalizer_tpu_torch.kernels import filters as tf

COEFFS = {
    "lp300": lambda fs: jf.butterworth_lowpass(300.0, fs),
    "hp300": lambda fs: jf.butterworth_highpass(300.0, fs),
    "lp3k": lambda fs: jf.butterworth_lowpass(3000.0, fs),
    "hp3k": lambda fs: jf.butterworth_highpass(3000.0, fs),
}


def _signal(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.3).astype(np.float32)


def _lfilter64(c, x, zi):
    """float64 TDF2 oracle over the last axis of x [B, W] from zi [B, 2]."""
    b, a = [c.b0, c.b1, c.b2], [1.0, c.a1, c.a2]
    ys, zs = [], []
    for row, z in zip(x.astype(np.float64), zi.astype(np.float64)):
        y, zf = scipy.signal.lfilter(b, a, row, zi=z)
        ys.append(y)
        zs.append(zf)
    return np.stack(ys), np.stack(zs)


@pytest.mark.parametrize("fs", [48_000.0, 96_000.0])
@pytest.mark.parametrize("fc", [300.0, 3000.0])
def test_butterworth_coefficients_equal_jax(fc, fs):
    assert tf.butterworth_lowpass(fc, fs) == jf.butterworth_lowpass(fc, fs)
    assert tf.butterworth_highpass(fc, fs) == jf.butterworth_highpass(fc, fs)


@pytest.mark.parametrize("fs", [48_000.0, 96_000.0])
@pytest.mark.parametrize("name", list(COEFFS))
def test_biquad_filter_matches_float64_oracle_and_jax(name, fs):
    """4096 samples from a random carried state. Bound against the float64
    oracle: 2e-5 of the output's peak at 48 kHz and 2e-4 at 96 kHz (the
    300 Hz poles sit closer to the unit circle there; measured 6.4e-6 and
    8.1e-5 absolute on peaks of ~0.4-1.3, where JAX's scan measured 2.5e-5
    and 8.0e-4). Final state: the same bound."""
    c = COEFFS[name](fs)
    x = _signal((3, 4096), seed=int(fs) + len(name))
    zi = _signal((3, 2), seed=7) * 0.3
    want, want_z = _lfilter64(c, x, zi)
    y, zf = tf.biquad_filter(c, torch.from_numpy(x), torch.from_numpy(zi))
    jy, jz = jf.biquad_filter(c, jnp.asarray(x), jnp.asarray(zi))
    bound = (2e-5 if fs == 48_000.0 else 2e-4) * float(np.abs(want).max())
    port_err = float(np.abs(y.numpy() - want).max())
    jax_err = float(np.abs(np.asarray(jy) - want).max())
    assert port_err <= bound, port_err
    np.testing.assert_allclose(zf.numpy(), want_z, atol=bound)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=jax_err + port_err + 1e-7)
    np.testing.assert_allclose(zf.numpy(), np.asarray(jz), rtol=0, atol=jax_err + port_err + 1e-7)


def test_biquad_filter_defaults_to_a_zero_state():
    c = jf.butterworth_lowpass(300.0, 48_000.0)
    x = _signal((2, 512), seed=1)
    y0, _ = tf.biquad_filter(c, torch.from_numpy(x))
    y1, _ = tf.biquad_filter(c, torch.from_numpy(x), torch.zeros(2, 2))
    assert torch.equal(y0, y1)


def _three_band64(x, fs, z):
    """The LR4 network of three_band_split in float64 (scipy, per section)."""
    lp_lo = jf.butterworth_lowpass(300.0, fs)
    hp_lo = jf.butterworth_highpass(300.0, fs)
    lp_hi = jf.butterworth_lowpass(3000.0, fs)
    hp_hi = jf.butterworth_highpass(3000.0, fs)
    low1, _ = _lfilter64(lp_lo, x, z[:, 0])
    low, _ = _lfilter64(lp_lo, low1, z[:, 1])
    rest1, _ = _lfilter64(hp_lo, x, z[:, 2])
    rest, _ = _lfilter64(hp_lo, rest1, z[:, 3])
    mid1, _ = _lfilter64(lp_hi, rest, z[:, 4])
    mid, _ = _lfilter64(lp_hi, mid1, z[:, 5])
    high1, _ = _lfilter64(hp_hi, rest, z[:, 6])
    high, _ = _lfilter64(hp_hi, high1, z[:, 7])
    return np.stack([low, mid, high], axis=1)


@pytest.mark.parametrize("fs", [48_000.0, 96_000.0])
def test_three_band_split_matches_float64_oracle_and_jax(fs):
    """[pairs=2, rows=2, 4096] from a carried crossover state, two blocks in
    a row. Bands within 1e-4 (48 kHz) / 1e-3 (96 kHz) of their peak of the
    float64 network (four biquads in cascade; measured 1.1e-5 and 1.5e-4
    relative), and within JAX's own oracle error plus the port's of JAX."""
    x = _signal((2, 2, 2, 4096), seed=int(fs) // 1000)
    z0 = _signal((2, 2, 8, 2), seed=3) * 0.05
    state = tf.CrossoverState(torch.from_numpy(z0))
    jstate = jf.CrossoverState(jnp.asarray(z0))
    for block in range(2):
        xb = x[:, :, block]
        bands, state = tf.three_band_split(torch.from_numpy(xb), fs, state=state)
        jbands, jstate = jf.three_band_split(jnp.asarray(xb), fs, state=jstate)
        assert bands.shape == (2, 2, 3, 4096) and state.z.shape == (2, 2, 8, 2)
        if block == 0:
            want = _three_band64(xb.reshape(4, 4096), fs, z0.reshape(4, 8, 2)).reshape(2, 2, 3, 4096)
            rel = 1e-4 if fs == 48_000.0 else 1e-3
            port_err = float(np.abs(bands.numpy() - want).max())
            jax_err = float(np.abs(np.asarray(jbands) - want).max())
            assert port_err <= rel * float(np.abs(want).max()), port_err
            tol = port_err + jax_err + 1e-7
        np.testing.assert_allclose(bands.numpy(), np.asarray(jbands), rtol=0, atol=2 * tol)
        np.testing.assert_allclose(state.z.numpy(), np.asarray(jstate.z), rtol=0, atol=2 * tol)


def test_init_crossover_state_shape_and_device():
    s = tf.init_crossover_state((3, 2), device="cpu")
    assert s.z.shape == (3, 2, 8, 2) and s.z.dtype == torch.float32
    assert not s.z.any()
    assert tf.init_crossover_state(device="cpu").z.shape == (8, 2)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("pole", [0.5, 0.99, 0.99979])
def test_onepole_smooth_matches_jax_and_a_sequential_loop(pole, with_state):
    """Against JAX's associative scan and a float64 per-sample loop. Both
    scans form the pole's powers as f32 products, whose relative error
    grows with the power: at the 0.99979 pole (a ~50 ms smoother at 96 kHz)
    each scan measured 1.4e-5 relative off the loop, so the bound is rtol
    3e-5; 1e-5 for the other poles."""
    x = np.abs(_signal((2, 3, 2048), seed=int(pole * 1000)))
    s0 = np.abs(_signal((2, 3), seed=5)) if with_state else None
    got = tf.onepole_smooth(
        torch.from_numpy(x), torch.tensor(pole), None if s0 is None else torch.from_numpy(s0)
    ).numpy()
    want = np.asarray(jf.onepole_smooth(jnp.asarray(x), jnp.float32(pole), None if s0 is None else jnp.asarray(s0)))
    rtol = 3e-5 if pole > 0.999 else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)
    p = float(np.float32(pole))
    s = np.zeros(x.shape[:-1]) if s0 is None else s0.astype(np.float64)
    seq = np.empty(x.shape)
    for n in range(x.shape[-1]):
        s = x[..., n] + p * (s - x[..., n])
        seq[..., n] = s
    np.testing.assert_allclose(got, seq, rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("new_samples", [None, 0, 1, 300, 1024])
def test_onepole_block_update_matches_jax(new_samples):
    x = np.abs(_signal((2, 1024), seed=9))
    state = np.abs(_signal((2,), seed=10))
    got = tf.onepole_block_update(torch.from_numpy(state), torch.from_numpy(x), 0.995, new_samples)
    want = jf.onepole_block_update(jnp.asarray(state), jnp.asarray(x), 0.995, new_samples)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    if new_samples == 0:
        np.testing.assert_allclose(got.numpy(), state, rtol=1e-6)
