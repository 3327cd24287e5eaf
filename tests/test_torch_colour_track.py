"""Kernel E's plain versions (the Oscilloscope's colour track) against the
JAX package and a float64 oracle (``colour_track.float64_reference``: scipy's
``lfilter``), on the CPU; kernel E's host table against its CUDA source. Inputs are made with numpy from a seed and handed to both.

``colour_track_plain`` is ``three_band_split_plain`` then
``spectral_colour_track_plain``; the JAX side is ``three_band_split`` then
``spectral_colour_track``. Three calls carry the crossover and smoothing
states. Bounds, as the port's other tests of these filters state them:

* bands and the crossover state within 1e-4 (48 kHz) / 1e-3 (96 kHz) of the
  float64 network's peak (``tests/test_torch_filters.py``), and within the
  port's oracle error plus JAX's of JAX;
* the smoothing state (band energies through a one-pole) within twice the
  bands' bound of the float64 chain's peak, since it smooths their squares
  (measured 2.7e-5 to 5.4e-5 at 48 kHz, 5.3e-5 to 2.3e-4 at 96 kHz, where
  JAX's sat at 5.3e-5 to 2.7e-4 and 9.0e-4 to 3.4e-3), and within the
  port's error plus JAX's of JAX;
* colours atol 1e-3 of the float64 chain's (``tests/test_torch_osc_view.py``:
  the ratios of smoothed energies amplify the crossover's rounding), and
  within the port's error plus JAX's of JAX (at 96 kHz JAX's colours sit
  up to 2.2e-3 from the port's, measured: its f32 associative scan of the
  300 Hz sections is the less exact of the two);
* a silent row's colours exactly the key colour times (1 - blend).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.kernels import filters as jf
from signalizer_tpu.kernels import oscilloscope as jk
from signalizer_tpu_torch.kernels import colour_track as ct
from signalizer_tpu_torch.kernels import filters as tf
from signalizer_tpu_torch.kernels import oscilloscope as tk

REPO = Path(__file__).resolve().parent.parent
BAND_COLOURS = np.array([[1.0, 0.1, 0.1], [0.1, 1.0, 0.1], [0.1, 0.1, 1.0]], np.float32)
CALLS, W = 3, 2048


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stream(pairs, rows, fs, seed, silent):
    """[pairs, rows, CALLS * W]: tones across the three bands plus noise;
    the (pair, row) ``silent`` exactly zero."""
    rng = np.random.default_rng(seed)
    n = np.arange(CALLS * W)
    x = np.zeros((pairs, rows, n.size), np.float32)
    for p in range(pairs):
        for r in range(rows):
            f = (120.0, 900.0, 6000.0)
            amp = rng.uniform(0.05, 0.5, 3)
            x[p, r] = sum(a * np.sin(2 * np.pi * fk * (p + 1) * n / fs + r) for a, fk in zip(amp, f))
            x[p, r] += 0.01 * rng.standard_normal(n.size)
    if silent is not None:
        x[silent] = 0.0
    return x


CASES = [
    # (pairs, rows, fs, per-pair keys)
    (3, 1, 48_000.0, False),
    (3, 2, 48_000.0, True),
    (3, 2, 96_000.0, False),
    (3, 1, 96_000.0, True),
]


@pytest.mark.parametrize("pairs,rows,fs,pair_keys", CASES)
def test_colour_track_plain_matches_jax_and_the_float64_oracle(pairs, rows, fs, pair_keys):
    rng = np.random.default_rng(rows + int(fs) // 1000)
    x = _stream(pairs, rows, fs, seed=7 + rows, silent=(pairs - 1, rows - 1))
    pole = float(np.exp(-1.0 / (10e-3 * fs)))  # the view's 10 ms smoother
    key = rng.random((pairs, rows, 3) if pair_keys else (rows, 3)).astype(np.float32)
    blend = 0.8
    z = (rng.standard_normal((pairs, rows, 8, 2)) * 0.01).astype(np.float32)
    z[pairs - 1, rows - 1] = 0.0  # the silent row starts from rest
    s = np.zeros((pairs, rows, 3), np.float32)
    state, smooth = tf.CrossoverState(_t(z)), _t(s)
    jstate, jsmooth = jf.CrossoverState(jnp.asarray(z)), jnp.asarray(s)
    z64, s64 = z.reshape(-1, 8, 2).astype(np.float64), s.reshape(-1, 3).astype(np.float64)
    rel = 1e-4 if fs == 48_000.0 else 1e-3
    for call in range(CALLS):
        xb = x[..., call * W : (call + 1) * W]
        bands, _ = ct.three_band_split_plain(_t(xb), fs, state=state)
        colours, new_state, new_smooth = ct.colour_track_plain(
            _t(xb), fs, state, pole, _t(BAND_COLOURS), _t(key), blend, smooth)
        jbands, jnew = jf.three_band_split(jnp.asarray(xb), fs, state=jstate)
        jcol, jsmooth = jk.spectral_colour_track(jbands, jnp.float32(pole), jnp.asarray(BAND_COLOURS),
                                                 jnp.asarray(key), jnp.float32(blend), jsmooth)
        keys = np.broadcast_to(key, (pairs, rows, 3)).reshape(-1, 3)
        want, z64, sm64, want_col = ct.float64_reference(xb.reshape(-1, W), fs, z64, pole, s64, BAND_COLOURS,
                                                         keys, blend)
        want = want.reshape(bands.shape)
        peak = float(np.abs(want).max())
        port_err = float(np.abs(bands.numpy() - want).max())
        jax_err = float(np.abs(np.asarray(jbands) - want).max())
        assert port_err <= rel * peak, (call, port_err)
        np.testing.assert_allclose(new_state.z.numpy(), z64.reshape(z.shape), rtol=0, atol=rel * peak)
        np.testing.assert_allclose(bands.numpy(), np.asarray(jbands), rtol=0, atol=port_err + jax_err + 1e-7)
        np.testing.assert_allclose(new_state.z.numpy(), np.asarray(jnew.z), rtol=0, atol=port_err + jax_err + 1e-7)
        # the smoothing state and the colours against the float64 chain
        s64 = sm64[..., -1]
        bound = 2 * rel * float(s64.max())
        port_err = float(np.abs(new_smooth.numpy().reshape(-1, 3) - s64).max())
        jax_err = float(np.abs(np.asarray(jsmooth).reshape(-1, 3) - s64).max())
        assert port_err <= bound, (call, port_err, bound)
        np.testing.assert_allclose(new_smooth.numpy(), np.asarray(jsmooth), rtol=0, atol=port_err + jax_err + 1e-12)
        # channel-major colours: [..., 3, W] against JAX's [..., W, 3]
        assert colours.shape == (pairs, rows, 3, W)
        port_err = float(np.abs(colours.numpy().reshape(-1, 3, W) - want_col).max())
        jax_err = float(np.abs(np.moveaxis(np.asarray(jcol), -1, -2).reshape(-1, 3, W) - want_col).max())
        assert port_err <= 1e-3, (call, port_err)
        np.testing.assert_allclose(torch.movedim(colours, -2, -1).numpy(), np.asarray(jcol), rtol=0,
                                   atol=port_err + jax_err + 1e-6)
        silent_key = key[pairs - 1, rows - 1] if pair_keys else key[rows - 1]
        want_silent = silent_key + (np.float32(0.0) - silent_key) * np.float32(blend)
        assert np.array_equal(colours[pairs - 1, rows - 1].numpy(), np.broadcast_to(want_silent[:, None], (3, W)))
        assert bool((new_state.z[pairs - 1, rows - 1] == 0).all()) and bool((new_smooth[pairs - 1, rows - 1] == 0).all())
        state, smooth, jstate = new_state, new_smooth, jnew


def test_public_functions_take_the_plain_versions_on_the_cpu():
    """filters.three_band_split, oscilloscope.spectral_colour_track and
    colour_track on CPU tensors are the plain versions, bit for bit, and
    colour_track's colours are spectral_colour_track's, channel-major."""
    rng = np.random.default_rng(5)
    x = _t((rng.standard_normal((2, 2, 1500)) * 0.3).astype(np.float32))
    z = tf.CrossoverState(_t((rng.standard_normal((2, 2, 8, 2)) * 0.01).astype(np.float32)))
    s = _t(rng.random((2, 2, 3)).astype(np.float32) * 0.01)
    key = _t(rng.random((2, 3)).astype(np.float32))
    bands, zb = tf.three_band_split(x, 96_000.0, state=z)
    pb, pz = ct.three_band_split_plain(x, 96_000.0, state=z)
    assert torch.equal(bands, pb) and torch.equal(zb.z, pz.z)
    cols, cs = tk.spectral_colour_track(bands, torch.tensor(0.999), _t(BAND_COLOURS), key, torch.tensor(0.6), s)
    pc, ps = ct.spectral_colour_track_plain(bands, torch.tensor(0.999), _t(BAND_COLOURS), key, torch.tensor(0.6), s)
    assert torch.equal(cols, pc) and torch.equal(cs, ps)
    got, gz, gs = ct.colour_track(x, 96_000.0, z, 0.999, _t(BAND_COLOURS), key, torch.tensor(0.6), s)
    assert torch.equal(torch.movedim(got, -2, -1), cols) and torch.equal(gz.z, zb.z) and torch.equal(gs, cs)


def test_wrappers_refuse_a_device_they_cannot_take():
    """No fallback: a tensor neither on the CPU nor on a CUDA device raises."""
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ct.three_band_split(x, 48_000.0)
    with pytest.raises(ValueError, match="unsupported device"):
        ct.colour_track(x, 48_000.0, None, 0.99, torch.empty(3, 3), torch.empty(3), 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        ct.spectral_colour_track(torch.empty((2, 3, 64), device="meta"), 0.99, torch.empty(3, 3), torch.empty(3), 1.0)


def _cu_constants():
    src = (REPO / "signalizer_tpu_torch" / "csrc" / "colour_track.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    return consts


def test_host_table_matches_the_kernel_source():
    """The wrapper's chunk, largest block, largest cluster, warps a cluster
    and scan steps are the kernel's kChunk, kThreads, kMaxCluster,
    kClusterWarps and kSteps (a block's segment is at most kThreads x
    kChunk samples; the scan over a cluster's warps takes one a lane), and
    the table has the kernel's kTable floats: four sets of 8 + 4 kPowers and
    a pole block of 4 + kPowers, kPowers = kChunk + 32 + kSteps."""
    k = _cu_constants()
    assert (ct.CHUNK, ct.THREADS, ct.MAX_CLUSTER, ct.CLUSTER_WARPS, ct.STEPS) == (
        k["kChunk"], k["kThreads"], k["kMaxCluster"], k["kClusterWarps"], k["kSteps"])
    assert ct.THREADS * ct.CHUNK == 8192  # the longest segment a block takes
    assert 2 ** k["kSteps"] == k["kClusterWarps"] == 32
    powers = k["kChunk"] + 32 + k["kSteps"]
    assert len(ct.exponents()) == powers
    for fs in (48_000.0, 96_000.0, None):
        table = ct.host_table(fs, pole=0.999)
        assert table.shape == (4 * (8 + 4 * powers) + 4 + powers,) and table.dtype == np.float32
        assert np.isfinite(table).all()


@pytest.mark.parametrize("fs", [48_000.0, 96_000.0])
def test_host_table_holds_the_plain_coefficients_and_float64_powers(fs):
    """Each set starts with the companion matrix, bv and b0 as
    biquad_filter forms them in float32; every power is the float64 power
    of those float32 entries rounded once, in the kernel's order (fix-ups,
    lanes, warp multiples, the scans' steps); the pole block likewise."""
    chunk = ct.CHUNK
    exps = ct.exponents()
    assert exps == (list(range(1, chunk + 1)) + [chunk * k for k in range(32)]
                    + [32 * chunk * 2**k for k in range(ct.STEPS)])
    n_set = 8 + 4 * len(exps)
    table = ct.host_table(fs, pole=0.99896)
    for i, c in enumerate(ct.crossover_coeffs(fs)):
        blk = table[i * n_set : (i + 1) * n_set]
        a = np.array([[-c.a1, 1.0], [-c.a2, 0.0]], np.float32)
        assert np.array_equal(blk[:4], a.ravel())
        assert blk[4] == np.float32(c.b1 - c.a1 * c.b0) and blk[5] == np.float32(c.b2 - c.a2 * c.b0)
        assert blk[6] == np.float32(c.b0)
        for n, e in enumerate(exps):
            want = np.linalg.matrix_power(a.astype(np.float64), e).astype(np.float32)
            assert np.array_equal(blk[8 + 4 * n : 12 + 4 * n], want.ravel()), e
        assert np.array_equal(blk[8 + 4 * chunk : 12 + 4 * chunk], np.eye(2, dtype=np.float32).ravel())
    pole = table[4 * n_set :]
    p = np.float32(0.99896)
    assert pole[0] == p and pole[1] == np.float32(1.0) - p
    for n, e in enumerate(exps):
        assert pole[4 + n] == np.float32(float(p) ** e), e
    # one block of 512 threads a row (the earlier designs, PERF.md §6): the
    # warp scan's 4 steps
    old = ct.host_table(fs, pole=0.99896, steps=4)
    assert len(old) == 4 * (8 + 4 * (chunk + 32 + 4)) + 4 + chunk + 32 + 4
    assert np.array_equal(old[:8 + 4 * (chunk + 36)], table[:8 + 4 * (chunk + 36)])
