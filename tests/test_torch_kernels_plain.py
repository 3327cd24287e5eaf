"""The plain PyTorch versions of the port's two kernels against the JAX
package: kernel A's stage 1 (window -> FFT -> |.|) and kernel B's tail
(remap -> decay -> dB), on the same seeded numpy inputs.

The JAX Pallas kernels run in interpret mode, as their own tests run
them on the CPU; the CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.core.config import BinInterpolation, SpectrumChannels, ViewScaling
from signalizer_tpu.core.constant import make_spectrum_constant as jax_make
from signalizer_tpu.kernels.pallas_spectrum import fused_window_rfft_mag, make_fused_plan
from signalizer_tpu.kernels.spectrum import (
    LineGraphState as JaxState,
    _half_spectrum,
    _pack_channels,
    _remap_mag,
    post_process,
)
from signalizer_tpu_torch.core.constant import make_spectrum_constant
from signalizer_tpu_torch.kernels import display_map as dm
from signalizer_tpu_torch.kernels import window_fft_mag as wfm
from signalizer_tpu_torch.utils.diagnostics import counter

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))

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
MAG_MODES = [m for m in MODES if m != SpectrumChannels.PHASE]
INTERPS = [BinInterpolation.NONE, BinInterpolation.LINEAR, BinInterpolation.LANCZOS]


def _pair(**kw):
    kw.setdefault("sample_rate", FS)
    return jax_make(fft_backend="xla", **kw), make_spectrum_constant(device="cpu", **kw)


def _row_rel_err(got, want):
    """max |got - want| / max |want| per trailing row."""
    err = np.abs(got - want).max(axis=-1)
    scale = np.abs(want).max(axis=-1)
    return float((err / scale).max())


def test_stage1_plain_matches_pallas_fused_kernel_interpret():
    """window_fft_mag_plain vs fused_window_rfft_mag at N=1024 on 3 frames
    of 2 rows; the Pallas kernel neither packs nor halves, so the JAX side
    halves DC/Nyquist. Bound: 5e-6 of each row's max, the bound the Pallas
    kernel holds against float64 numpy (tests/test_pallas_spectrum.py)."""
    n = 1024
    _, tc = _pair(axis_points=128, window_size=n, configuration=SpectrumChannels.SEPARATE)
    frames = np.random.default_rng(11).standard_normal((3, 2, n)).astype(np.float32)
    plan = make_fused_plan(n, tc.window_kernel.numpy())
    want = np.asarray(fused_window_rfft_mag(plan, jnp.asarray(frames), interpret=True))
    want = want[..., : n // 2 + 1].copy()
    want[..., [0, n // 2]] *= 0.5
    got = wfm.window_fft_mag_plain(tc, torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (3, 2, n // 2 + 1)
    assert _row_rel_err(got, want) <= 5e-6


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_stage1_plain_matches_jax_pack_and_half_spectrum(mode):
    """All 8 channel modes against JAX _pack_channels + _half_spectrum +
    abs (full-circle fft for COMPLEX, the complex cells for PHASE); W < N
    exercises the zero padding. Bound: 5e-6 of each row's max (two float32
    FFT libraries)."""
    jc, tc = _pair(axis_points=96, window_size=700, configuration=mode)
    frames = np.random.default_rng(int(mode)).standard_normal((2, 3, 2, 700)).astype(np.float32)
    packed = _pack_channels(jc, jnp.asarray(frames))
    if mode == SpectrumChannels.COMPLEX:
        want = np.abs(np.asarray(jnp.fft.fft(packed, n=jc.transform_size)))[..., None, :]
    else:
        spec = np.asarray(_half_spectrum(jc, packed))
        want = spec if mode == SpectrumChannels.PHASE else np.abs(spec)
    got = wfm.window_fft_mag_plain(tc, torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape
    assert got.shape[:-1] == wfm.out_shape(tc, (2, 3))[:-1]
    assert _row_rel_err(got, want) <= 5e-6


def _mags_and_state(tc, seed, t=3, pairs=2):
    rng = np.random.default_rng(seed)
    rows = tc.state_channels
    mags = (np.abs(rng.standard_normal((pairs, t, rows, tc.n_spectrum_values))) * 40.0).astype(np.float32)
    state = (rng.random((pairs, tc.num_line_graphs, rows, tc.axis_points)) * 0.5).astype(np.float32)
    return mags, state


@pytest.mark.parametrize("interp", INTERPS, ids=lambda i: i.name)
@pytest.mark.parametrize("mode", MAG_MODES, ids=lambda m: m.name)
def test_display_tail_plain_matches_jax_remap_and_linear_post_process(mode, interp):
    """display_map_plain vs JAX inv * _remap_mag + post_process(linear) on
    the same magnitudes and carried state, with a padded (invalid) frame.
    rtol/atol 1e-5: the same operations, but JAX's associative scan
    multiplies pole products in another order than the sequential loop."""
    jc, tc = _pair(
        axis_points=128, window_size=512, configuration=mode,
        bin_interpolation=interp, view_scaling=ViewScaling.LOGARITHMIC,
    )
    mags, state = _mags_and_state(tc, seed=int(mode) * 3 + int(interp))
    valid = np.array([True, False, True])
    vals = jc.inv_size * _remap_mag(jnp.asarray(mags), jc)
    phase0 = jnp.zeros(state.shape[:2] + state.shape[3:], jnp.float32)
    want = post_process(jc, JaxState(jnp.asarray(state), phase0), vals, valid=valid, decay_domain="linear")
    st = torch.from_numpy(state.copy())
    got = dm.display_map_plain(tc, torch.from_numpy(mags), st, valid=valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.results), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(want.state.magnitude), rtol=1e-5, atol=1e-7)


def test_display_tail_plain_matches_pallas_display_map_interpret():
    """display_map_plain vs the retired Pallas fused_display_map for one
    frame and one line graph. atol 1e-3: that kernel selects chunk maxima
    through a bf16 matmul (tools/pallas_display_map.py:57)."""
    from pallas_display_map import fused_display_map, make_display_map_operands

    kw = dict(
        axis_points=256, window_size=512, configuration=SpectrumChannels.LEFT,
        bin_interpolation=BinInterpolation.LINEAR, view_scaling=ViewScaling.LOGARITHMIC,
        decay_seconds=(0.1,), num_line_graphs=1,
    )
    jc, tc = _pair(**kw)
    rng = np.random.default_rng(4)
    re = (rng.standard_normal((8, jc.n_spectrum_values)) * 20).astype(np.float32)
    im = (rng.standard_normal((8, jc.n_spectrum_values)) * 20).astype(np.float32)
    state = rng.random((8, 256)).astype(np.float32)
    want, want_state = fused_display_map(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(state), make_display_map_operands(jc),
        jc.decay_poles[0], jc.low_dbs, jc.high_dbs, jc.clip_db, jc.inv_size,
        batch_tile=8, pixel_tile=128, interpret=True,
    )
    mags = np.sqrt(re * re + im * im)[:, None, None, :]  # [B, T=1, rows=1, nv]
    st = torch.from_numpy(state[:, None, None, :].copy())  # [B, K=1, rows=1, P]
    got = dm.display_map_plain(tc, torch.from_numpy(mags), st)
    np.testing.assert_allclose(got.numpy()[:, 0, 0, 0], np.asarray(want), atol=1e-3)
    np.testing.assert_allclose(st.numpy()[:, 0, 0], np.asarray(want_state), rtol=6e-3, atol=1e-4)


def test_wrappers_take_the_plain_path_for_cpu_tensors():
    """On a CPU tensor each wrapper is its plain version, and its launch
    counter stays put (the counters count kernel launches only)."""
    _, tc = _pair(axis_points=64, window_size=256, configuration=SpectrumChannels.MIDSIDE)
    frames = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 2, 2, 256)).astype(np.float32))
    a0, b0 = counter("window_fft_mag.launches"), counter("display_map.launches")
    mags = wfm.window_fft_mag(tc, frames)
    assert torch.equal(mags, wfm.window_fft_mag_plain(tc, frames))
    s1 = torch.zeros(2, 2, 2, 64)
    s2 = s1.clone()
    assert torch.equal(dm.display_map(tc, mags, s1), dm.display_map_plain(tc, mags, s2))
    assert torch.equal(s1, s2)
    assert (counter("window_fft_mag.launches"), counter("display_map.launches")) == (a0, b0)
