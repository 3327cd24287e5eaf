"""Kernel A on rows longer than one block's shared memory, on the CPU.

* The plain path at N = 65536 and 131072 against the JAX package's
  ``analyze_frames`` (XLA's FFT on the CPU) and its stage 1: display values
  to rtol/atol 1e-5, as tests/test_torch_spectrum.py holds the 4096-point
  step, and magnitudes to 1e-5 of each row's peak (two float32 FFTs of a
  row of 2^16-2^17 points).
* The two-pass form's arithmetic rehearsed in torch: the four-step
  decomposition of ``csrc/window_fft_mag_long.cu`` — the columns'
  transforms, the twiddles w_L^(n2 k1) read from the constant's
  ``fft_twiddles`` with their sign, the rows' transforms and the real
  split with partner rows in one block — in float32 with the kernel's
  indices, against ``torch.fft``. Bound: 5e-6 of each row's peak, the
  bound the kernel is held to on the card.
* Kernel B's grouping of line graphs beyond one launch's eight, rehearsed
  with the plain decay: equal bit for bit to all line graphs at once.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.core.config import BinInterpolation, SpectrumChannels, ViewScaling
from signalizer_tpu.core.constant import make_spectrum_constant as jax_make
from signalizer_tpu.kernels.spectrum import LineGraphState as JaxState
from signalizer_tpu.kernels.spectrum import analyze_frames as jax_analyze
from signalizer_tpu.kernels.spectrum import _half_spectrum as jax_half_spectrum
from signalizer_tpu.kernels.spectrum import _pack_channels as jax_pack_channels
from signalizer_tpu_torch.core.constant import fft_twiddles, make_spectrum_constant
from signalizer_tpu_torch.kernels import display_map as dm
from signalizer_tpu_torch.kernels import window_fft_mag as wfm
from signalizer_tpu_torch.kernels.spectrum import analyze_frames, line_graph_state_from_arrays

FS = 48_000.0
CPU = torch.device("cpu")


def _pair(**kw):
    kw.setdefault("sample_rate", FS)
    return jax_make(fft_backend="xla", **kw), make_spectrum_constant(device=CPU, **kw)


@pytest.mark.parametrize("window", [48_000, 100_000], ids=["n65536", "n131072"])
@pytest.mark.parametrize("mode", [SpectrumChannels.SEPARATE, SpectrumChannels.MIDSIDE, SpectrumChannels.COMPLEX],
                         ids=lambda m: m.name)
def test_long_rows_match_jax_analyze_frames(mode, window):
    jc, tc = _pair(
        axis_points=256, window_size=window, configuration=mode,
        bin_interpolation=BinInterpolation.LINEAR, view_scaling=ViewScaling.LOGARITHMIC,
    )
    assert tc.transform_size == jc.transform_size == 1 << (window - 1).bit_length()
    assert wfm.form(tc) != "block"
    rng = np.random.default_rng(window + int(mode))
    frames = (rng.standard_normal((1, 2, 2, window)) * 0.3).astype(np.float32)
    mag0 = (rng.random((1, 2, tc.state_channels, 256)) * 0.05).astype(np.float32)
    phase0 = np.zeros((1, 2, 256), np.float32)
    state = line_graph_state_from_arrays(mag0, phase0, CPU)
    got = analyze_frames(tc, state, torch.from_numpy(frames)).results.numpy()
    want = jax_analyze(jc, JaxState(jnp.asarray(mag0), jnp.asarray(phase0)), jnp.asarray(frames),
                       decay_domain="linear")
    np.testing.assert_allclose(got, np.asarray(want.results), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.magnitude.numpy(), np.asarray(want.state.magnitude), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("window", [48_000, 65_536, 100_000, 131_072])
def test_long_rows_stage_one_matches_jax(window):
    """The plain kernel-A function's magnitudes against JAX's packing and
    half spectrum on the same frames, PHASE's complex cells included."""
    for mode in (SpectrumChannels.SEPARATE, SpectrumChannels.PHASE):
        jc, tc = _pair(axis_points=64, window_size=window, configuration=mode)
        frames = (np.random.default_rng(window).standard_normal((2, 2, window)) * 0.3).astype(np.float32)
        got = wfm.window_fft_mag_plain(tc, torch.from_numpy(frames)).numpy()
        want = np.asarray(jax_half_spectrum(jc, jax_pack_channels(jc, jnp.asarray(frames))))
        if mode != SpectrumChannels.PHASE:
            want = np.abs(want)
        err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
        assert err.max() <= 1e-5, err.max()


# --- the two-pass form's arithmetic --------------------------------------------


def _cmul(a, b):
    return torch.complex(a.real * b.real - a.imag * b.imag, a.real * b.imag + a.imag * b.real)


def four_step(z: torch.Tensor, n: int, real: bool) -> torch.Tensor:
    """The two-pass form on rows ``z`` [rows, L] complex64 (the packed z[m] =
    x[2m] + i x[2m+1] of a real row, or a COMPLEX row), with the kernel's
    indices: real rows give X[0..L] (halved DC and Nyquist), COMPLEX rows
    |Z|. The L1- and L2-point transforms are torch's; what is rehearsed is
    the kernel's own arithmetic around them."""
    rows, length = z.shape
    log2l = length.bit_length() - 1
    l1 = 1 << (log2l >> 1)
    l2 = length // l1
    t = torch.from_numpy(fft_twiddles(n))
    tw = torch.complex(t[:, 0], t[:, 1])
    # pass 1: column n2 holds z[l2 n1 + n2]; transform over n1, twiddle
    cols = torch.fft.fft(z.reshape(rows, l1, l2), dim=1)  # [rows, k1, n2]
    k1 = torch.arange(l1)[:, None]
    n2 = torch.arange(l2)[None, :]
    j = (n2 * k1) & (length - 1)
    w = tw[length // 2 + (j & (length // 2 - 1))]
    w = torch.where(j & (length // 2) != 0, -w, w)
    y = _cmul(cols, w)  # the scratch: Y[k1][n2]
    # pass 2: rows k1 of Y transformed over n2: Z[k1 + l1 k2] = R[k1, k2]
    r = torch.fft.fft(y, dim=2)
    if not real:
        return r.transpose(1, 2).reshape(rows, length).abs()
    out = torch.full((rows, length + 1), complex(float("nan"), 0.0), dtype=torch.complex64)
    for jj in range(l1 // 2 + 1):
        pair = [jj] if jj in (0, l1 // 2) else [jj, l1 - jj]
        n_out = l2 // 2 + 1 if jj == 0 else (l2 if len(pair) == 2 else l2 // 2)
        k2 = torch.arange(n_out)
        k2m = (l2 - k2) & (l2 - 1) if jj == 0 else l2 - 1 - k2
        k = jj + l1 * k2
        km = length - k
        zk = r[:, pair[0], k2]
        zm = r[:, pair[-1], k2m]
        swap = k > length // 2
        k, km = torch.where(swap, km, k), torch.where(swap, k, km)
        zk, zm = torch.where(swap, zm, zk), torch.where(swap, zk, zm)
        wk = tw[length + k]
        er, ei = 0.5 * (zk.real + zm.real), 0.5 * (zk.imag - zm.imag)
        dr, di = 0.5 * (zk.real - zm.real), 0.5 * (zk.imag + zm.imag)
        p = wk.real * di + wk.imag * dr
        q = wk.real * dr - wk.imag * di
        scale = torch.where(k == 0, 0.5, 1.0)
        assert out[:, k].isnan().all() and out[:, km[km != k]].isnan().all()  # each bin once
        out[:, k] = torch.complex(er + p, ei - q) * scale
        out[:, km[km != k]] = (torch.complex(er - p, -ei - q) * scale)[:, km != k]
    assert not out.isnan().any()
    return out


@pytest.mark.parametrize("n", [2048, 4096, 65536])
def test_four_step_real_rows_match_rfft(n):
    """A zero-padded real row (W < N) and a silent row through the
    rehearsal: X[k] within 5e-6 of the row's peak, DC and Nyquist halved,
    the silent row exactly 0."""
    rng = np.random.default_rng(n)
    x = torch.zeros(2, n)
    x[0, : n - 37] = torch.from_numpy(rng.standard_normal(n - 37).astype(np.float32))
    z = torch.complex(x[:, 0::2], x[:, 1::2])
    got = four_step(z, n, real=True)
    want = torch.fft.rfft(x.double(), dim=-1)
    want[:, 0] *= 0.5
    want[:, -1] *= 0.5
    err = (got.cdouble() - want).abs().amax(-1)[0] / want.abs().amax(-1)[0]
    assert float(err) <= 5e-6
    assert bool((got[1] == 0).all())


@pytest.mark.parametrize("n", [1024, 8192, 32768])
def test_four_step_complex_rows_match_fft(n):
    rng = np.random.default_rng(n + 1)
    z = torch.from_numpy((rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64))
    got = four_step(z, n, real=False)
    want = torch.fft.fft(z.cdouble(), dim=-1).abs()
    assert float(((got.double() - want).abs().amax(-1) / want.amax(-1)).max()) <= 5e-6


def test_long_form_limits():
    """The wrapper's bounds: the one-block form to 32768 (COMPLEX 16384),
    the cluster form to 131072 (65536), the two-pass form to a core of
    2^20 complex points."""
    assert (wfm.MAX_TRANSFORM_SIZE, wfm.MAX_COMPLEX_TRANSFORM_SIZE) == (32768, 16384)
    assert (wfm.MAX_LONG_TRANSFORM_SIZE, wfm.MAX_LONG_COMPLEX_TRANSFORM_SIZE) == (1 << 21, 1 << 20)
    for window, mode, route in [
        (32768, SpectrumChannels.SEPARATE, "block"),
        (32769, SpectrumChannels.SEPARATE, "cluster"),
        (131073, SpectrumChannels.SEPARATE, "two_pass"),
        (16384, SpectrumChannels.COMPLEX, "block"),
        (16385, SpectrumChannels.COMPLEX, "cluster"),
        (65537, SpectrumChannels.COMPLEX, "two_pass"),
    ]:
        c = make_spectrum_constant(axis_points=32, window_size=window, configuration=mode, device=CPU)
        assert wfm.form(c) == route


# --- kernel B's line-graph groups -------------------------------------------


@pytest.mark.parametrize("graphs", [8, 9, 17])
def test_line_graph_groups_cover_every_line_graph(graphs):
    """``_line_graph_groups`` hands out groups of at most eight line graphs
    whose state and output are written back where they belong: the plain
    decay run group by group equals all line graphs at once bit for bit."""
    c = make_spectrum_constant(axis_points=48, window_size=256, configuration=SpectrumChannels.SEPARATE,
                               num_line_graphs=graphs, decay_seconds=(0.05, 0.2, 0.0, 1.0), device=CPU)
    rng = np.random.default_rng(graphs)
    vals = torch.from_numpy(rng.random((3, 5, 2, 48)).astype(np.float32))
    state = torch.from_numpy(rng.random((3, graphs, 2, 48)).astype(np.float32))
    s_all, s_groups = state.clone(), state.clone()
    want = dm.decay_db(c, s_all, vals)
    out = torch.empty_like(want)
    sizes = []
    for poles, st, o, k in dm._line_graph_groups(c, s_groups, out):
        sizes.append(k)
        o.copy_(dm.decay_db(dataclasses.replace(c, decay_poles=poles), st, vals))
    assert sizes == [min(8, graphs - i) for i in range(0, graphs, 8)]
    assert torch.equal(out, want) and torch.equal(s_groups, s_all)
