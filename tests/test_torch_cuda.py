"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test takes the ``cuda`` fixture, which skips where
``torch.cuda.is_available()`` is false, so on a CPU-only machine this file
collects and skips. It imports no jax, so on a machine without jax run it
as ``python -m pytest --noconftest tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from signalizer_tpu.core.config import BinInterpolation, SpectrumChannels, ViewScaling
from signalizer_tpu_torch.core.constant import make_spectrum_constant
from signalizer_tpu_torch.kernels import display_map as dm
from signalizer_tpu_torch.kernels import window_fft_mag as wfm
from signalizer_tpu_torch.kernels.spectrum import analyze_frames, init_line_graph_state

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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _frames(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32)).to(device)


def _row_rel_err(got, want):
    """max |got - want| / max |want| per trailing row (complex: |.| of the
    difference)."""
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp(min=1e-30)
    return float((err / scale).max())


@pytest.mark.parametrize("window", [24, 256, 700, 4096, 16384])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_window_fft_mag_kernel_matches_plain(cuda, mode, window):
    """Kernel A vs torch.fft on the card, every mode, N from 32 to 16384,
    W < N included. Bound: 5e-6 of each row's max (the Pallas kernel's
    bound against float64 numpy)."""
    c = make_spectrum_constant(axis_points=64, window_size=window, configuration=mode, device=cuda)
    frames = _frames((3, 5, 2, window), seed=window + int(mode), device=cuda)
    before = wfm.launches
    got = wfm.window_fft_mag(c, frames)
    want = wfm.window_fft_mag_plain(c, frames)
    torch.cuda.synchronize()
    assert wfm.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _row_rel_err(got, want) <= 5e-6


def test_window_fft_mag_silent_rows_stay_zero(cuda):
    c = make_spectrum_constant(axis_points=64, window_size=1024, configuration=SpectrumChannels.SEPARATE, device=cuda)
    frames = _frames((2, 2, 1024), seed=1, device=cuda)
    frames[:, 1] = 0.0
    got = wfm.window_fft_mag(c, frames)
    assert (got[:, 1] == 0).all()
    assert (got[:, 0] > 0).any()


def test_window_fft_mag_refuses_what_it_cannot_take(cuda):
    big = make_spectrum_constant(axis_points=64, window_size=20000, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wfm.window_fft_mag(big, _frames((1, 2, 20000), seed=2, device=cuda))
    c = make_spectrum_constant(axis_points=64, window_size=256, device=cuda)
    with pytest.raises(TypeError):
        wfm.window_fft_mag(c, _frames((1, 2, 256), seed=3, device=cuda).double())
    with pytest.raises(ValueError):
        wfm.window_fft_mag(c, _frames((1, 2, 512), seed=3, device=cuda)[..., ::2])


def _mags_state(c, seed, t, pairs, device):
    rng = np.random.default_rng(seed)
    rows = c.state_channels
    mags = np.abs(rng.standard_normal((pairs, t, rows, c.n_spectrum_values))) * 40.0
    state = rng.random((pairs, c.num_line_graphs, rows, c.axis_points)) * 0.5
    return (
        torch.from_numpy(mags.astype(np.float32)).to(device),
        torch.from_numpy(state.astype(np.float32)).to(device),
    )


@pytest.mark.parametrize("t,valid", [(1, None), (1, [False]), (7, [True, False, True, True, False, False, True])])
@pytest.mark.parametrize("interp", INTERPS, ids=lambda i: i.name)
@pytest.mark.parametrize("mode", MAG_MODES, ids=lambda m: m.name)
def test_display_map_kernel_matches_plain(cuda, mode, interp, t, valid):
    """Kernel B vs the plain remap + decay loop + dB on the card. Bounds:
    display atol 1e-5, state rtol 1e-6 — the same operations, only the
    2- to 10-tap sum may round differently (fused multiply-adds). Lanczos
    taps have negative lobes, so that sum can cancel: its rounding error
    scales with the spectrum, not the result, and the state also gets an
    atol of 1e-6 of its largest value."""
    c = make_spectrum_constant(
        axis_points=300, window_size=2048, configuration=mode, bin_interpolation=interp,
        view_scaling=ViewScaling.LOGARITHMIC, device=cuda,
    )
    mags, state = _mags_state(c, seed=int(mode) * 7 + int(interp) + t, t=t, pairs=3, device=cuda)
    s_kernel, s_plain = state.clone(), state.clone()
    before = dm.launches
    got = dm.display_map(c, mags, s_kernel, valid)
    want = dm.display_map_plain(c, mags, s_plain, valid)
    torch.cuda.synchronize()
    assert dm.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    atol = 1e-6 * float(s_plain.abs().max()) if interp == BinInterpolation.LANCZOS else 0.0
    torch.testing.assert_close(s_kernel, s_plain, rtol=1e-6, atol=atol)
    if valid is not None and not any(valid):
        assert torch.equal(s_kernel, state)


def test_analyze_frames_on_cuda_goes_through_both_kernels(cuda):
    """The magnitude path launches kernel A and kernel B once per call and
    agrees with the plain versions composed on the same tensors (display
    atol 2e-4, the bound the JAX package holds its two decay forms to)."""
    c = make_spectrum_constant(
        axis_points=512, window_size=4096, configuration=SpectrumChannels.SEPARATE,
        view_scaling=ViewScaling.LOGARITHMIC, device=cuda,
    )
    frames = _frames((2, 6, 2, 4096), seed=5, device=cuda)
    state = init_line_graph_state(c, (2,))
    plain_state = state.magnitude.clone()
    a0, b0 = wfm.launches, dm.launches
    got = analyze_frames(c, state, frames).results
    want = dm.display_map_plain(c, wfm.window_fft_mag_plain(c, frames), plain_state)
    torch.cuda.synchronize()
    assert (wfm.launches - a0, dm.launches - b0) == (1, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)
    torch.testing.assert_close(state.magnitude, plain_state, rtol=1e-5, atol=1e-9)


def test_phase_on_cuda_feeds_kernel_a_complex_output(cuda):
    c = make_spectrum_constant(axis_points=128, window_size=1024, configuration=SpectrumChannels.PHASE, device=cuda)
    frames = _frames((2, 3, 2, 1024), seed=6, device=cuda)
    a0, b0 = wfm.launches, dm.launches
    out = analyze_frames(c, init_line_graph_state(c, (2,)), frames).results
    assert (wfm.launches - a0, dm.launches - b0) == (1, 0)
    cpu = c.to("cpu")
    want = analyze_frames(cpu, init_line_graph_state(cpu, (2,)), frames.cpu()).results
    torch.testing.assert_close(out[..., 0, :].cpu(), want[..., 0, :], rtol=1e-4, atol=1e-4)
