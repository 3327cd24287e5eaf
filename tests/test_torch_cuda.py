"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test takes the ``cuda`` fixture, which skips where
``torch.cuda.is_available()`` is false, so on a CPU-only machine this file
collects and skips. It imports no jax, so on a machine without jax run it
as ``python -m pytest --noconftest tests/test_torch_cuda.py``."""

import contextlib

import numpy as np
import pytest
import scipy.signal
import torch

from colormap_cases import RATIO_SETS, branch_values, intensities
from phase_cases import phase_spectra
from signalizer_tpu_torch.core.config import BinInterpolation, OscChannels, SpectrumChannels, ViewScaling
from signalizer_tpu_torch.core.constant import make_spectrum_constant
from signalizer_tpu_torch.kernels import banded_resample as br
from signalizer_tpu_torch.kernels import colormap as cm
from signalizer_tpu_torch.kernels import colour_track as ct
from signalizer_tpu_torch.kernels import display_map as dm
from signalizer_tpu_torch.kernels import oscilloscope as tk
from signalizer_tpu_torch.kernels import phase_values as pv
from signalizer_tpu_torch.kernels import spectral_walk as sw
from signalizer_tpu_torch.kernels import window_fft_mag as wfm
from signalizer_tpu_torch.kernels.spectrum import (
    analyze_frames,
    init_line_graph_state,
    phase_values_plain,
    post_process,
    spectrum_values,
)
from signalizer_tpu_torch.utils.diagnostics import counter
from signalizer_tpu_torch.views import oscilloscope as tv

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


def _form_counts():
    """Calls that launched each form of kernel A so far."""
    return {"block": counter("window_fft_mag.launches"), "cluster": counter("window_fft_mag.cluster_launches"),
            "two_pass": counter("window_fft_mag.long_launches")}


def _one_more(before, route):
    return {k: v + (k == route) for k, v in before.items()}


def _row_rel_err(got, want):
    """max |got - want| / max |want| per trailing row (complex: |.| of the
    difference)."""
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp(min=1e-30)
    return float((err / scale).max())


@pytest.mark.parametrize("window", [24, 255, 256, 700, 701, 4096, 16384, 20000, 32768])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_window_fft_mag_kernel_matches_plain(cuda, mode, window):
    """Kernel A vs torch.fft on the card, every mode, N from 32 to 32768
    (COMPLEX above 16384 on the cluster form), W < N and odd W (the scalar
    loads) included. Bound: 5e-6 of each row's max (the Pallas kernel's
    bound against float64 numpy); the packed real transform's split adds one
    rounding per bin and stays inside it."""
    c = make_spectrum_constant(axis_points=64, window_size=window, configuration=mode, device=cuda)
    frames = _frames((3, 5, 2, window), seed=window + int(mode), device=cuda)
    route = wfm.form(c)
    assert route == ("block" if c.transform_size <= (16384 if mode == SpectrumChannels.COMPLEX else 32768)
                     else "cluster")
    before = _form_counts()
    got = wfm.window_fft_mag(c, frames)
    want = wfm.window_fft_mag_plain(c, frames)
    torch.cuda.synchronize()
    assert _form_counts() == _one_more(before, route)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _row_rel_err(got, want) <= 5e-6


def test_window_fft_mag_silent_rows_stay_zero(cuda):
    c = make_spectrum_constant(axis_points=64, window_size=1024, configuration=SpectrumChannels.SEPARATE, device=cuda)
    frames = _frames((2, 2, 1024), seed=1, device=cuda)
    frames[:, 1] = 0.0
    got = wfm.window_fft_mag(c, frames)
    assert (got[:, 1] == 0).all()
    assert (got[:, 0] > 0).any()


@pytest.mark.parametrize("window", [32, 701, 4096, 32768])
@pytest.mark.parametrize("mode", [SpectrumChannels.SEPARATE, SpectrumChannels.PHASE], ids=lambda m: m.name)
def test_window_fft_mag_silent_channel_beside_a_loud_one(cuda, mode, window):
    """An all-zero channel comes out exactly zero in every bin while the
    other channel of the same frame is loud (each row is its own packed
    transform), and the loud row keeps its bound."""
    c = make_spectrum_constant(axis_points=64, window_size=window, configuration=mode, device=cuda)
    frames = _frames((4, 2, window), seed=window, device=cuda) * 3.0
    frames[:, 1] = 0.0
    got = wfm.window_fft_mag(c, frames)
    want = wfm.window_fft_mag_plain(c, frames)
    torch.cuda.synchronize()
    assert bool((got[:, 1] == 0).all())
    assert _row_rel_err(got[:, 0], want[:, 0]) <= 5e-6


def test_window_fft_mag_takes_a_misaligned_view(cuda):
    """Frames that start 4 bytes past a 16-byte boundary take the scalar
    loads inside the kernel and give the aligned result."""
    c = make_spectrum_constant(axis_points=64, window_size=1024, configuration=SpectrumChannels.MIDSIDE, device=cuda)
    flat = _frames((3 * 2 * 1024 + 1,), seed=9, device=cuda)
    view = flat[1:].view(3, 2, 1024)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    got = wfm.window_fft_mag(c, view)
    assert torch.equal(got, wfm.window_fft_mag(c, view.clone()))
    assert _row_rel_err(got, wfm.window_fft_mag_plain(c, view)) <= 5e-6


@pytest.mark.parametrize(
    "mode,window,batch",
    [(m, 65536, (2, 2)) for m in MODES]
    + [(SpectrumChannels.SEPARATE, w, (1, 2)) for w in (48000, 131072, 262144, 1 << 20, 1 << 21)]
    + [(SpectrumChannels.PHASE, 100_000, (1, 2))]
    + [(SpectrumChannels.COMPLEX, w, (1, 2)) for w in (20000, 32768, 65536, 1 << 20)],
    ids=lambda v: v.name if isinstance(v, SpectrumChannels) else str(v),
)
def test_window_fft_mag_long_form_matches_plain(cuda, mode, window, batch):
    """Rows too long for one block against torch.fft on the card: every
    mode at N = 65536 and real rows to 131072 (COMPLEX 65536) on the
    cluster form, longer rows to 2^21 points (COMPLEX 2^20) on the two-pass
    form, W < N included; one launch of the form a call. Bound: 5e-6 of
    each row's max, the one-block form's."""
    c = make_spectrum_constant(axis_points=64, window_size=window, configuration=mode, device=cuda)
    route = wfm.form(c)
    limit = 65536 if mode == SpectrumChannels.COMPLEX else 131072
    assert route == ("cluster" if c.transform_size <= limit else "two_pass")
    frames = _frames(batch + (2, window), seed=window + int(mode), device=cuda)
    before = _form_counts()
    got = wfm.window_fft_mag(c, frames)
    want = wfm.window_fft_mag_plain(c, frames)
    torch.cuda.synchronize()
    assert _form_counts() == _one_more(before, route)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _row_rel_err(got, want) <= 5e-6


@pytest.mark.parametrize("batch", [(1,), (16,)], ids=["b1", "b16"])
@pytest.mark.parametrize("shorter", [0, 25536, 25535], ids=["w_eq_n", "w_lt_n", "odd_w"])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_window_fft_mag_cluster_form_matches_plain(cuda, mode, shorter, batch):
    """The cluster form against torch.fft on the card: every mode at
    N = 65536 (COMPLEX at 32768), W = N, W < N (even: the 8-byte loads)
    and odd W (the scalar loads), one frame and 16. Bound: 5e-6 of each
    row's max."""
    n = 32768 if mode == SpectrumChannels.COMPLEX else 65536
    window = n - shorter // (2 if mode == SpectrumChannels.COMPLEX else 1)
    c = make_spectrum_constant(axis_points=64, window_size=window, configuration=mode, device=cuda)
    assert c.transform_size == n and wfm.form(c) == "cluster"
    frames = _frames(batch + (2, window), seed=window + int(mode) + batch[0], device=cuda)
    before = _form_counts()
    got = wfm.window_fft_mag(c, frames)
    want = wfm.window_fft_mag_plain(c, frames)
    torch.cuda.synchronize()
    assert _form_counts() == _one_more(before, "cluster")
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _row_rel_err(got, want) <= 5e-6


def test_window_fft_mag_cluster_takes_a_misaligned_view(cuda):
    """Frames that start 4 bytes past an 8-byte boundary take the cluster
    form's scalar loads and give the aligned result."""
    c = make_spectrum_constant(axis_points=64, window_size=48000, configuration=SpectrumChannels.MIDSIDE, device=cuda)
    flat = _frames((2 * 2 * 48000 + 1,), seed=19, device=cuda)
    view = flat[1:].view(2, 2, 48000)
    assert view.data_ptr() % 8 == 4 and view.is_contiguous()
    got = wfm.window_fft_mag(c, view)
    assert torch.equal(got, wfm.window_fft_mag(c, view.clone()))
    assert _row_rel_err(got, wfm.window_fft_mag_plain(c, view)) <= 5e-6


@pytest.mark.parametrize("log2s", [1, 2, 3])
@pytest.mark.parametrize("mode", [SpectrumChannels.SEPARATE, SpectrumChannels.PHASE, SpectrumChannels.COMPLEX],
                         ids=lambda m: m.name)
def test_window_fft_mag_cluster_kernel_every_cluster_size(cuda, mode, log2s):
    """The cluster kernel's C entry with 2, 4 and 8 blocks a row (the sizes
    chip_smoke.py times) at N = 65536 (COMPLEX 32768) agrees with the plain
    version; a share larger than one block's shared memory (2 blocks for a
    65536-point core) is refused before launch."""
    from signalizer_tpu_torch.kernels import _build

    n = 32768 if mode == SpectrumChannels.COMPLEX else 65536
    c = make_spectrum_constant(axis_points=64, window_size=n - 1001, configuration=mode, device=cuda)
    frames = _frames((3, 2, c.window_size), seed=log2s, device=cuda)
    want = wfm.window_fft_mag_plain(c, frames)
    out = torch.empty(wfm.out_shape(c, (3,)) + ((2,) if mode == SpectrumChannels.PHASE else ()), device=cuda)
    _build.launch(
        "sig_window_fft_mag_cluster", frames.device, frames.data_ptr(), c.window_kernel.data_ptr(),
        c.fft_twiddles.data_ptr(), out.data_ptr(), 3, 2, c.window_size, n.bit_length() - 1, int(mode), log2s,
        name="sig_window_fft_mag_cluster")
    torch.cuda.synchronize()
    got = torch.view_as_complex(out) if mode == SpectrumChannels.PHASE else out
    assert _row_rel_err(got, want) <= 5e-6
    if log2s == 1:
        big = make_spectrum_constant(axis_points=64, window_size=2 * n, configuration=mode, device=cuda)
        with pytest.raises(RuntimeError, match="sig_window_fft_mag_cluster failed"):
            _build.launch(
                "sig_window_fft_mag_cluster", frames.device, frames.data_ptr(), big.window_kernel.data_ptr(),
                big.fft_twiddles.data_ptr(), out.data_ptr(), 1, 2, c.window_size, (2 * n).bit_length() - 1,
                int(mode), log2s, name="sig_window_fft_mag_cluster")


@pytest.mark.parametrize("mode", [SpectrumChannels.SEPARATE, SpectrumChannels.PHASE, SpectrumChannels.COMPLEX],
                         ids=lambda m: m.name)
def test_window_fft_mag_first_size_past_the_cluster_limit(cuda, mode):
    """The longest row of the cluster form takes it; the next transform size
    takes the two-pass form; both agree with the plain version."""
    limit = wfm.MAX_CLUSTER_COMPLEX_TRANSFORM_SIZE if mode == SpectrumChannels.COMPLEX else wfm.MAX_CLUSTER_TRANSFORM_SIZE
    for window, route in ((limit, "cluster"), (limit + 1, "two_pass")):
        c = make_spectrum_constant(axis_points=64, window_size=window, configuration=mode, device=cuda)
        assert wfm.form(c) == route
        frames = _frames((1, 2, window), seed=window, device=cuda)
        before = _form_counts()
        got = wfm.window_fft_mag(c, frames)
        want = wfm.window_fft_mag_plain(c, frames)
        torch.cuda.synchronize()
        assert _form_counts() == _one_more(before, route)
        assert _row_rel_err(got, want) <= 5e-6


@pytest.mark.parametrize("window", [65536, 131072])
@pytest.mark.parametrize("mode", [SpectrumChannels.SEPARATE, SpectrumChannels.PHASE, SpectrumChannels.MIDSIDE],
                         ids=lambda m: m.name)
def test_window_fft_mag_long_form_silent_channel(cuda, mode, window):
    """An all-zero channel beside a loud one comes out exactly zero on the
    cluster form (MIDSIDE: a mono frame's side row)."""
    c = make_spectrum_constant(axis_points=64, window_size=window, configuration=mode, device=cuda)
    assert wfm.form(c) == "cluster"
    frames = _frames((3, 2, window), seed=5, device=cuda) * 3.0
    if mode == SpectrumChannels.MIDSIDE:
        frames[:, 1] = frames[:, 0]
    else:
        frames[:, 1] = 0.0
    got = wfm.window_fft_mag(c, frames)
    want = wfm.window_fft_mag_plain(c, frames)
    torch.cuda.synchronize()
    assert bool((got[:, 1] == 0).all())
    assert _row_rel_err(got[:, 0], want[:, 0]) <= 5e-6


def _long_entry(c, frames, out, scratch):
    """The two-pass form's C entry on the wrapper's arguments."""
    from signalizer_tpu_torch.kernels import _build

    batch = frames.numel() // (frames.shape[-1] * frames.shape[-2])
    _build.launch(
        "sig_window_fft_mag_long", frames.device, frames.data_ptr(), c.window_kernel.data_ptr(),
        c.fft_twiddles.data_ptr(), scratch.data_ptr(), out.data_ptr(), batch, frames.shape[-2], c.window_size,
        c.transform_size.bit_length() - 1, int(c.configuration), name="window_fft_mag_long",
    )


@pytest.mark.parametrize(
    "mode,window",
    [(SpectrumChannels.SEPARATE, 262144), (SpectrumChannels.PHASE, 200_001), (SpectrumChannels.MIDSIDE, 262144),
     (SpectrumChannels.COMPLEX, 131072), (SpectrumChannels.SEPARATE, 1 << 20), (SpectrumChannels.PHASE, 1 << 21)],
    ids=lambda v: v.name if isinstance(v, SpectrumChannels) else str(v),
)
def test_window_fft_mag_two_pass_writes_every_bin(cuda, mode, window):
    """The two-pass form's entry (pass-2 blocks of 8 rows and their mirrors,
    stores through the transpose) into an output filled with NaN: every bin
    written, 5e-6 of each row's max against torch.fft, a silent channel
    exactly 0."""
    c = make_spectrum_constant(axis_points=64, window_size=window, configuration=mode, device=cuda)
    assert wfm.form(c) == "two_pass"
    l1, l2 = wfm.long_core(c)
    frames = _frames((3, 2, window), seed=window, device=cuda)
    frames[0, 1] = 0.0
    rows = 3 * (1 if mode == SpectrumChannels.COMPLEX else 2)
    out = torch.full(wfm.out_shape(c, (3,)) + ((2,) if mode == SpectrumChannels.PHASE else ()), float("nan"),
                     device=cuda)
    _long_entry(c, frames, out, torch.empty((rows, l1 * l2, 2), device=cuda))
    got = torch.view_as_complex(out) if mode == SpectrumChannels.PHASE else out
    want = wfm.window_fft_mag_plain(c, frames)
    torch.cuda.synchronize()
    assert _row_rel_err(got, want) <= 5e-6
    if mode in (SpectrumChannels.SEPARATE, SpectrumChannels.PHASE):
        assert bool((got[0, 1] == 0).all())


def test_window_fft_mag_refuses_what_it_cannot_take(cuda):
    big = make_spectrum_constant(axis_points=64, window_size=wfm.MAX_LONG_TRANSFORM_SIZE + 1, device=cuda)
    with pytest.raises(ValueError, match="longest row"):
        wfm.window_fft_mag(big, _frames((1, 2, big.window_size), seed=2, device=cuda))
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


def _valid_mask(t, valid):
    """``valid`` as a list: "random" is a seeded mask that drops about a
    third of the frames, "none" drops them all."""
    if valid == "random":
        return (np.random.default_rng(t).random(t) > 0.35).tolist()
    if valid == "none":
        return [False] * t
    return valid


@pytest.mark.parametrize(
    "t,valid",
    [
        (1, None),
        (1, [False]),
        (7, [True, False, True, True, False, False, True]),
        (127, "random"),  # a ragged last group of frames
        (128, None),
        (128, "none"),
        (300, "random"),  # more than one chunk of groups
    ],
    ids=["t1", "t1_invalid", "t7_mask", "t127_mask", "t128", "t128_none_valid", "t300_mask"],
)
@pytest.mark.parametrize("interp", INTERPS, ids=lambda i: i.name)
@pytest.mark.parametrize("mode", MAG_MODES, ids=lambda m: m.name)
def test_display_map_kernel_matches_plain(cuda, mode, interp, t, valid):
    """Kernel B vs the plain remap + decay loop + dB on the card. Bounds:
    display atol 1e-5, state rtol 1e-6 — the same operations, only the
    2- to 10-tap sum may round differently (fused multiply-adds). Lanczos
    taps have negative lobes, so that sum can cancel: its rounding error
    scales with the spectrum, not the result, and the state also gets an
    atol of 1e-6 of its largest value. On chunk-max and single-bin pixels
    the remapped value has no sum, and the kernel's split of the decay over
    groups of frames is exact: there the state equals the plain loop's bit
    for bit."""
    valid = _valid_mask(t, valid)
    c = make_spectrum_constant(
        axis_points=300, window_size=2048, configuration=mode, bin_interpolation=interp,
        view_scaling=ViewScaling.LOGARITHMIC, device=cuda,
    )
    mags, state = _mags_state(c, seed=int(mode) * 7 + int(interp) + t, t=t, pairs=3, device=cuda)
    s_kernel, s_plain = state.clone(), state.clone()
    before = counter("display_map.launches")
    got = dm.display_map(c, mags, s_kernel, valid)
    want = dm.display_map_plain(c, mags, s_plain, valid)
    torch.cuda.synchronize()
    assert counter("display_map.launches") == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    atol = 1e-6 * float(s_plain.abs().max()) if interp == BinInterpolation.LANCZOS else 0.0
    torch.testing.assert_close(s_kernel, s_plain, rtol=1e-6, atol=atol)
    exact = ~c.interp_mask
    assert bool(exact.any())
    assert torch.equal(s_kernel[..., exact], s_plain[..., exact])
    if valid is not None and not any(valid):
        assert torch.equal(s_kernel, state)


@pytest.mark.parametrize("t", [1, 40])
@pytest.mark.parametrize("graphs", [1, 8, 11])
def test_display_map_kernel_line_graph_counts(cuda, graphs, t):
    """One and eight line graphs (the most one launch takes) and eleven
    (two launches), with a zero pole among them (a decay time of 0: the
    state follows the input)."""
    c = make_spectrum_constant(
        axis_points=200, window_size=1024, configuration=SpectrumChannels.SEPARATE,
        view_scaling=ViewScaling.LOGARITHMIC, num_line_graphs=graphs,
        decay_seconds=(0.1, 0.0, 1.0), device=cuda,
    )
    mags, state = _mags_state(c, seed=graphs + t, t=t, pairs=2, device=cuda)
    s_kernel, s_plain = state.clone(), state.clone()
    valid = _valid_mask(t, "random") if t > 1 else None
    got = dm.display_map(c, mags, s_kernel, valid)
    want = dm.display_map_plain(c, mags, s_plain, valid)
    torch.cuda.synchronize()
    assert got.shape == (2, t, graphs, 2, 200)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(s_kernel, s_plain, rtol=1e-6, atol=0)
    exact = ~c.interp_mask
    assert torch.equal(s_kernel[..., exact], s_plain[..., exact])


def test_display_map_kernel_wide_chunks(cuda):
    """A 16384-point window over 64 linear pixels: every pixel is the max of
    a chunk of about 130 bins, and 32 neighbouring pixels span half the
    spectrum."""
    c = make_spectrum_constant(axis_points=64, window_size=16384, device=cuda)
    assert int(c.chunk_len.max()) > 100
    for t in (1, 128):
        mags, state = _mags_state(c, seed=t, t=t, pairs=2, device=cuda)
        s_kernel, s_plain = state.clone(), state.clone()
        got = dm.display_map(c, mags, s_kernel)
        want = dm.display_map_plain(c, mags, s_plain)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        exact = ~c.interp_mask
        assert torch.equal(s_kernel[..., exact], s_plain[..., exact])


def _spectrogram_map_constant(device):
    """The spectrogram's kernel B geometry: 16384 points, LEFT, LINEAR bins
    to a LOGARITHMIC 1024-px axis, 2 line graphs (0.1 s and 1 s)."""
    return make_spectrum_constant(
        axis_points=1024, window_size=16384, configuration=SpectrumChannels.LEFT,
        bin_interpolation=BinInterpolation.LINEAR, view_scaling=ViewScaling.LOGARITHMIC, device=device,
    )


def _assert_map_matches_plain(c, got, s_kernel, want, s_plain):
    """``test_display_map_kernel_matches_plain``'s bounds for LINEAR taps:
    display atol 1e-5, state rtol 1e-6, bit-equal on chunk-max and
    single-bin pixels."""
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(s_kernel, s_plain, rtol=1e-6, atol=0)
    exact = ~c.interp_mask
    assert bool(exact.any()) and torch.equal(s_kernel[..., exact], s_plain[..., exact])


@pytest.mark.parametrize("t,valid", [(512, None), (512, "random"), (509, "random"), (65, "random")],
                         ids=["t512", "t512_mask", "t509_mask", "t65_mask"])
def test_display_map_splits_t_across_a_cluster(cuda, monkeypatch, t, valid):
    """At the spectrogram's geometry (1 pair: 32 tiles of pixels on a card
    of 132 multiprocessors) the plan splits each tile's T across a cluster:
    one launch, counted by ``display_map.split_launches``. Against the
    plain path within the fused entry's bounds, and bit for bit, outputs
    and state, against the same call with the plan held to one block a
    tile (the unsplit kernel, which the split does not count)."""
    c = _spectrogram_map_constant(cuda)
    valid = _valid_mask(t, valid)
    mags, state = _mags_state(c, seed=t + (valid is None), t=t, pairs=1, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert dm.display_map_plan(1, t, c.num_line_graphs, 1, c.axis_points, sms) > 1
    s_split, s_one, s_plain = state.clone(), state.clone(), state.clone()
    launches, splits = counter("display_map.launches"), counter("display_map.split_launches")
    got = dm.display_map(c, mags, s_split, valid)
    assert (counter("display_map.launches") - launches, counter("display_map.split_launches") - splits) == (1, 1)
    with monkeypatch.context() as m:
        m.setattr(dm, "display_map_plan", lambda *args: 1)
        one = dm.display_map(c, mags, s_one, valid)
    assert (counter("display_map.launches") - launches, counter("display_map.split_launches") - splits) == (2, 1)
    want = dm.display_map_plain(c, mags, s_plain, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, one) and torch.equal(s_split, s_one)
    _assert_map_matches_plain(c, got, s_split, want, s_plain)


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
@pytest.mark.parametrize("t", [20, 130, 512])
def test_display_map_every_cluster_size_is_the_unsplit_kernel(cuda, monkeypatch, cluster, t):
    """Every cluster size the entry takes (above 8 a non-portable cluster),
    at spans of one or two frames a block (T = 20 over 16 blocks), of
    several chunks (T = 130 over 2) and of one chunk (T = 512 over 8), with
    a ragged mask, on 2 pairs of the spectrogram's geometry: bit for bit
    the unsplit kernel's outputs and state."""
    c = _spectrogram_map_constant(cuda)
    valid = _valid_mask(t, "random")
    mags, state = _mags_state(c, seed=100 * cluster + t, t=t, pairs=2, device=cuda)
    s_split, s_one = state.clone(), state.clone()
    with monkeypatch.context() as m:
        m.setattr(dm, "display_map_plan", lambda *args: cluster)
        got = dm.display_map(c, mags, s_split, valid)
        m.setattr(dm, "display_map_plan", lambda *args: 1)
        one = dm.display_map(c, mags, s_one, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, one) and torch.equal(s_split, s_one)
    if t == 512:
        s_plain = state.clone()
        _assert_map_matches_plain(c, got, s_split, dm.display_map_plain(c, mags, s_plain, valid), s_plain)


def test_display_map_headline_takes_one_block_a_tile(cuda):
    """At the headline geometry (16 pairs x 2 rows x 1024 px, T = 256) the
    tiles cover the card: one launch, no split."""
    c = make_spectrum_constant(
        axis_points=1024, window_size=4096, configuration=SpectrumChannels.SEPARATE,
        view_scaling=ViewScaling.LOGARITHMIC, device=cuda,
    )
    mags, state = _mags_state(c, seed=256, t=256, pairs=16, device=cuda)
    launches, splits = counter("display_map.launches"), counter("display_map.split_launches")
    got = dm.display_map(c, mags, state)
    torch.cuda.synchronize()
    assert (counter("display_map.launches") - launches, counter("display_map.split_launches") - splits) == (1, 0)
    assert got.shape == (16, 256, 2, 2, 1024) and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("frames_shape", [(1,), (7,), (3, 40), (2, 65), ()], ids=["b1", "b7", "b120", "b130", "no_lead"])
@pytest.mark.parametrize("interp", INTERPS, ids=lambda i: i.name)
@pytest.mark.parametrize("mode", [SpectrumChannels.LEFT, SpectrumChannels.SEPARATE, SpectrumChannels.COMPLEX], ids=lambda m: m.name)
def test_display_remap_entry_matches_plain(cuda, mode, interp, frames_shape):
    """Kernel B's remap entry vs ``inv_size * _remap_mag`` on the card:
    rtol 1e-6 with an atol of 1e-6 of the largest value for the tap sums
    (fused multiply-adds; Lanczos lobes cancel), and bit-equal on chunk-max
    and single-bin pixels, which have no sum. Leading axes of any shape,
    none included."""
    c = make_spectrum_constant(
        axis_points=300, window_size=2048, configuration=mode, bin_interpolation=interp,
        view_scaling=ViewScaling.LOGARITHMIC, device=cuda,
    )
    rng = np.random.default_rng(len(frames_shape) + int(interp))
    shape = frames_shape + (c.state_channels, c.n_spectrum_values)
    mags = torch.from_numpy((np.abs(rng.standard_normal(shape)) * 40.0).astype(np.float32)).to(cuda)
    before = counter("display_map.remap_launches")
    got = dm.display_remap(c, mags)
    want = dm.display_remap_plain(c, mags)
    torch.cuda.synchronize()
    assert counter("display_map.remap_launches") == before + 1 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    exact = ~c.interp_mask
    assert bool(exact.any()) and torch.equal(got[..., exact], want[..., exact])


@pytest.mark.parametrize(
    "t,valid",
    [(1, None), (1, [False]), (7, "random"), (127, "random"), (128, None), (128, "none"), (300, "random")],
    ids=["t1", "t1_invalid", "t7_mask", "t127_mask", "t128", "t128_none_valid", "t300_mask"],
)
@pytest.mark.parametrize("graphs", [1, 2, 8])
def test_display_decay_db_entry_matches_plain(cuda, graphs, t, valid):
    """Kernel B's decay-and-dB entry vs ``decay_db`` on the card: no sum
    anywhere, and the split of the decay over groups of frames is exact, so
    the state equals the sequential loop's bit for bit on every pixel;
    display atol 1e-5 (the log)."""
    valid = _valid_mask(t, valid)
    c = make_spectrum_constant(
        axis_points=300, window_size=1024, configuration=SpectrumChannels.SEPARATE,
        view_scaling=ViewScaling.LOGARITHMIC, num_line_graphs=graphs, decay_seconds=(0.1, 0.0, 1.0),
        slope_a=0.5, device=cuda,
    )
    rng = np.random.default_rng(t + graphs)
    vals = torch.from_numpy((np.abs(rng.standard_normal((3, t, 2, 300))) * 0.3).astype(np.float32)).to(cuda)
    vals[:, :, :, ::17] = 0.0  # exact zeros read clip_db until a peak arrives
    state = torch.from_numpy((rng.random((3, graphs, 2, 300)) * 0.5).astype(np.float32)).to(cuda)
    state[:, :, :, ::17] = 0.0
    s_kernel, s_plain = state.clone(), state.clone()
    before = counter("display_map.decay_db_launches")
    got = dm.display_decay_db(c, s_kernel, vals, valid)
    want = dm.decay_db(c, s_plain, vals, valid)
    torch.cuda.synchronize()
    assert counter("display_map.decay_db_launches") == before + 1 and got.shape == (3, t, graphs, 2, 300)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(s_kernel, s_plain)
    if valid is not None and not any(valid):
        assert torch.equal(s_kernel, state)


@pytest.mark.parametrize("p", [1024, 300, 128, 5])
@pytest.mark.parametrize(
    "pairs,t,rows,valid",
    [(1, 512, 1, "cfg4"), (2, 130, 2, "random"), (1, 9, 1, None), (3, 5, 2, "random"), (1, 64, 1, "none")],
    ids=["cfg4", "t130_mask", "t9", "t5_mask", "t64_none_valid"],
)
@pytest.mark.parametrize("graphs", [2, 8])
def test_display_decay_db_kernel_across_chunks(cuda, graphs, pairs, t, rows, valid, p):
    """The decay-and-dB kernel where the grid splits T into chunks (few
    pairs and rows: a first launch writes each chunk's end values) and
    where it does not, 16-byte accesses (P % 4 == 0) and the scalar form
    (P = 300 is one, P = 5 a ragged tail): the state bit-equal to
    ``decay_db`` and display atol 1e-5."""
    if valid == "cfg4":
        valid = [True] * (t - 3) + [False] * 3
    valid = _valid_mask(t, valid)
    c = make_spectrum_constant(
        axis_points=p, window_size=1024, configuration=SpectrumChannels.LEFT if rows == 1 else SpectrumChannels.SEPARATE,
        view_scaling=ViewScaling.LOGARITHMIC, num_line_graphs=graphs, decay_seconds=(0.1, 0.0, 1.0), device=cuda,
    )
    rng = np.random.default_rng(t * 10 + p)
    vals = torch.from_numpy((np.abs(rng.standard_normal((pairs, t, rows, p))) * 0.3).astype(np.float32)).to(cuda)
    vals[..., ::7] = 0.0
    state = torch.from_numpy((rng.random((pairs, graphs, rows, p)) * 0.5).astype(np.float32)).to(cuda)
    s_kernel, s_plain = state.clone(), state.clone()
    before = counter("display_map.decay_db_launches")
    got = dm.display_decay_db(c, s_kernel, vals, valid)
    want = dm.decay_db(c, s_plain, vals, valid)
    torch.cuda.synchronize()
    assert counter("display_map.decay_db_launches") == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(s_kernel, s_plain)
    if valid is not None and not any(valid):
        assert torch.equal(s_kernel, state)


def test_display_decay_db_kernel_takes_a_misaligned_view(cuda):
    """Values that start 4 bytes past a 16-byte edge take the scalar form
    and give what an aligned copy gives, bit for bit."""
    c = make_spectrum_constant(axis_points=256, window_size=1024, configuration=SpectrumChannels.SEPARATE, device=cuda)
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(np.abs(rng.standard_normal(1 + 2 * 40 * 2 * 256)).astype(np.float32)).to(cuda)
    vals = flat[1:].view(2, 40, 2, 256)
    assert vals.data_ptr() % 16 == 4 and vals.is_contiguous()
    state = torch.from_numpy((rng.random((2, 2, 2, 256)) * 0.5).astype(np.float32)).to(cuda)
    s_view, s_copy = state.clone(), state.clone()
    got = dm.display_decay_db(c, s_view, vals)
    want = dm.display_decay_db(c, s_copy, vals.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(s_view, s_copy)


def test_remap_then_decay_db_equals_the_fused_entry(cuda):
    """The two halves in turn give what the fused entry gives in one
    launch: the same remap code feeds the same decay, so state and display
    are equal bit for bit."""
    c = make_spectrum_constant(
        axis_points=300, window_size=2048, configuration=SpectrumChannels.SEPARATE,
        bin_interpolation=BinInterpolation.LANCZOS, view_scaling=ViewScaling.LOGARITHMIC, device=cuda,
    )
    for t in (1, 5, 130):
        mags, state = _mags_state(c, seed=t, t=t, pairs=3, device=cuda)
        valid = _valid_mask(t, "random") if t > 1 else None
        s_fused, s_halves = state.clone(), state.clone()
        fused = dm.display_map(c, mags, s_fused, valid)
        halves = dm.display_decay_db(c, s_halves, dm.display_remap(c, mags), valid)
        torch.cuda.synchronize()
        assert torch.equal(fused, halves) and torch.equal(s_fused, s_halves)


def test_new_entries_refuse_what_they_cannot_take(cuda):
    c = make_spectrum_constant(axis_points=64, window_size=256, configuration=SpectrumChannels.SEPARATE, device=cuda)
    mags = torch.zeros((2, 3, 2, c.n_spectrum_values), device=cuda)
    vals = torch.zeros((2, 3, 2, 64), device=cuda)
    state = torch.zeros((2, 2, 2, 64), device=cuda)
    with pytest.raises(ValueError):
        dm.display_remap(c, mags[..., :-1])
    with pytest.raises(ValueError, match="contiguous"):
        dm.display_remap(c, mags.transpose(0, 1))
    with pytest.raises(TypeError):
        dm.display_remap(c, mags.double())
    with pytest.raises(ValueError, match="state"):
        dm.display_decay_db(c, state[:1], vals)
    with pytest.raises(ValueError, match="valid"):
        dm.display_decay_db(c, state, vals, [True])
    with pytest.raises(ValueError, match="one device"):
        dm.display_decay_db(c.to("cpu"), state, vals)
    assert dm.display_remap(c, mags[:0]).shape == (0, 3, 2, 64)


@pytest.mark.parametrize("mode", MAG_MODES, ids=lambda m: m.name)
def test_spectrum_values_and_post_process_on_cuda(cuda, mode):
    """Off the CPU the two halves of the magnitude tail launch kernel A,
    kernel B's remap entry and its decay-and-dB entry (the counters show
    it) and agree with the plain functions on the same tensors."""
    c = make_spectrum_constant(
        axis_points=128, window_size=1024, configuration=mode, view_scaling=ViewScaling.LOGARITHMIC, device=cuda,
    )
    frames = _frames((2, 5, 2, 1024), seed=int(mode), device=cuda)
    a0, r0 = counter("window_fft_mag.launches"), counter("display_map.remap_launches")
    d0, f0 = counter("display_map.decay_db_launches"), counter("display_map.launches")
    vals = spectrum_values(c, frames)
    state = init_line_graph_state(c, (2,))
    valid = [True, True, False, True, True]
    got = post_process(c, state, vals, valid=valid)
    plain_vals = dm.display_remap_plain(c, wfm.window_fft_mag_plain(c, frames))
    plain_state = torch.zeros_like(state.magnitude)
    want = dm.decay_db(c, plain_state, plain_vals, valid)
    torch.cuda.synchronize()
    assert (counter("window_fft_mag.launches") - a0, counter("display_map.remap_launches") - r0,
            counter("display_map.decay_db_launches") - d0, counter("display_map.launches") - f0) == (1, 1, 1, 0)
    assert got.state is state
    torch.testing.assert_close(vals, plain_vals, rtol=1e-5, atol=1e-6 * float(plain_vals.abs().max()))
    torch.testing.assert_close(got.results, want, rtol=0, atol=2e-4)
    torch.testing.assert_close(state.magnitude, plain_state, rtol=1e-5, atol=1e-9)


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
    a0, b0 = counter("window_fft_mag.launches"), counter("display_map.launches")
    got = analyze_frames(c, state, frames).results
    want = dm.display_map_plain(c, wfm.window_fft_mag_plain(c, frames), plain_state)
    torch.cuda.synchronize()
    assert (counter("window_fft_mag.launches") - a0, counter("display_map.launches") - b0) == (1, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)
    torch.testing.assert_close(state.magnitude, plain_state, rtol=1e-5, atol=1e-9)


def test_complex_mode_on_cuda_feeds_one_row_to_both_state_rows(cuda):
    """COMPLEX has one magnitude row and two state rows: the wrappers repeat
    the row, as the plain versions broadcast it."""
    c = make_spectrum_constant(axis_points=128, window_size=512, configuration=SpectrumChannels.COMPLEX, device=cuda)
    frames = _frames((2, 5, 2, 512), seed=8, device=cuda)
    state = init_line_graph_state(c, (2,))
    plain_state = state.magnitude.clone()
    got = analyze_frames(c, state, frames).results
    want = dm.display_map_plain(c, wfm.window_fft_mag_plain(c, frames), plain_state)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, 5, 2, 2, 128)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)
    assert torch.equal(got[..., 0, :], got[..., 1, :])
    torch.testing.assert_close(state.magnitude, plain_state, rtol=1e-5, atol=1e-9)


def test_phase_on_cuda_feeds_kernel_a_complex_output(cuda):
    """PHASE on the card: kernel A's complex output feeds the PHASE values
    kernel (one launch, no display kernel) and kernel G; against the CPU's
    plain path the mid row's dB within 1e-4, the values' mid within 1e-4 and
    their cancellation row in linear units at atol 2e-3 (ROADMAP's caveat:
    another FFT moves it by ~1e-6 and its dB can swing to clip_db)."""
    c = make_spectrum_constant(axis_points=128, window_size=1024, configuration=SpectrumChannels.PHASE, device=cuda)
    frames = _frames((2, 3, 2, 1024), seed=6, device=cuda)
    a0, b0 = counter("window_fft_mag.launches"), counter("display_map.launches")
    v0 = counter("phase_values.launches")
    out = analyze_frames(c, init_line_graph_state(c, (2,)), frames).results
    assert (counter("window_fft_mag.launches") - a0, counter("display_map.launches") - b0) == (1, 0)
    assert counter("phase_values.launches") == v0 + 1
    cpu = c.to("cpu")
    want = analyze_frames(cpu, init_line_graph_state(cpu, (2,)), frames.cpu()).results
    torch.testing.assert_close(out[..., 0, :].cpu(), want[..., 0, :], rtol=1e-4, atol=1e-4)
    vals = spectrum_values(c, frames).cpu()
    want_vals = spectrum_values(cpu, frames.cpu())
    assert vals.shape == want_vals.shape == (2, 3, 2, 128)
    torch.testing.assert_close(vals[..., 0, :], want_vals[..., 0, :], rtol=1e-4, atol=1e-4 * float(want_vals.abs().max()))
    torch.testing.assert_close(vals[..., 1, :], want_vals[..., 1, :], rtol=0, atol=2e-3)


# the PHASE values kernel's cases: (window, pairs, T), the sizes of kernel
# A's three forms (4096 one block a row, 65536 a cluster, 2^21 two passes)
# and the spectrogram's 16384; on the LOGARITHMIC axis of 1024 px the
# kernel walks a chunk with 1, 2, 8 and 32 lanes at these sizes
PHASE_VALUE_SHAPES = [(4096, 16, 128), (4096, 1, 1), (4096, 16, 1), (4096, 1, 128), (16384, 1, 512),
                      (65536, 16, 1), (65536, 1, 128), (1 << 21, 1, 1), (1 << 21, 2, 3)]


def _assert_phase_values_match(c, got, want):
    """The kernel against the plain path on the card: bit for bit where the
    plain path sums its taps in tap order (1 and 2 taps) and on every
    bin-max pixel (no sum); a 10-tap Lanczos sum, which torch takes in its
    own order, within 1e-6 of the row's largest (mid) and 1e-5 (the
    cancellation, a ratio of two such sums)."""
    assert got.shape == want.shape
    exact = ~c.interp_mask if c.interp_taps > 2 else torch.ones_like(c.interp_mask)
    torch.testing.assert_close(got[..., exact], want[..., exact], rtol=0, atol=0, equal_nan=True)
    if c.interp_taps > 2:
        lanczos = c.interp_mask
        torch.testing.assert_close(got[..., 0, lanczos], want[..., 0, lanczos], rtol=1e-6,
                                   atol=1e-6 * float(want[..., 0, :].abs().max()))
        torch.testing.assert_close(got[..., 1, lanczos], want[..., 1, lanczos], rtol=0, atol=1e-5)


@pytest.mark.parametrize("window,pairs,t", PHASE_VALUE_SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("interp", INTERPS, ids=lambda i: i.name)
def test_phase_values_kernel_matches_plain(cuda, interp, window, pairs, t):
    """The PHASE values kernel (1, 2 and 10 taps; T = 1 and 128; 1 and 16
    pairs; kernel A's three forms' sizes, so 1, 2, 8 and 32 lanes a pixel)
    against ``phase_values_plain`` on the same CUDA spectra, with exact ties
    planted in every chunk, a silent frame and a silent right channel; one
    launch a call."""
    c = make_spectrum_constant(axis_points=1024, window_size=window, configuration=SpectrumChannels.PHASE,
                               bin_interpolation=interp, view_scaling=ViewScaling.LOGARITHMIC, device=cuda)
    spec = phase_spectra(c, pairs * t, seed=window % 89 + pairs + t, plant=True)
    spec = spec.reshape(pairs, t, 2, c.n_spectrum_values).to(cuda)
    before = counter("phase_values.launches")
    got = pv.phase_values(c, spec)
    want = phase_values_plain(c, spec)
    torch.cuda.synchronize()
    assert counter("phase_values.launches") == before + 1 and got.shape == (pairs, t, 2, 1024)
    _assert_phase_values_match(c, got, want)
    if pairs * t > 2:
        flat = got.reshape(-1, 2, 1024)
        assert bool((flat[1, 0] == 0).all() and (flat[1, 1] == 1).all() and (flat[2, 1] == 0).all())


@pytest.mark.parametrize("window", [4096, 65536, 1 << 21])
def test_phase_values_kernel_ties_single_bins_nan_and_silence(cuda, window):
    """Planted single-bin pixels, a frame whose bins all tie (each pixel
    takes its chunk's first bin), a NaN in a chunk (the first NaN wins, as
    torch's argmax has it: mid NaN, cancellation 1), a silent frame (mid 0,
    cancellation 1): the kernel against the plain path bit for bit, LINEAR
    axis and taps; at 4096 points (chunks to 9 bins: a lane walks a
    pixel's), 65536 (to 129: 8 lanes) and 2^21 (to 4113: a warp's 32)."""
    import dataclasses

    c = make_spectrum_constant(axis_points=256, window_size=window, configuration=SpectrumChannels.PHASE,
                               view_scaling=ViewScaling.LINEAR, device=cuda)
    single, single_bin = c.single_mask.clone(), c.single_bin.clone()
    single[5::7] = True
    single_bin[5::7] = torch.arange(5, 256, 7, dtype=torch.int32, device=cuda) * 3 + 1
    c = dataclasses.replace(c, single_mask=single, single_bin=single_bin)
    spec = phase_spectra(c, 6, seed=12, plant=True)
    spec[3] = torch.complex(torch.tensor(0.75), torch.tensor(-0.5))
    lo, ln = c.chunk_lo.cpu(), c.chunk_len.cpu()
    x = int(torch.nonzero(~single.cpu() & (ln >= 3))[4])
    spec[4, 0, int(lo[x]) + 1] = complex(float("nan"), 0.0)
    spec[4, 1, int(lo[x]) + 2] = complex(float("nan"), 1.0)
    spec = spec.to(cuda)
    got = pv.phase_values(c, spec)
    want = phase_values_plain(c, spec)
    torch.cuda.synchronize()
    _assert_phase_values_match(c, got, want)
    assert bool(torch.isnan(got[4, 0, x])) and float(got[4, 1, x]) == 1.0  # mid NaN, not > 0: cancellation 1
    assert bool((got[1, 0] == 0).all() and (got[1, 1] == 1).all())


def test_phase_values_refuses_what_it_cannot_take(cuda):
    c = make_spectrum_constant(axis_points=64, window_size=256, configuration=SpectrumChannels.PHASE, device=cuda)
    nv = c.n_spectrum_values
    spec = torch.zeros((3, 2, nv), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="complex64"):
        pv.phase_values(c, spec.real.contiguous())
    with pytest.raises(ValueError, match="complex64"):
        pv.phase_values(c, torch.zeros((3, 2, nv + 1), dtype=torch.complex64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        pv.phase_values(c, torch.zeros((2, 3, nv), dtype=torch.complex64, device=cuda).transpose(0, 1))
    with pytest.raises(ValueError, match="constant"):
        pv.phase_values(c.to("cpu"), spec)
    assert pv.phase_values(c, spec[:0]).shape == (0, 2, 64)


# the clip range of each resample kind (kernels/oscilloscope.py), by a
CLIP = {
    "lanczos": lambda a, w: (-(a + 1.0), w - 1.0 + a),
    "linear": lambda a, w: (-2.0, float(w)),
    "nearest": lambda a, w: (-1.0, float(w)),
}


def _resample_inputs(kind, a, p, step, rows, seed, device, w=16384):
    """x [3, rows, w] and pos [3, p]: one pair inside the frame, one
    hanging off its left edge, one off its right edge, each at the
    f32 positions start + k * step, clipped as the callers clip them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, rows, w)) * 0.4).astype(np.float32)
    lo, hi = CLIP[kind](a, w)
    span = step * (p - 1)
    starts = [rng.uniform(0.0, max(w - 1.0 - span, 1.0)) + 0.3137, lo - 3.3, hi - span / 2 + 0.21]
    k = np.arange(p, dtype=np.float64)
    pos = np.stack([np.float32(s) + k * np.float32(step) for s in starts]).astype(np.float32)
    pos = np.clip(pos, lo, hi).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(pos).to(device)


@pytest.mark.parametrize("p", [8192, 160])
@pytest.mark.parametrize("with_nearest", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("a", [10, 5, 1, 16])
@pytest.mark.parametrize("kind", ["lanczos", "linear", "nearest"])
def test_banded_resample_kernel_matches_plain(cuda, kind, a, with_nearest, p):
    """Kernel C vs its plain version over steps 0.125 to 128, inside the
    frame and off both edges; a = 10 is the unrolled form, 5, 1 and 16 the
    run-time one. Bound: atol 1e-5 x max|x| for Lanczos and linear (weights
    within 5e-7 of the plain ones, summed with fused multiply-adds in tap
    order); nearest and the dual output's pick exactly equal."""
    for i, step in enumerate([0.125, 0.8, 1.0, 16.0, 128.0]):
        x, pos = _resample_inputs(kind, a, p, step, rows=2, seed=i + 10 * a + p, device=cuda)
        before = counter("banded_resample.launches")
        got = br.banded_resample(x, pos, a=a, kind=kind, with_nearest=with_nearest)
        want = br.banded_resample_plain(x, pos, a=a, kind=kind, with_nearest=with_nearest)
        torch.cuda.synchronize()
        assert counter("banded_resample.launches") == before + 1
        if with_nearest:
            assert torch.equal(got[1], want[1]), step
            got, want = got[0], want[0]
        assert got.shape == (3, 2, p)
        if kind == "nearest":
            assert torch.equal(got, want), step
        else:
            atol = 1e-5 * float(x.abs().max())
            torch.testing.assert_close(got, want, rtol=0, atol=atol, msg=f"step {step}")


def _near_sample_positions(w, device):
    """pos [2, P]: about samples inside the row and at both of its ends,
    exactly on them, within 1e-6 either side, around the 1e-6 switch of the
    centre weight, on the half sample and a hair either side of it."""
    base = np.array([0.0, 1.0, 7.0, w // 3, w / 2.0, w - 2.0, w - 1.0])
    off = np.array([0.0, 1e-7, -1e-7, 5e-7, -5e-7, 9e-7, -9e-7, 1.1e-6, -1.1e-6, 1e-5, -1e-5,
                    0.5, 0.5 - 1e-7, 0.5 + 1e-7, -0.5, 0.25])
    pos = (base[:, None] + off[None, :]).astype(np.float32).reshape(-1)
    return torch.from_numpy(np.stack([pos, pos[::-1].copy()])).to(device)


@pytest.mark.parametrize("a", [5, 10, 16])
@pytest.mark.parametrize("w", [64, 4096])
def test_banded_resample_kernel_near_and_on_samples(cuda, a, w):
    """Positions on samples, within 1e-6 of them from both sides and on the
    half sample (where the nearest sample, and with it the kernel's
    rotation, changes), at both ends of the row: Lanczos and linear within
    1e-5 x max|x|, a position on a sample returns that sample exactly,
    nearest and the nearest pick equal."""
    rng = np.random.default_rng(a + w)
    x = torch.from_numpy((rng.standard_normal((2, 3, w)) * 0.4).astype(np.float32)).to(cuda)
    pos = _near_sample_positions(w, cuda)
    atol = 1e-5 * float(x.abs().max())
    got, near = br.banded_resample(x, pos, a=a, kind="lanczos", with_nearest=True)
    want, want_near = br.banded_resample_plain(x, pos, a=a, kind="lanczos", with_nearest=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert torch.equal(near, want_near)
    on = pos == torch.floor(pos)
    picked = torch.gather(x, -1, pos.long()[:, None, :].expand(2, 3, -1))
    assert torch.equal(got[on[:, None, :].expand_as(got)], picked[on[:, None, :].expand_as(got)])
    torch.testing.assert_close(br.banded_resample(x, pos, a=1, kind="linear"),
                               br.banded_resample_plain(x, pos, a=1, kind="linear"), rtol=0, atol=atol)
    assert torch.equal(br.banded_resample(x, pos, a=1, kind="nearest"),
                       br.banded_resample_plain(x, pos, a=1, kind="nearest"))


@pytest.mark.parametrize("kind,a", [("lanczos", 10), ("lanczos", 16), ("linear", 1), ("nearest", 1)])
def test_banded_resample_kernel_one_pixel(cuda, kind, a):
    """P = 1: one live thread in the one block of each pair."""
    x, pos = _resample_inputs(kind, a, 1, 1.0, rows=2, seed=a, device=cuda)
    got = br.banded_resample(x, pos, a=a, kind=kind, with_nearest=True)
    want = br.banded_resample_plain(x, pos, a=a, kind=kind, with_nearest=True)
    torch.cuda.synchronize()
    assert got[0].shape == (3, 2, 1)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0.0 if kind == "nearest" else 1e-5 * float(x.abs().max()))
    assert torch.equal(got[1], want[1])


def _affine_inputs(kind, a, p, step, where, seed, device, w=16384, pairs=4):
    """x [pairs, 2, w], start [pairs] and the kind's clip range: every pair
    inside the frame, or even pairs starting off the left edge and odd
    pairs running off the right one."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((pairs, 2, w)) * 0.4).astype(np.float32)
    lo, hi = CLIP[kind](a, w)
    span = step * (p - 1)
    if where == "inside":
        start = rng.uniform(0.0, w - 1.0 - span, pairs) + 0.3137
    else:
        start = np.where(np.arange(pairs) % 2 == 0, lo - 2.7, hi - span / 2 + 0.21)
    return torch.from_numpy(x).to(device), torch.from_numpy(start.astype(np.float32)).to(device), lo, hi


@pytest.mark.parametrize("step_form", ["host", "tensor"])
@pytest.mark.parametrize(
    "p,step,where",
    [(8192, 1023 / 8191, "inside"), (8192, 1023 / 8191, "edges"), (1024, 16383 / 1023, "inside"), (160, 0.8, "edges")],
    ids=["cfg3", "edges", "zoom_out", "tail_p160"],
)
@pytest.mark.parametrize("kind,a", [("lanczos", 10), ("lanczos", 5), ("linear", 1), ("nearest", 1)])
def test_banded_resample_affine_entry_matches_the_pos_entry(cuda, kind, a, p, step, where, step_form):
    """The kernel forming ``clamp(fma(p, step, start), lo, hi)`` itself
    (a host step; a step tensor takes the ``pos`` entry at
    ``affine_positions``' tensor) against the same kernel at that tensor:
    nearest and the nearest pick bit-equal, Lanczos and linear within 1e-6 x
    max|x| (the positions are the same f32 values but for a rare
    double-rounding tie, one ulp of position); one launch either way; and
    against the plain version at the usual bound."""
    x, start, lo, hi = _affine_inputs(kind, a, p, step, where, seed=p + a, device=cuda)
    step32 = float(np.float32(step))
    step_arg = step32 if step_form == "host" else torch.full((x.shape[0],), step32, device=cuda)
    before = counter("banded_resample.launches")
    got = br.banded_resample_affine(x, start, step_arg, p, lo, hi, a=a, kind=kind, with_nearest=True)
    assert counter("banded_resample.launches") == before + 1
    pos = br.affine_positions(x, start, step_arg, p, lo, hi)
    same = br.banded_resample(x, pos, a=a, kind=kind, with_nearest=True)
    want = br.banded_resample_plain(x, pos, a=a, kind=kind, with_nearest=True)
    torch.cuda.synchronize()
    scale = float(x.abs().max())
    assert got[0].shape == (x.shape[0], 2, p)
    assert torch.equal(got[1], same[1]) and torch.equal(got[1], want[1])
    if kind == "nearest":
        assert torch.equal(got[0], same[0]) and torch.equal(got[0], want[0])
    else:
        torch.testing.assert_close(got[0], same[0], rtol=0, atol=1e-6 * scale)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5 * scale)


def test_resample_functions_on_cuda_form_positions_in_the_kernel(cuda):
    """The oscilloscope's resample functions with per-pair starts launch
    kernel C once each, through the affine entry (no position tensor), and
    agree with the ``pos`` entry route an unshared start takes."""
    x, start, _, _ = _affine_inputs("lanczos", 10, 2048, 0.5, "inside", seed=8, device=cuda)
    own = start[:, None].expand(-1, 2).contiguous()
    for fn, extra in ((tk.sinc_resample, (10,)), (tk.linear_resample, ()), (tk.nearest_resample, ())):
        before = counter("banded_resample.launches")
        shared = fn(x, start[:, None], 0.5, 2048, *extra)
        unshared = fn(x, own, 0.5, 2048, *extra)
        assert counter("banded_resample.launches") == before + 2
        assert shared.shape == unshared.shape == (4, 2, 2048)
        torch.testing.assert_close(shared, unshared, rtol=0, atol=1e-6 * float(x.abs().max()))


def test_banded_resample_kernel_colour_track_rows(cuda):
    """Six rows (the colour track's rgb x 2 rows) at 1:1 nearest and at the
    8x Lanczos upsample: exact and within 1e-5 x max|x|."""
    x, pos = _resample_inputs("nearest", 1, 1024, 1.0, rows=6, seed=3, device=cuda)
    assert torch.equal(br.banded_resample(x, pos, a=1, kind="nearest"),
                       br.banded_resample_plain(x, pos, a=1, kind="nearest"))
    x, pos = _resample_inputs("lanczos", 10, 8192, 1023 / 8191, rows=6, seed=4, device=cuda)
    torch.testing.assert_close(br.banded_resample(x, pos, a=10, kind="lanczos"),
                               br.banded_resample_plain(x, pos, a=10, kind="lanczos"),
                               rtol=0, atol=1e-5 * float(x.abs().max()))


def test_banded_resample_refuses_what_it_cannot_take(cuda):
    x, pos = _resample_inputs("lanczos", 10, 256, 1.0, rows=2, seed=5, device=cuda)
    with pytest.raises(ValueError, match="outside"):
        br.banded_resample(x, pos, a=17, kind="lanczos")
    with pytest.raises(TypeError):
        br.banded_resample(x.double(), pos, a=10, kind="lanczos")
    with pytest.raises(ValueError, match="contiguous"):
        br.banded_resample(x[..., ::2], pos, a=10, kind="lanczos")
    with pytest.raises(ValueError, match="on"):
        br.banded_resample(x, pos.cpu(), a=10, kind="lanczos")
    start = pos[:, 0].contiguous()
    with pytest.raises(ValueError, match=r"start must be \[B\]"):
        br.banded_resample_affine(x, start[:2], 1.0, 256, -11.0, 16393.0, a=10, kind="lanczos")
    with pytest.raises(TypeError, match="step must be float32"):
        br.banded_resample_affine(x, start, start.double(), 256, -11.0, 16393.0, a=10, kind="lanczos")
    with pytest.raises(ValueError, match="on"):
        br.banded_resample_affine(x, start.cpu(), 1.0, 256, -11.0, 16393.0, a=10, kind="lanczos")
    before = counter("banded_resample.launches")
    empty = br.banded_resample_affine(x, start, 1.0, 0, -11.0, 16393.0, a=10, kind="lanczos")
    assert empty.shape == (3, 2, 0) and counter("banded_resample.launches") == before


@contextlib.contextmanager
def _plain_resample():
    """Route the oscilloscope functions' resamples to kernel C's plain
    version on the same tensors (the plain path to compare against)."""
    kernels = tk.banded_resample, tk.banded_resample_affine
    tk.banded_resample, tk.banded_resample_affine = br.banded_resample_plain, br.banded_resample_affine_plain
    try:
        yield
    finally:
        tk.banded_resample, tk.banded_resample_affine = kernels


def _osc_history(pairs, h, seed):
    rng = np.random.default_rng(seed)
    n = np.arange(h)
    x = np.zeros((pairs, 2, h), np.float32)
    for p in range(pairs - 1):  # the last pair stays silent
        f = 173.1 * (p + 1)
        for c in range(2):
            x[p, c] = 0.5 * np.sin(2 * np.pi * f * n / 96_000.0 + 0.4 * c) + 0.003 * rng.standard_normal(h)
    return x


@pytest.mark.parametrize(
    "trigger,interp,colour",
    [
        (tv.TriggerMode.ZERO_CROSSING, tv.SubSampleInterpolation.LANCZOS, False),
        (tv.TriggerMode.SPECTRAL, tv.SubSampleInterpolation.LANCZOS, True),
        (tv.TriggerMode.ENVELOPE_HOLD, tv.SubSampleInterpolation.LINEAR, False),
        (tv.TriggerMode.NONE, tv.SubSampleInterpolation.NONE, False),
    ],
    ids=["zero_crossing", "spectral_colour", "envelope_hold", "none"],
)
def test_oscilloscope_processor_on_cuda_matches_the_plain_path(cuda, trigger, interp, colour):
    """OscilloscopeProcessor on the card, three calls, against the same
    processor with its resamples on kernel C's plain version, each call
    from the same carried state: triggers and fundamentals equal, waves
    within 1e-5 x max|x| x gain, envelopes and colours equal; kernel C
    launched once per resample (a 1024-sample window over 2048 px takes
    the Lanczos pass with the envelope pick fused in). With the colour
    track, kernel E launched once a call, and the colours within 1e-3 of
    the same step with the colour track's plain version."""
    kw = dict(
        pairs=4, sample_rate=96_000.0, channel_mode=OscChannels.SEPARATE, trigger_mode=trigger,
        interpolation=interp, window_samples=1024.0, pixels=2048, lookahead=4096,
        trigger_threshold=0.1, autogain=tv.AutoGain.PEAK_DECAY, colour_enabled=colour,
    )
    proc = tv.OscilloscopeProcessor.create(device=cuda, **kw)
    plain = tv.OscilloscopeProcessor.create(device=cuda, **kw)
    hist = torch.from_numpy(_osc_history(4, 8192 + 2 * 800, seed=int(trigger))).to(cuda)
    # one dual-output Lanczos pass (wave and envelope pick); otherwise the
    # wave and the envelope pick apart; plus the colour track's pick
    per_call = (1 if interp == tv.SubSampleInterpolation.LANCZOS else 2) + int(colour)
    # the colour track's plain version (the doubling scans) on the card, with
    # kernel C's plain resamples: the colours within 1e-3
    plain_track = tv.OscilloscopeProcessor.create(device=cuda, **kw)
    for i in range(3):
        h = hist[..., i * 800 : i * 800 + 8192].contiguous()
        plain.state = proc.state
        plain_track.state = proc.state
        before, colour_before = counter("banded_resample.launches"), counter("colour_track.launches")
        got = proc.process(h, new_samples=800)
        assert counter("banded_resample.launches") - before == per_call
        # kernel E once a call, then kernel C's pick
        assert counter("colour_track.launches") - colour_before == int(colour)
        if colour:
            tv.colour_track = ct.colour_track_plain
            try:
                with _plain_resample():
                    want_track = plain_track.process(h, new_samples=800)
            finally:
                tv.colour_track = ct.colour_track
            assert counter("colour_track.launches") - colour_before == 1
            torch.testing.assert_close(got.colours, want_track.colours, rtol=0, atol=1e-3)
        with _plain_resample():
            want = plain.process(h, new_samples=800)
        torch.cuda.synchronize()
        assert torch.equal(got.trigger_found, want.trigger_found)
        assert torch.equal(got.fundamental, want.fundamental)
        assert torch.equal(got.gain, want.gain)
        atol = 1e-5 * float(h.abs().max()) * float(got.gain.max())
        torch.testing.assert_close(got.waveform, want.waveform, rtol=0, atol=atol)
        assert torch.equal(got.envelope_min, want.envelope_min)
        assert torch.equal(got.envelope_max, want.envelope_max)
        assert torch.equal(got.colours, want.colours)
        assert torch.isfinite(got.waveform).all()
        assert (got.waveform[-1] == 0).all()


def test_vectorscope_processor_on_cuda_matches_the_cpu(cuda):
    """VectorscopeProcessor on the card against itself on the CPU, three
    calls with new_samples and a meter slice: vertices 2e-6 x gain, bars
    2e-6, states 1e-5 relative (the block sums run in another order)."""
    from signalizer_tpu_torch.views import vectorscope as vs

    rng = np.random.default_rng(40)
    stream = (rng.standard_normal((4, 2, 3000)) * 0.3).astype(np.float32)
    stream[3] = 0.0
    for mode in vs.OperationalMode:
        for gain in vs.AutoGain:
            kw = dict(pairs=4, mode=mode, autogain=gain, stereo_window=0.002, rotation=0.1)
            on_card, on_cpu = vs.VectorscopeProcessor(device=cuda, **kw), vs.VectorscopeProcessor(device="cpu", **kw)
            for i in range(3):
                x = stream[..., i * 400 : i * 400 + 2048]
                kwargs = dict(new_samples=400, meter_frames=x[..., -512:]) if i else {}
                got, want = on_card.process(x, **kwargs), on_cpu.process(x, **kwargs)
                assert got.vertices.device.type == "cuda"
                g = float(want.gain.max())
                torch.testing.assert_close(got.vertices.cpu(), want.vertices, rtol=1e-5, atol=2e-6 * max(g, 1.0))
                torch.testing.assert_close(got.balance.cpu(), want.balance, rtol=0, atol=2e-6)
                torch.testing.assert_close(got.correlation_bars.cpu(), want.correlation_bars, rtol=0, atol=2e-6)
                torch.testing.assert_close(got.gain.cpu(), want.gain, rtol=1e-5, atol=0)
            for a, b in zip(on_card.state, on_cpu.state):
                torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-7)


def test_spectrogram_processor_on_cuda(cuda):
    """SpectrogramProcessor on the card: both ingest routes emit the same
    bytes, kernels A and B launch once per upload unit, and the columns
    agree with the CPU's by the byte rule (within 1 LSB, at most 0.1% of
    bytes different, alpha 255)."""
    from signalizer_tpu_torch.views.spectrogram import SpectrogramProcessor

    rng = np.random.default_rng(41)
    n = np.arange(9600)
    stream = (rng.standard_normal((6, 9600)) * 0.02).astype(np.float32)
    for ch in range(4):
        stream[ch] += (0.4 * np.sin(2 * np.pi * (700.0 + 900.0 * ch) * n / 48000.0)).astype(np.float32)
    kw = dict(pairs=3, axis_points=256, window_size=4096, blob_ms=10.0)
    procs = {
        "device": SpectrogramProcessor(device=cuda, device_ingest=True, **kw),
        "host": SpectrogramProcessor(device=cuda, device_ingest=False, **kw),
        "cpu": SpectrogramProcessor(device="cpu", device_ingest=True, **kw),
    }
    for at in range(0, 9600, 800):
        a0, b0 = counter("window_fft_mag.launches"), counter("display_map.launches")
        cols = {}
        for name, proc in procs.items():
            proc.push(stream[:, at : at + 800])
            cols[name] = proc.pull()
        assert (counter("window_fft_mag.launches") - a0) == (counter("display_map.launches") - b0)
        assert np.array_equal(cols["device"], cols["host"])
        if cols["cpu"].size:
            diff = np.abs(cols["device"].astype(np.int16) - cols["cpu"].astype(np.int16))
            assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3 and (cols["device"][..., 3] == 255).all()
    # one launch of each kernel, and one readback, per upload unit or host batch
    assert procs["device"].readbacks >= procs["host"].readbacks > 0
    assert procs["device"].freshness_lag() < 480 and procs["device"].batcher.dropped_frames == 0
    torch.testing.assert_close(procs["device"].state.magnitude.cpu(), procs["cpu"].state.magnitude, rtol=1e-4, atol=1e-7)


def test_resonator_processor_on_cuda(cuda):
    """ResonatorSpectrumProcessor on the card: each call launches kernel
    B's decay-and-dB entry once, agrees with the CPU processor (bank 2e-6
    of its peak, display 1e-4), and invalid chunks leave the bank as it
    was."""
    from signalizer_tpu_torch.views.spectrum import ResonatorSpectrumProcessor

    kw = dict(pairs=2, axis_points=256, window_size=1024, configuration=SpectrumChannels.SEPARATE,
              view_scaling=ViewScaling.LOGARITHMIC)
    on_card = ResonatorSpectrumProcessor.create(device=cuda, **kw)
    on_cpu = ResonatorSpectrumProcessor.create(device="cpu", **kw)
    rng = np.random.default_rng(42)
    n = np.arange(4096)
    x = (rng.standard_normal((2, 2, 4096)) * 0.02 + 0.5 * np.sin(2 * np.pi * 1234.0 * n / 48000.0)).astype(np.float32)
    calls = [
        (x[..., :800][:, :, None, :], None),
        (x[..., 800:2848].reshape(2, 2, 4, 512), [True, True, True, False]),
        (x[..., 2848:3872].reshape(2, 2, 2, 512), None),
    ]
    for blocks, valid in calls:
        before = counter("display_map.decay_db_launches")
        got = on_card.process_chunks(blocks, valid=valid)
        want = on_cpu.process_chunks(blocks, valid=valid)
        assert counter("display_map.decay_db_launches") == before + 1
        peak = float(on_cpu.res_state.abs().max())
        torch.testing.assert_close(on_card.res_state.cpu(), on_cpu.res_state, rtol=0, atol=2e-6 * peak)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    bank = on_card.res_state.clone()
    on_card.process_chunks(calls[1][0], valid=[False] * 4)
    assert torch.equal(on_card.res_state, bank)


def test_device_presentation_history_on_cuda_equals_get_history(cuda):
    """The device mirror of a threaded 16-channel stream on the card: every
    window equals the host ring's ``get_history`` bit for bit under ragged
    pushes, each sync uploads only the new samples, and a stall longer than
    the ring re-primes it."""
    from signalizer_tpu_torch.stream.audio_stream import AudioStream, AudioStreamInfo, Playhead
    from signalizer_tpu_torch.stream.device_history import DevicePresentationHistory

    inp, out = AudioStream.create(True, AudioStreamInfo(channels=16, audio_history_capacity=4096))
    dh = DevicePresentationHistory(out)
    assert dh.device.type == "cuda"
    rng = np.random.default_rng(0)
    try:
        for i, n in enumerate([800, 1, 257, 800, 3000, 800, 799]):
            inp.process_incoming_audio(rng.standard_normal((16, n)).astype(np.float32), Playhead())
            assert inp._stream.wait_for_drain(timeout=5.0)
            ring = dh.sync()
            assert ring.device.type == "cuda"
            if i > 0:
                assert dh.uploaded_bytes == 16 * n * 4
            for w in (1, 512, 4096):
                assert np.array_equal(dh.window(w).cpu().numpy(), out.get_history(w)), (i, w)
        reprimes = dh.reprimes
        for _ in range(7):  # a stall of 5600 samples > H
            inp.process_incoming_audio(rng.standard_normal((16, 800)).astype(np.float32), Playhead())
        assert inp._stream.wait_for_drain(timeout=5.0)
        dh.sync()
        assert dh.reprimes == reprimes + 1
        assert np.array_equal(dh.window(4096).cpu().numpy(), out.get_history(4096))
    finally:
        dh.close()
        inp._stream.close()


def test_frame_pipeline_on_cuda_harvests_by_event(cuda):
    """Steps on the card stay in flight until their event completes; the
    outputs come back in order, each equal to the step run alone."""
    from signalizer_tpu_torch.stream.frame_pipeline import FramePipeline

    def step(state, frame):
        y = torch.fft.rfft(frame).abs()
        return y, state + 1

    pipe = FramePipeline(step, torch.zeros((), device=cuda), depth=3)
    frames = [np.random.default_rng(i).standard_normal(1 << 16).astype(np.float32) for i in range(8)]
    outs = []
    for f in frames:
        outs.extend(pipe.submit(f))
        assert pipe.in_flight <= 3
    outs.extend(pipe.drain())
    assert len(outs) == 8 and pipe.frames_completed == 8 and int(pipe.state) == 8
    for f, o in zip(frames, outs):
        assert torch.equal(o, torch.fft.rfft(torch.from_numpy(f).to(cuda)).abs())


def _session_frames(device, fused, ticks=12, knobs=None, views=("spectrum", "oscilloscope", "vectorscope", "spectrogram")):
    """Frames of a port session at the factory default preset (Transform
    tracker on the left channel's sine) fed seeded blocks on ``device``."""
    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.session import AnalysisSession
    from signalizer_tpu_torch.stream.audio_stream import Playhead

    eng = SignalizerEngine("card", device=device)
    eng.spectrum.frequency_tracker.set_normalized(1 / 3)  # transform
    if knobs is not None:
        knobs(eng)
    s = AnalysisSession(eng, views=views, axis_points=256, pixels=256, cursor_fraction=1000 / 24000,
                        fused_tick=fused)
    rng = np.random.default_rng(43)
    t = np.arange(ticks * 800) / 48000.0
    x = np.stack([0.5 * np.sin(2 * np.pi * 1000.0 * t), 0.4 * np.sin(2 * np.pi * 1500.0 * t)])
    x = (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32)
    out = []
    for i in range(ticks):
        s.feed(x[:, i * 800 : (i + 1) * 800], Playhead(steady_clock=800 * (i + 1)))
        out.append(s.tick())
    counters = dict(eng.diagnostics.counters)
    s.close()
    return out, counters


def test_session_tick_on_cuda_matches_the_cpu_session(cuda):
    """A session on the card against the same session on the CPU (the
    kernels' plain versions), twelve ticks at the factory default preset,
    each view at its kernels' card tolerance: spectrum display atol 2e-4
    (kernels A and B against their plain versions, as above), oscilloscope
    1e-5 x max|x| x gain (kernel C's), vectorscope 2e-6 x gain,
    spectrogram bytes within 1 LSB on at most 0.1%, tracker frequency rtol
    1e-5; kernels A, B and C launched, every tick fused, nothing failed or
    fell back."""
    a0, b0 = counter("window_fft_mag.launches"), counter("display_map.launches")
    c0 = counter("banded_resample.launches")
    card, cc = _session_frames(cuda, True)
    assert counter("window_fft_mag.launches") > a0 and counter("display_map.launches") > b0
    assert counter("banded_resample.launches") > c0
    cpu, _ = _session_frames("cpu", True)
    assert cc["session.fused_ticks"] == cc["session.ticks"] == 12
    assert cc["session.failures"] == cc["session.fallbacks"] == 0
    for tick, (g, w) in enumerate(zip(card, cpu)):
        np.testing.assert_allclose(g.spectrum, w.spectrum, rtol=0, atol=2e-4, err_msg=f"tick {tick}")
        gain = float(w.oscilloscope.gain.max())
        torch.testing.assert_close(g.oscilloscope.waveform.cpu(), w.oscilloscope.waveform, rtol=0,
                                   atol=1e-5 * 0.6 * max(gain, 1.0))
        assert torch.equal(g.oscilloscope.trigger_found.cpu(), w.oscilloscope.trigger_found)
        torch.testing.assert_close(g.vectorscope.vertices.cpu(), w.vectorscope.vertices, rtol=1e-5,
                                   atol=2e-6 * max(float(w.vectorscope.gain.max()), 1.0))
        assert (g.spectrogram_columns is None) == (w.spectrogram_columns is None)
        if w.spectrogram_columns is not None and w.spectrogram_columns.size:
            diff = np.abs(g.spectrogram_columns.astype(np.int16) - w.spectrogram_columns.astype(np.int16))
            assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
        np.testing.assert_allclose(g.tracker["frequency"], w.tracker["frequency"], rtol=1e-5)
    assert abs(card[-1].tracker["frequency"] - 1000.0) < 48000.0 / 4096


def test_fused_session_tick_on_cuda_is_bit_equal_to_the_per_view_tick(cuda):
    """On the card the fused tick and the per-view tick give bit-equal
    spectra, oscilloscope and vectorscope frames."""
    fused, _ = _session_frames(cuda, True, ticks=8)
    per_view, pc = _session_frames(cuda, False, ticks=8)
    assert pc["session.fused_ticks"] == 0
    for f, p in zip(fused, per_view):
        assert np.array_equal(f.spectrum, p.spectrum)
        for name in ("waveform", "envelope_min", "envelope_max"):
            assert torch.equal(getattr(f.oscilloscope, name), getattr(p.oscilloscope, name))
        for name in ("vertices", "balance", "correlation_bars"):
            assert torch.equal(getattr(f.vectorscope, name), getattr(p.vectorscope, name))


# ---------------------------------------------------------------------------
# kernel D: the envelope-hold scan, bit-equal to its plain loop
# ---------------------------------------------------------------------------


def _hold_rows(rows, w, seed, device):
    """Noise under a slow envelope of random phase a row: rises and falls."""
    rng = np.random.default_rng(seed)
    t = np.arange(w)
    env = 0.55 + 0.45 * np.sin(2 * np.pi * t / max(w / 3.0, 7.0) + rng.uniform(0, 6.3, (rows, 1)))
    return torch.tensor((env * rng.standard_normal((rows, w))).astype(np.float32), device=device)


def _same(a, b):
    """Equal bit for bit where both are numbers, NaN in the same places."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b)
    )


def _hold_both(x, thr, hyst, state, holding, **kw):
    from signalizer_tpu_torch.kernels import peak_hold as ph

    n = counter("peak_hold.launches")
    got = ph.peak_hold_triggers(x, thr, hyst, state, holding, **kw)
    torch.cuda.synchronize()
    assert counter("peak_hold.launches") == n + 1
    want = ph.peak_hold_triggers_plain(x, thr, hyst, state, holding, **kw)
    assert torch.equal(got[0], want[0]), "fires"
    assert _same(got[1], want[1]), "state"
    assert torch.equal(got[2], want[2]), "holding"
    return got


@pytest.mark.parametrize("hysteresis", [0.0, 0.5])
@pytest.mark.parametrize("consumed", [0, 1, 1600, "all"])
@pytest.mark.parametrize("w", [1, 1600, 8192])
@pytest.mark.parametrize("rows", [1, 16, 33])
def test_peak_hold_kernel_is_bit_equal_to_the_loop(cuda, rows, w, consumed, hysteresis):
    """Three calls with the state carried, each consuming the given suffix
    (first = W - consumed) of a fresh row: fires, state and holding
    bit-equal to the plain loop on the same tensors."""
    n = w if consumed == "all" else min(consumed, w)
    thr = 0.1
    state = torch.full((rows,), thr * thr, device=cuda)
    holding = torch.zeros((rows,), dtype=torch.bool, device=cuda)
    fired = 0
    for call in range(3):
        x = _hold_rows(rows, w, 100 * rows + call, cuda)
        fires, state, holding = _hold_both(x, thr, hysteresis, state, holding, first=w - n)
        fired += int(fires.sum())
        assert not bool(fires[:, : max(w - n - 1, 0)].any())
    if n >= 1600:
        assert fired > 0


def test_peak_hold_kernel_device_scalars_mask_and_strided_rows(cuda):
    """The oscilloscope step's form: threshold and hysteresis as device
    scalars, rows strided out of a [pairs, 2, H] history; and a device mask
    that is not a suffix."""
    hist = _hold_rows(16 * 2, 8192, 7, cuda).reshape(16, 2, 8192)
    region = hist[:, 1, 8192 - 4096:]
    assert not region.is_contiguous()
    thr = torch.tensor(0.2, device=cuda)
    hyst = torch.tensor(0.25, device=cuda)
    state = torch.square(thr).expand(16).clone()
    holding = torch.zeros((16,), dtype=torch.bool, device=cuda)
    _hold_both(region, thr, hyst, state, holding, first=4096 - 1600)
    mask = torch.from_numpy(np.random.default_rng(3).random(4096) < 0.7).to(cuda)
    _hold_both(region, thr, hyst, state, holding, valid=mask)
    _hold_both(region.contiguous().reshape(4, 4, 4096), thr, hyst, state.reshape(4, 4),
               holding.reshape(4, 4), valid=mask)


def test_peak_hold_kernel_nan_sample_and_fall_at_sample_zero(cuda):
    """A NaN sample passes through the state as the loop passes it; a held
    peak that falls at sample 0 fires there (the boundary clamp)."""
    x = _hold_rows(4, 1600, 11, cuda)
    x[1, 700] = float("nan")
    x[2, :] = float("nan")
    state = torch.full((4,), 0.01, device=cuda)
    holding = torch.zeros((4,), dtype=torch.bool, device=cuda)
    _, st, hold = _hold_both(x, 0.1, 0.5, state, holding)
    assert bool(torch.isnan(st[2]))
    # a held peak: state 4.0, holding, and the first sample far below it
    y = torch.full((3, 1600), 0.05, device=cuda)
    fires, _, _ = _hold_both(y, 0.1, 0.0, torch.full((3,), 4.0, device=cuda),
                             torch.ones((3,), dtype=torch.bool, device=cuda))
    assert bool(fires[:, 0].all())
    one, _, _ = _hold_both(y[:, :1].contiguous(), 0.1, 0.0, torch.full((3,), 4.0, device=cuda),
                           torch.ones((3,), dtype=torch.bool, device=cuda))
    assert bool(one.all())


def _fused_both(x, thr, hyst, state, holding, ages, **kw):
    from signalizer_tpu_torch.kernels import peak_hold as ph

    n = counter("peak_hold.launches")
    got = ph.envelope_hold_trigger(x, thr, hyst, state, holding, ages, **kw)
    torch.cuda.synchronize()
    assert counter("peak_hold.launches") == n + 1
    want = ph.envelope_hold_trigger_plain(x, thr, hyst, state, holding, ages, **kw)
    for name, a, b in zip(("state", "holding", "fire_ages", "found", "start"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _same(a, b) if a.is_floating_point() else torch.equal(a, b), name
    return got


def _empty_ages(rows, device):
    from signalizer_tpu_torch.kernels import peak_hold as ph

    return torch.full((rows, ph.PEAK_QUEUE_SIZE), ph.FIRE_AGE_NONE, device=device)


@pytest.mark.parametrize("hysteresis", [0.0, 0.5])
@pytest.mark.parametrize("consumed", [0, 1, 1600, "all"])
@pytest.mark.parametrize("w", [1, 1600, 8192])
@pytest.mark.parametrize("rows", [1, 16, 33])
def test_peak_hold_fused_entry_is_bit_equal_to_its_plain_version(cuda, rows, w, consumed, hysteresis):
    """The fused entry at the function entry's shapes: three calls with the
    state and the fire-age queue carried, each consuming the given suffix
    of a fresh row, cfg3's window and history: state, holding, ages, found
    and start bit-equal to ``envelope_hold_trigger_plain``."""
    n = w if consumed == "all" else min(consumed, w)
    thr = 0.1
    state = torch.full((rows,), thr * thr, device=cuda)
    holding = torch.zeros((rows,), dtype=torch.bool, device=cuda)
    ages = _empty_ages(rows, cuda)
    for call in range(3):
        x = _hold_rows(rows, w, 100 * rows + call, cuda)
        state, holding, ages, _, _ = _fused_both(x, thr, hysteresis, state, holding, ages, first=w - n,
                                                 new_samples=float(n), window=1024.0, hf=16384.0)


@pytest.mark.parametrize(
    "case", ["fractional", "over_chunk", "over_8_fires", "no_fire", "ages_past_history", "nan", "fall_at_0",
             "device_scalars"],
)
def test_peak_hold_fused_entry_queue_cases(cuda, case):
    """The fused entry's queue and window start: a fractional new_samples,
    more new samples than the chunk, more than 8 fires in a chunk, no fire
    (a queue full of 1e9), carried ages out of order that pass the
    history's length, a NaN sample, a fall at sample 0, and the step's
    device scalars over rows strided out of a history; three calls each,
    bit-equal to the plain version."""
    from signalizer_tpu_torch.kernels import peak_hold as ph

    rows, w, ns, hyst, thr = 16, 2048, 1600.0, 0.5, 0.1
    ages = _empty_ages(rows, cuda)
    state = torch.full((rows,), thr * thr, device=cuda)
    holding = torch.zeros((rows,), dtype=torch.bool, device=cuda)
    hist = None
    if case == "fractional":
        ns = 1600.5
    elif case == "over_chunk":
        ns, hyst = 3000.0, 0.0
    elif case == "over_8_fires":
        w, ns, hyst = 8192, 8192.0, 0.0
    elif case == "ages_past_history":
        ages = torch.tensor([16000.0, 5.0, 1e9, 16383.0, 700.0, 1e9, 15000.0, 512.0], device=cuda).repeat(rows, 1)
    elif case == "fall_at_0":
        ns, hyst = 2048.0, 0.0
        state, holding = torch.full((rows,), 4.0, device=cuda), torch.ones((rows,), dtype=torch.bool, device=cuda)
    elif case == "device_scalars":
        thr, hyst = torch.tensor(0.2, device=cuda), torch.tensor(0.25, device=cuda)
        state = torch.square(thr).expand(rows).clone()
        hist = _hold_rows(rows * 2, 8192, 7, cuda).reshape(rows, 2, 8192)
    first = max(int(np.ceil(np.float32(w) - np.float32(min(ns, w)))), 0)
    for call in range(3):
        x = _hold_rows(rows, w, 300 + call, cuda)
        if case == "no_fire":
            x *= 0.01
        elif case == "over_8_fires":
            x[:, 50::100] = 4.0
        elif case == "nan":
            x[3, 1000] = float("nan")
            x[5] = float("nan")
        elif case == "fall_at_0":
            x = torch.full((rows, w), 0.05, device=cuda) if call == 0 else x
        elif case == "device_scalars":
            x = hist[:, 1, 8192 - w:]
            assert not x.is_contiguous()
        state, holding, ages, found, start = _fused_both(x, thr, hyst, state, holding, ages, first=first,
                                                         new_samples=ns, window=1024.0, hf=16384.0)
        if case == "fall_at_0" and call == 0:
            assert bool((ages[:, 0] == w - 1).all())
    if case == "over_8_fires":
        assert bool((ages < ph.FIRE_AGE_NONE).all())
    if case == "no_fire":
        assert bool((ages == ph.FIRE_AGE_NONE).all()) and not bool(found.any())
    if case == "nan":
        assert bool(torch.isnan(state[5]))


def test_envelope_hold_oscilloscope_step_launches_kernel_d(cuda):
    """The oscilloscope step under ENVELOPE_HOLD launches kernel D (its
    fused entry) once a call and gives the frames of the same step with the
    trigger's plain version (the loop and the queue's torch operations)."""
    from signalizer_tpu_torch.kernels import peak_hold as ph
    from signalizer_tpu_torch.views.oscilloscope import OscilloscopeProcessor, TriggerMode

    kw = dict(pairs=4, device=cuda, sample_rate=48000.0, pixels=256, window_samples=512.0,
              trigger_mode=TriggerMode.ENVELOPE_HOLD, trigger_threshold=0.05, trigger_hysteresis=0.3)
    card, loop = OscilloscopeProcessor.create(**kw), OscilloscopeProcessor.create(**kw)
    hist = _hold_rows(8, 8192 + 3 * 800, 5, cuda).reshape(4, 2, -1)
    for i in range(3):
        h = hist[..., i * 800 : i * 800 + 8192].contiguous()
        n = counter("peak_hold.launches")
        got = card.process(h, new_samples=800)
        assert counter("peak_hold.launches") == n + 1
        tv.envelope_hold_trigger = ph.envelope_hold_trigger_plain
        try:
            want = loop.process(h, new_samples=800)
        finally:
            tv.envelope_hold_trigger = ph.envelope_hold_trigger
        assert counter("peak_hold.launches") == n + 1  # the plain path launches nothing
        for name in ("waveform", "envelope_min", "envelope_max", "trigger_found"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(card.state.peak_fire_ages, loop.state.peak_fire_ages)


# ---------------------------------------------------------------------------
# kernel E: the colour track
# ---------------------------------------------------------------------------

COLOUR_FS = 96_000.0
COLOUR_POLE = float(np.exp(-1.0 / (10e-3 * COLOUR_FS)))  # the view's 10 ms smoother
COLOUR_BANDS = np.array([[1.0, 0.1, 0.1], [0.1, 1.0, 0.1], [0.1, 0.1, 1.0]], np.float32)
COLOUR_CASES = [
    # (pairs, rows, W, carried state): cfg3, one pair's two rows of the
    # session's 16384 samples (its coloured.oscilloscope draws one row), W
    # not a multiple of the chunk, shorter than a tile, one sample
    (16, 2, 16384, False),
    (16, 2, 16384, True),
    (1, 2, 16384, True),
    (3, 2, 3001, True),
    (2, 2, 100, False),
    (1, 2, 1, True),
]


def _colour_inputs(pairs, rows, w, carried, seed, device):
    """x [pairs, rows, W]: three tones and noise a row; the last row silent
    (from a zero state); with 4 rows or more the first pair's last row
    denormal (amplitude 5e-39). States zero or small random ones."""
    rng = np.random.default_rng(seed)
    n = np.arange(w)
    x = np.zeros((pairs, rows, w), np.float32)
    for p in range(pairs):
        for r in range(rows):
            amp = rng.uniform(0.05, 0.5, 3)
            x[p, r] = sum(a * np.sin(2 * np.pi * f * (1 + 0.1 * p) * n / COLOUR_FS + r)
                          for a, f in zip(amp, (120.0, 900.0, 6000.0)))
            x[p, r] += 0.01 * rng.standard_normal(w)
    denormal = pairs * rows >= 4
    if denormal:
        x[0, rows - 1] *= np.float32(1e-38)
    x[-1, -1] = 0.0
    z = (rng.standard_normal((pairs, rows, 8, 2)) * 0.01 * carried).astype(np.float32)
    s = (rng.random((pairs, rows, 3)) * 0.01 * carried).astype(np.float32)
    z[-1, -1] = 0.0
    s[-1, -1] = 0.0
    key = rng.random((pairs, rows, 3)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(x), ct.CrossoverState(t(z)), t(s), t(key), denormal


def _floor(ref):
    """One float32 rounding of the reference's peak: where the plain
    version's own error is 0 (W = 1), the kernel may still round once more."""
    return float(np.abs(ref).max()) * 2.0**-23


def _err(got, ref):
    return float(np.abs(got.cpu().numpy().reshape(ref.shape) - ref).max())


@pytest.mark.parametrize("pairs,rows,w,carried", COLOUR_CASES)
def test_colour_split_kernel_matches_plain_and_the_oracle(cuda, pairs, rows, w, carried):
    """Kernel E's split entry (``three_band_split`` on a CUDA tensor), two
    calls with the crossover state carried: bands and state no further
    from the float64 network than 2x the plain doubling scans' own error;
    a silent row exactly zero; a denormal row not flushed (as many nonzero
    bands as the plain version's)."""
    x, state, _, _, denormal = _colour_inputs(pairs, rows, w, carried, 11 + w, cuda)
    z64 = state.z.cpu().numpy().reshape(-1, 8, 2)
    pstate = state
    for call in range(2):
        xc = x if call == 0 else torch.roll(x, 37, -1)
        n = counter("colour_track.launches")
        bands, new = ct.three_band_split(xc, COLOUR_FS, state=state)
        assert counter("colour_track.launches") == n + 1
        pb, pnew = ct.three_band_split_plain(xc, COLOUR_FS, state=pstate)
        torch.cuda.synchronize()
        ref, z64, _, _ = ct.float64_reference(xc.cpu().numpy().reshape(-1, w), COLOUR_FS, z64, 0.0,
                                              np.zeros((pairs * rows, 3)), COLOUR_BANDS, np.zeros((pairs * rows, 3)), 0.0)
        assert bands.shape == (pairs, rows, 3, w) and new.z.shape == (pairs, rows, 8, 2)
        assert _err(bands, ref) <= 2 * _err(pb, ref) + _floor(ref)
        assert _err(new.z, z64) <= 2 * _err(pnew.z, z64) + _floor(ref)
        assert not bool(bands[-1, -1].any()) and not bool(new.z[-1, -1].any())
        if denormal:
            assert int((bands[0, rows - 1] != 0).sum()) == int((pb[0, rows - 1] != 0).sum()) > 0
        state, pstate = new, pnew


@pytest.mark.parametrize("pairs,rows,w,carried", COLOUR_CASES)
def test_colour_track_kernel_matches_plain_and_the_oracle(cuda, pairs, rows, w, carried):
    """Kernel E's fused entry (``colour_track``), a key per pair and row,
    two calls with both states carried: colours within 1e-3 of the plain
    version's; the crossover and smoothing states no further from the
    float64 chain than 2x the plain version's own error; a silent row's
    colours exactly the plain version's."""
    x, state, smooth, key, _ = _colour_inputs(pairs, rows, w, carried, 13 + w, cuda)
    bc, blend = torch.from_numpy(COLOUR_BANDS).to(cuda), torch.tensor(0.8, device=cuda)
    z64, s64 = state.z.cpu().numpy().reshape(-1, 8, 2), smooth.cpu().numpy().reshape(-1, 3)
    pstate, psmooth = state, smooth
    for call in range(2):
        xc = x if call == 0 else torch.roll(x, 37, -1)
        n = counter("colour_track.launches")
        colours, new, new_s = ct.colour_track(xc, COLOUR_FS, state, COLOUR_POLE, bc, key, blend, smooth)
        assert counter("colour_track.launches") == n + 1
        pc, pnew, pnew_s = ct.colour_track_plain(xc, COLOUR_FS, pstate, COLOUR_POLE, bc, key, blend, psmooth)
        torch.cuda.synchronize()
        _, z64, sm64, _ = ct.float64_reference(xc.cpu().numpy().reshape(-1, w), COLOUR_FS, z64, COLOUR_POLE, s64,
                                               COLOUR_BANDS, key.cpu().numpy().reshape(-1, 3), 0.8)
        s64 = sm64[..., -1]
        assert colours.shape == (pairs, rows, 3, w) and colours.is_contiguous()
        torch.testing.assert_close(colours, pc, rtol=0, atol=1e-3)
        assert _err(new.z, z64) <= 2 * _err(pnew.z, z64) + _floor(z64)
        assert _err(new_s, s64) <= 2 * _err(pnew_s, s64) + _floor(s64)
        assert torch.equal(colours[-1, -1], pc[-1, -1].contiguous())
        state, smooth, pstate, psmooth = new, new_s, pnew, pnew_s


def test_spectral_colour_track_on_cuda_takes_bands(cuda):
    """``spectral_colour_track`` on CUDA bands runs kernel E's fused entry
    on them (one launch, the crossover skipped): colours ([..., W, 3], a
    view of the channel-major output) within 1e-3 of the plain version's,
    the state as close to the float64 smoother as 2x the plain's; a key a
    row and a host blend."""
    x, state, smooth, key, _ = _colour_inputs(4, 2, 5000, True, 17, cuda)
    bands, _ = ct.three_band_split_plain(x, COLOUR_FS, state=state)
    bc = torch.from_numpy(COLOUR_BANDS).to(cuda)
    n = counter("colour_track.launches")
    got, gs = tk.spectral_colour_track(bands, COLOUR_POLE, bc, key[0], 0.7, smooth)
    assert counter("colour_track.launches") == n + 1
    want, ws = ct.spectral_colour_track_plain(bands, COLOUR_POLE, bc, key[0], 0.7, smooth)
    assert got.shape == want.shape == (4, 2, 5000, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    p = float(np.float32(COLOUR_POLE))
    b64 = bands.double().cpu().numpy() ** 2
    s64 = smooth.double().cpu().numpy()
    ref = np.empty(s64.shape)
    for i in np.ndindex(s64.shape):
        ref[i] = scipy.signal.lfilter([1.0 - p], [1.0, -p], b64[i], zi=[p * s64[i]])[0][-1]
    assert _err(gs, ref) <= 2 * _err(ws, ref) + _floor(ref)


def test_colour_track_refuses_what_it_cannot_take(cuda):
    """Wrong states, band colours or blend raise before any launch."""
    x, state, smooth, key, _ = _colour_inputs(2, 2, 256, True, 3, cuda)
    bc = torch.from_numpy(COLOUR_BANDS).to(cuda)
    n = counter("colour_track.launches")
    with pytest.raises(ValueError, match="crossover state"):
        ct.three_band_split(x, COLOUR_FS, state=ct.CrossoverState(state.z[:1]))
    with pytest.raises(ValueError, match="smoothing state"):
        ct.colour_track(x, COLOUR_FS, state, COLOUR_POLE, bc, key, 0.8, smooth.cpu())
    with pytest.raises(ValueError, match="band_colours"):
        ct.colour_track(x, COLOUR_FS, state, COLOUR_POLE, bc[:2], key, 0.8, smooth)
    with pytest.raises(ValueError, match="blend"):
        ct.colour_track(x, COLOUR_FS, state, COLOUR_POLE, bc, key, torch.tensor(0.8), smooth)
    with pytest.raises(ValueError, match="float32"):
        ct.colour_track(x.double(), COLOUR_FS, state, COLOUR_POLE, bc, key, 0.8, smooth)
    assert counter("colour_track.launches") == n


# kernel E's forced geometries: (blocks a row, W): every cluster size of
# the plans, non-portable 16 included, a row shorter than a segment and
# rows longer than the cluster's span (walked in tiles)
COLOUR_CLUSTER_CASES = [(1, 16384), (2, 16384), (8, 16384), (16, 16384), (16, 3001), (2, 300), (2, 40000),
                        (16, 200_000)]


@pytest.mark.parametrize("cluster,w", COLOUR_CLUSTER_CASES)
def test_colour_track_kernel_every_cluster_size(cuda, monkeypatch, cluster, w):
    """Kernel E with its row split across ``cluster`` blocks (the plan
    replaced by a fixed one, the fewest threads covering the row): both
    entries over two carried calls within the bounds of the cases above
    (colours 1e-3 of the plain version's, bands and states <= 2x the plain
    version's distance from the float64 chain), the silent row exact."""
    monkeypatch.setattr(ct, "colour_plan", lambda rows, w, sms: (ct.colour_threads(w, cluster), cluster))
    x, state, smooth, key, _ = _colour_inputs(1, 2, w, True, 19 + cluster, cuda)
    bc, blend = torch.from_numpy(COLOUR_BANDS).to(cuda), torch.tensor(0.8, device=cuda)
    z64, s64 = state.z.cpu().numpy().reshape(-1, 8, 2), smooth.cpu().numpy().reshape(-1, 3)
    split_z64 = z64
    fs_state, pfs_state, pstate, psmooth = state, state, state, smooth
    for call in range(2):
        xc = x if call == 0 else torch.roll(x, 37, -1)
        n = counter("colour_track.launches")
        bands, fs_state = ct.three_band_split(xc, COLOUR_FS, state=fs_state)
        colours, new, new_s = ct.colour_track(xc, COLOUR_FS, state, COLOUR_POLE, bc, key, blend, smooth)
        assert counter("colour_track.launches") == n + 2
        pb, pfs_state = ct.three_band_split_plain(xc, COLOUR_FS, state=pfs_state)
        pc, pnew, pnew_s = ct.colour_track_plain(xc, COLOUR_FS, pstate, COLOUR_POLE, bc, key, blend, psmooth)
        torch.cuda.synchronize()
        x64 = xc.cpu().numpy().reshape(-1, w)
        ref, split_z64, _, _ = ct.float64_reference(x64, COLOUR_FS, split_z64, 0.0, np.zeros((2, 3)), COLOUR_BANDS,
                                                    np.zeros((2, 3)), 0.0)
        _, z64, sm64, _ = ct.float64_reference(x64, COLOUR_FS, z64, COLOUR_POLE, s64, COLOUR_BANDS,
                                               key.cpu().numpy().reshape(-1, 3), 0.8)
        s64 = sm64[..., -1]
        assert _err(bands, ref) <= 2 * _err(pb, ref) + _floor(ref)
        assert _err(fs_state.z, split_z64) <= 2 * _err(pfs_state.z, split_z64) + _floor(ref)
        torch.testing.assert_close(colours, pc, rtol=0, atol=1e-3)
        assert _err(new.z, z64) <= 2 * _err(pnew.z, z64) + _floor(z64)
        assert _err(new_s, s64) <= 2 * _err(pnew_s, s64) + _floor(s64)
        assert torch.equal(colours[-1, -1], pc[-1, -1].contiguous()) and not bool(bands[-1, -1].any())
        state, smooth, pstate, psmooth = new, new_s, pnew, pnew_s


@pytest.mark.parametrize("threads,cluster", [(32, 17), (32, 0), (1024, 1), (48, 2), (512, 4)])
def test_colour_track_refuses_a_cluster_it_cannot_launch(cuda, monkeypatch, threads, cluster):
    """A geometry the kernel cannot take (more than 16 blocks a cluster, no
    block, more than 512 threads, threads no power of two, more than 32
    warps a cluster) raises from the launch: nothing falls back to one
    block a row."""
    monkeypatch.setattr(ct, "colour_plan", lambda rows, w, sms: (threads, cluster))
    x, state, smooth, key, _ = _colour_inputs(1, 2, 4096, True, 5, cuda)
    bc = torch.from_numpy(COLOUR_BANDS).to(cuda)
    n = counter("colour_track.launches")
    with pytest.raises(RuntimeError, match="colour_track"):
        ct.colour_track(x, COLOUR_FS, state, COLOUR_POLE, bc, key, 0.8, smooth)
    with pytest.raises(RuntimeError, match="three_band_split"):
        ct.three_band_split(x, COLOUR_FS, state=state)
    assert counter("colour_track.launches") == n


# ---------------------------------------------------------------------------
# kernel F: the spectral trigger's walk
# ---------------------------------------------------------------------------

WALK_N = 8192  # the oscilloscope's lookahead: 4094 candidate bins
WALK_QS = 2.0 ** (0.25 / 12.0) - 1.0


def _walk_bins(rows, seed, device, n=WALK_N):
    """The rfft's magnitudes and offsets of ``rows`` lookaheads at 96 kHz,
    taken on the card: a sine a row (80 Hz to 6 kHz, with harmonics in
    every third row, a second note in every fourth) and noise; the last
    row silent where there are two or more."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 96_000.0
    x = np.zeros((rows, n), np.float32)
    for r in range(max(rows - 1, 1)):
        f = 80.0 * (75.0 ** (r / max(rows - 1, 1)))
        x[r] = 0.5 * np.sin(2 * np.pi * f * t + r) + 0.003 * rng.standard_normal(n)
        if r % 3 == 1:
            x[r] += sum(0.3 / k * np.sin(2 * np.pi * k * f * t) for k in (2, 3, 4))
        if r % 4 == 2:
            x[r] += 0.4 * np.sin(2 * np.pi * 1.26 * f * t)
    return tk.spectral_bins(torch.from_numpy(x).to(device))


def _walk_history(rows, seed, device):
    """Past omegas: -1 sentinels in every other row's first half, far
    values (the median taken) in every third row."""
    rng = np.random.default_rng(seed)
    hist = rng.uniform(2.0, 400.0, (rows, 8)).astype(np.float32)
    hist[::2, :4] = -1.0
    hist[1::3] = rng.uniform(1000.0, 2000.0, (len(hist[1::3]), 8))
    hist[-1] = -1.0
    return torch.from_numpy(hist).to(device)


def _chain(rows, starts, length, ratio, first, device, m=WALK_N // 2 + 1):
    """Bins fed directly: noise of 1e-12 (offsets in [-0.5, 0.5)), and from
    ``starts[r]`` in row r ``length`` bins each ``ratio`` times the last (or,
    with ``ratio`` None, each the next float32 above twice the last, until
    float32 overflows, then one inf bin), from ``first``, the bins before
    it zero; bin 1's offset 0.5. The last row is silent."""
    rng = np.random.default_rng(rows)
    mags = (rng.random((rows, m)) * 1e-12).astype(np.float32)
    offsets = rng.uniform(-0.5, 0.5, (rows, m)).astype(np.float32)
    offsets[:, 1] = 0.5
    for r in range(rows - 1):
        v, i = np.float32(first), starts[r]
        mags[r, 1:i] = 0.0
        with np.errstate(over="ignore"):
            while (i - starts[r] < length) if ratio else np.isfinite(v):
                mags[r, i], offsets[r, i] = v, 0.0
                v = np.float32(v * np.float32(ratio)) if ratio else np.nextafter(np.float32(2 * v), np.float32(np.inf))
                i += 1
        if ratio is None:
            mags[r, i] = np.inf
    mags[-1] = 0.0
    return torch.from_numpy(mags).to(device), torch.from_numpy(offsets).to(device)


def _walk_both(mags, offsets, n, threshold, hysteresis, history=None):
    """Kernel F (one launch) and its plain version on the same tensors:
    every output bit-equal."""
    before = counter("spectral_walk.launches")
    if history is None:
        rec, passes = sw.spectral_walk(mags, offsets, n, threshold, hysteresis)
        want, want_passes = sw.spectral_walk_plain(mags, offsets, n, threshold, hysteresis)
        hist = want_hist = None
    else:
        hist, rec, passes = sw.spectral_walk_filtered(mags, offsets, n, history, threshold, hysteresis)
        want_hist, want, want_passes = sw.spectral_walk_filtered_plain(mags, offsets, n, history, threshold,
                                                                     hysteresis)
    torch.cuda.synchronize()
    assert counter("spectral_walk.launches") == before + 1 and sw.last_passes is passes
    for name, a, b in zip(rec._fields, rec, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (name, a, b)
    assert torch.equal(passes, want_passes.to(torch.int32)), (passes, want_passes)
    if history is not None:
        assert torch.equal(hist, want_hist)
    return rec, passes, hist


@pytest.mark.parametrize("scalars", ["host", "device"])
@pytest.mark.parametrize("threshold,hysteresis", [(0.0, 0.0), (0.1, 0.4)])
@pytest.mark.parametrize("rows", [1, 16, 33])
def test_spectral_walk_kernel_is_bit_equal_to_the_plain_loop(cuda, rows, threshold, hysteresis, scalars):
    """Kernel F's two entries against the plain loop (and the median filter)
    on the card, bit for bit: record, passes and history, the filtered
    entry over three calls with the history carried; the last row silent,
    -1 sentinels in the history; threshold and hysteresis as host numbers
    and as device scalars."""
    mags, offsets = _walk_bins(rows, rows, cuda)
    thr, hyst = threshold, hysteresis
    if scalars == "device":
        thr, hyst = torch.tensor(threshold, device=cuda), torch.tensor(hysteresis, device=cuda)
    _, passes, _ = _walk_both(mags, offsets, WALK_N, thr, hyst)
    assert int(passes.max()) > 1 and (rows == 1 or int(passes[-1]) == 1)
    history = _walk_history(rows, 7, cuda)
    for _ in range(3):
        _, _, history = _walk_both(mags, offsets, WALK_N, thr, hyst, history)


@pytest.mark.parametrize(
    "case,starts,length,ratio,first,hysteresis,accepted",
    [
        # the longest chain float32 allows: 276 doublings from 2^-149
        ("longest_chain", [2, 2], 0, None, 2.0**-149, 0.0, 276),
        ("normal_chain", [2, 2], 0, None, 2.0**-126, 0.4, None),
        ("chain_36", [2, 300], 36, 4.0, 1e-10, 0.4, None),
        # 1 - hysteresis = 2: a rising run of 300 bins reaches the 280-pass cap
        ("pass_cap", [2, 40], 300, 1.01, 1.0, -1.0, 280),
    ],
)
def test_spectral_walk_kernel_long_chains(cuda, case, starts, length, ratio, first, hysteresis, accepted):
    """Bins fed directly, two chains and a silent row: both entries bit-equal
    to the plain loop, the longest chain (276 acceptances, 277 passes) and
    the cap (280 passes) included."""
    mags, offsets = _chain(3, starts, length, ratio, first, cuda)
    _, passes, _ = _walk_both(mags, offsets, WALK_N, 0.0, hysteresis)
    _walk_both(mags, offsets, WALK_N, 0.0, hysteresis, _walk_history(3, 1, cuda))
    if accepted is not None:
        assert int(passes[0]) == min(accepted + 1, sw.MAX_WALK_ITERATIONS)
    assert int(passes[-1]) == 1


def test_spectral_walk_kernel_batch_shapes_strides_and_sizes(cuda):
    """Leading dimensions [2, 3], rows strided out of a wider tensor, bins
    past n // 2 (unread), the largest lookahead the kernel takes (n =
    16389) and lookaheads under 6 samples (no candidate bin)."""
    mags, offsets = _walk_bins(6, 3, cuda)
    _walk_both(mags.reshape(2, 3, -1), offsets.reshape(2, 3, -1), WALK_N, 0.1, 0.2,
               _walk_history(6, 2, cuda).reshape(2, 3, 8))
    wide_m, wide_o = torch.zeros((6, 5000), device=cuda), torch.zeros((6, 5000), device=cuda)
    wide_m[:, :4097], wide_o[:, :4097] = mags, offsets
    _walk_both(wide_m[:, :4097], wide_o[:, :4097], WALK_N, 0.0, 0.0)
    _walk_both(wide_m, wide_o, WALK_N, 0.0, 0.0)
    for n in (16389, 5, 4):
        big_m, big_o = _walk_bins(3, n, cuda, n=n)
        _walk_both(big_m, big_o, n, 0.0, 0.3, _walk_history(3, 4, cuda))


def test_spectral_oscilloscope_step_launches_kernel_f(cuda):
    """The oscilloscope step under the SPECTRAL trigger launches kernel F's
    filtered spectrum entry once a call, on the rfft itself, and gives the
    frames of the same step with the walk's plain version (fundamental,
    waves and the median history equal)."""
    from signalizer_tpu_torch.views.oscilloscope import OscilloscopeProcessor, TriggerMode

    kw = dict(pairs=4, device=cuda, sample_rate=96_000.0, pixels=1024, window_samples=1024.0,
              trigger_mode=TriggerMode.SPECTRAL, trigger_threshold=0.05, trigger_hysteresis=0.2)
    card, loop = OscilloscopeProcessor.create(**kw), OscilloscopeProcessor.create(**kw)
    hist = torch.from_numpy(_osc_history(4, 16384 + 3 * 1600, seed=3)).to(cuda)
    for i in range(3):
        h = hist[..., i * 1600 : i * 1600 + 16384].contiguous()
        n, ns = counter("spectral_walk.launches"), counter("spectral_walk.spectrum_launches")
        got = card.process(h, new_samples=1600)
        assert counter("spectral_walk.launches") == n + 1 and counter("spectral_walk.spectrum_launches") == ns + 1
        tv.spectral_walk_filtered_spectrum = sw.spectral_walk_filtered_spectrum_plain
        try:
            want = loop.process(h, new_samples=1600)
        finally:
            tv.spectral_walk_filtered_spectrum = sw.spectral_walk_filtered_spectrum
        assert counter("spectral_walk.launches") == n + 1  # the plain path launches nothing
        for name in ("fundamental", "waveform", "envelope_min", "envelope_max", "trigger_found", "gain"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(card.state.median_history, loop.state.median_history)


def test_spectral_walk_refuses_what_it_cannot_take(cuda):
    """Other dtypes, shapes, devices, too many bins and a wrong history
    raise before any launch."""
    mags, offsets = _walk_bins(2, 1, cuda)
    hist = _walk_history(2, 1, cuda)
    n = counter("spectral_walk.launches")
    with pytest.raises(ValueError, match="float32"):
        sw.spectral_walk(mags.double(), offsets.double(), WALK_N)
    with pytest.raises(ValueError, match="one shape"):
        sw.spectral_walk(mags, offsets[:1], WALK_N)
    with pytest.raises(ValueError, match=r"\[\.\.\., >= 8192\]"):
        sw.spectral_walk(mags, offsets, 2 * WALK_N)
    with pytest.raises(ValueError, match="at most 8192"):
        big = torch.zeros((1, 9000), device=cuda)
        sw.spectral_walk(big, big, 2 * 8195)
    with pytest.raises(ValueError, match="history"):
        sw.spectral_walk_filtered(mags, offsets, WALK_N, hist[:, :4])
    with pytest.raises(ValueError, match="threshold"):
        sw.spectral_walk(mags, offsets, WALK_N, torch.tensor([0.1, 0.2], device=cuda))
    with pytest.raises(ValueError, match="hysteresis"):
        sw.spectral_walk(mags, offsets, WALK_N, 0.0, torch.tensor(0.1))
    assert counter("spectral_walk.launches") == n


def _walk_spectrum(rows, seed, device, n=WALK_N):
    """The rfft [rows, n // 2 + 1] complex64 of ``_walk_bins``' lookaheads,
    taken on the card."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 96_000.0
    x = np.zeros((rows, n), np.float32)
    for r in range(max(rows - 1, 1)):
        f = 80.0 * (75.0 ** (r / max(rows - 1, 1)))
        x[r] = 0.5 * np.sin(2 * np.pi * f * t + r) + 0.003 * rng.standard_normal(n)
        if r % 3 == 1:
            x[r] += sum(0.3 / k * np.sin(2 * np.pi * k * f * t) for k in (2, 3, 4))
    return torch.fft.rfft(torch.from_numpy(x).to(device), dim=-1)


def _bits_equal(a, b):
    """Equal bit for bit (NaN payloads and the sign of zero included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _spectrum_both(spec, n, threshold, hysteresis, history=None):
    """Kernel F's spectrum entry (one launch) and its plain version
    (``spec.abs()``, ``_quad_delta`` and the plain loop) on the same
    tensors: record, passes and history bit-equal."""
    before, spectrum_before = counter("spectral_walk.launches"), counter("spectral_walk.spectrum_launches")
    if history is None:
        rec, passes = sw.spectral_walk_spectrum(spec, n, threshold, hysteresis)
        want, want_passes = sw.spectral_walk_spectrum_plain(spec, n, threshold, hysteresis)
        hist = want_hist = None
    else:
        hist, rec, passes = sw.spectral_walk_filtered_spectrum(spec, n, history, threshold, hysteresis)
        want_hist, want, want_passes = sw.spectral_walk_filtered_spectrum_plain(spec, n, history, threshold,
                                                                               hysteresis)
    torch.cuda.synchronize()
    assert counter("spectral_walk.launches") == before + 1
    assert counter("spectral_walk.spectrum_launches") == spectrum_before + 1
    assert sw.last_passes is passes
    for name, a, b in zip(rec._fields, rec, want):
        assert _bits_equal(a, b), (name, a, b)
    assert torch.equal(passes, want_passes.to(torch.int32)), (passes, want_passes)
    if history is not None:
        assert _bits_equal(hist, want_hist), (hist, want_hist)
    return rec, passes, hist


@pytest.mark.parametrize("scalars", ["host", "device"])
@pytest.mark.parametrize("threshold,hysteresis", [(0.0, 0.0), (0.1, 0.4)])
@pytest.mark.parametrize("rows", [1, 16, 33])
def test_spectral_walk_spectrum_is_bit_equal_to_the_plain_version(cuda, rows, threshold, hysteresis, scalars):
    """Kernel F's spectrum entries, which form each bin's magnitude and
    quadratic offset from the rfft, against ``spec.abs()``, ``_quad_delta``
    and the plain loop on the card, bit for bit: record, passes and
    history, the filtered entry over three calls with the history carried;
    odd rows start 8 bytes past a 16-byte boundary; the last row silent;
    threshold and hysteresis as host numbers and as device scalars."""
    spec = _walk_spectrum(rows, rows, cuda)
    thr, hyst = threshold, hysteresis
    if scalars == "device":
        thr, hyst = torch.tensor(threshold, device=cuda), torch.tensor(hysteresis, device=cuda)
    _, passes, _ = _spectrum_both(spec, WALK_N, thr, hyst)
    assert int(passes.max()) > 1 and (rows == 1 or int(passes[-1]) == 1)
    history = _walk_history(rows, 7, cuda)
    for _ in range(3):
        _, _, history = _spectrum_both(spec, WALK_N, thr, hyst, history)


def _special_spectrum(device):
    """Rows of a sine's rfft with bins set to what the per-bin arithmetic
    must carry as torch does: a run of zeros (a zero denominator), NaN and
    +-inf in either part (NaN spreads through the complex differences),
    neighbours whose denominator is (1, -1) (the guard's sum is 0), on and
    around the strongest bins, where the walk reads them; one row with NaN
    at bin 1 (the first incumbent) and one with inf at bin 1's neighbour."""
    spec = _walk_spectrum(9, 5, device)
    peak = spec.abs()[:, 2:-1].argmax(-1) + 2
    nan, inf = float("nan"), float("inf")
    edits = [
        [(0, 0.0), (1, 0.0), (2, 0.0)],                      # zeros over the peak
        [(0, complex(nan, 0.0))],                             # NaN at the peak
        [(1, complex(inf, 0.0))],                             # inf above it
        [(-1, complex(0.0, -inf)), (1, complex(-inf, 1.0))],  # inf in either part
        [(-1, 0.0), (0, complex(0.5, -0.5)), (1, 0.0)],       # denominator (1, -1) at the peak
        [(-2, 0.0), (-1, complex(50.0, -50.0)), (0, 0.0)],    # a (1, -1)-style bin below it
    ]
    for r, row_edits in enumerate(edits):
        for d, v in row_edits:
            spec[r, int(peak[r]) + d] = v
    spec[6, 1] = complex(nan, 1.0)
    spec[7, 0] = complex(inf, 0.0)
    spec[7, 2] = complex(1.0, nan)
    return spec


def test_spectral_walk_spectrum_special_values(cuda):
    """Zeros, NaN, +-inf and (1, -1) denominators in the spectrum: both
    spectrum entries bit-equal to the plain version (NaN where it has NaN,
    bit for bit)."""
    spec = _special_spectrum(cuda)
    for threshold, hysteresis in ((0.0, 0.0), (0.1, 0.4)):
        _spectrum_both(spec, WALK_N, threshold, hysteresis)
        _spectrum_both(spec, WALK_N, threshold, hysteresis, _walk_history(9, 3, cuda))


def test_spectral_walk_spectrum_strided_batch_views(cuda):
    """Leading dimensions [2, 3], every other row of a batch (a row stride
    of two rows), rows cut out of a wider tensor, entries past n // 2
    (unread), the largest lookahead the kernel takes (n = 16389) and the
    smallest (n = 4 and 5: no candidate bin)."""
    spec = _walk_spectrum(12, 3, cuda)
    _spectrum_both(spec[:6].reshape(2, 3, -1), WALK_N, 0.1, 0.2, _walk_history(6, 2, cuda).reshape(2, 3, 8))
    _spectrum_both(spec[::2], WALK_N, 0.0, 0.0, _walk_history(6, 5, cuda))
    wide = torch.zeros((12, 5000), dtype=torch.complex64, device=cuda)
    wide[:, :4097] = spec
    _spectrum_both(wide[:, :4097], WALK_N, 0.0, 0.0)
    _spectrum_both(wide[1:, 1:4099], WALK_N, 0.1, 0.0, _walk_history(11, 4, cuda))
    _spectrum_both(wide, WALK_N, 0.0, 0.0)
    for n in (16389, 5, 4):
        _spectrum_both(_walk_spectrum(3, n, cuda, n=n), n, 0.0, 0.3, _walk_history(3, 4, cuda))


def test_spectral_walk_spectrum_reaches_the_pass_cap(cuda):
    """A real spectrum (alternating signs, so that each bin's quadratic
    offset is (r - 1) / (r + 1)) whose magnitudes rise 1.01 a bin over
    300 bins: at hysteresis -1 (1 - hysteresis = 2) every bin of the run
    is vastly better and the same partial as the last, so both entries stop
    after their 280th pass, bit-equal to the plain version; the last row
    silent."""
    m = WALK_N // 2 + 1
    spec = np.zeros((3, m), np.complex64)
    for r, start in enumerate((2, 40)):
        j = np.arange(start, start + 300)
        spec[r, j] = ((-1.0) ** j) * np.float32(1.01) ** (j - start)
    spec = torch.from_numpy(spec).to(cuda)
    _, passes, _ = _spectrum_both(spec, WALK_N, 0.0, -1.0)
    assert passes.tolist() == [sw.MAX_WALK_ITERATIONS, sw.MAX_WALK_ITERATIONS, 1]
    _spectrum_both(spec, WALK_N, 0.0, -1.0, _walk_history(3, 1, cuda))


def test_spectral_walk_spectrum_refuses_what_it_cannot_take(cuda):
    """A float spectrum, too few entries for n, a lookahead under 4
    samples, too many bins and a wrong history raise before any launch."""
    spec = _walk_spectrum(2, 1, cuda)
    hist = _walk_history(2, 1, cuda)
    n = counter("spectral_walk.launches")
    with pytest.raises(ValueError, match="complex64"):
        sw.spectral_walk_spectrum(spec.abs(), WALK_N)
    with pytest.raises(ValueError, match=r"\[\.\.\., >= 4097\]"):
        sw.spectral_walk_spectrum(spec[:, :4096], WALK_N)
    with pytest.raises(ValueError, match=r"\[\.\.\., >= 3\]"):
        sw.spectral_walk_spectrum(torch.fft.rfft(torch.ones((2, 3), device=cuda)), 3)
    with pytest.raises(ValueError, match="at most 8192"):
        sw.spectral_walk_spectrum(torch.zeros((1, 9000), dtype=torch.complex64, device=cuda), 2 * 8195)
    with pytest.raises(ValueError, match="history"):
        sw.spectral_walk_filtered_spectrum(spec, WALK_N, hist[:, :4])
    assert counter("spectral_walk.launches") == n


# ---------------------------------------------------------------------------
# the session's uploads without a pageable copy
# ---------------------------------------------------------------------------


def test_pinned_upload_on_cuda_neither_syncs_nor_overwrites(cuda):
    """Ten uploads back to back through two pinned buffers, a large one
    between small ones, make no synchronizing call (the sync debug mode
    raises on one), and each device tensor keeps its own values."""
    from signalizer_tpu_torch.stream.pinned import PinnedUpload

    up = PinnedUpload(cuda)
    arrays = [np.full((1 << 20) if i % 3 == 1 else (3,), i, np.float32) for i in range(10)]
    arrays.append(np.float32(800.0))
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [up.upload(a) for a in arrays]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for a, g in zip(arrays, got):
        assert g.device.type == "cuda" and g.shape == np.shape(a)
        np.testing.assert_array_equal(g.cpu().numpy(), a)


def test_session_tick_on_cuda_syncs_only_for_its_readbacks(cuda):
    """The factory default session tick makes three synchronizing calls,
    its readbacks (the spectrum row, the tracker's bins, the spectrogram's
    columns), and no copy from pageable memory; ``cycles.oscilloscope``
    one more, the Cycles window's readback."""
    import warnings

    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.session import AnalysisSession
    from signalizer_tpu_torch.stream.audio_stream import Playhead

    x = (0.5 * np.sin(2 * np.pi * 1000 * np.arange(20 * 800) / 48000)).astype(np.float32)
    for preset, expected in (("default", 3), ("cycles.oscilloscope", 4)):
        eng = SignalizerEngine("syncs", device=cuda)
        if preset != "default":
            assert eng.load_preset(preset)
        eng.spectrum.frequency_tracker.set_normalized(1 / 3)
        s = AnalysisSession(eng, axis_points=256, pixels=256, cursor_fraction=1000 / 24000)
        counts = []
        for i in range(20):
            s.feed(np.stack([x, x])[:, 800 * i : 800 * (i + 1)], Playhead(steady_clock=800 * (i + 1)))
            with warnings.catch_warnings(record=True) as log:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    s.tick()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            counts.append(sum("synchroniz" in str(w.message) for w in log))
        s.close()
        assert max(counts[10:]) == expected, (preset, counts)


# kernel G's cases: name -> (pairs, T, K, P, mask): the Spectrum headline in
# PHASE at T = 128 and 1, its last frames padded, the spectrogram's cfg4
# geometry (1 pair x 512 frames), a ragged P, 1 and 11 line graphs
PHASE_CASES = {
    "headline_t128": (16, 128, 2, 1024, None),
    "headline_t1": (16, 1, 2, 1024, None),
    "headline_last_padded": (16, 128, 2, 1024, "last"),
    "cfg4": (1, 512, 2, 1024, "last"),
    "ragged_p": (3, 9, 2, 1001, "some"),
    "k1": (2, 7, 1, 256, None),
    "k11": (2, 33, 11, 200, "some"),
    "t100_ragged_chunks": (2, 100, 2, 1024, "some"),
    "k11_ragged_p_long": (1, 70, 11, 1001, "last"),
}
# each case by one chunk (one kernel) and, where T is longer, by chunks of
# 32 and 64 frames (the walk pass first)
PHASE_PLANS = [(case, frames) for case, (_, t, _, _, _) in PHASE_CASES.items() for frames in (None, 32, 64)
               if frames is None or t > frames]


def _phase_inputs(case, device, seed):
    """A PHASE constant and (vals, magnitude, phase, valid) on ``device``."""
    pairs, t, k, p, mask = PHASE_CASES[case]
    c = make_spectrum_constant(axis_points=p, window_size=4096, configuration=SpectrumChannels.PHASE,
                               view_scaling=ViewScaling.LOGARITHMIC, num_line_graphs=k, device=device)
    rng = np.random.default_rng(seed)
    mid = np.abs(rng.standard_normal((pairs, t, p))) * 0.3
    vals = np.stack([mid, rng.random((pairs, t, p))], axis=-2).astype(np.float32)
    mag = (rng.random((pairs, k, 2, p)) * 0.05).astype(np.float32)
    phase = (rng.random((pairs, k, p)) * 0.05).astype(np.float32)
    valid = None
    if mask == "last":
        valid = np.ones(t, bool)
        valid[-3:] = False
    elif mask == "some":
        valid = rng.random(t) > 0.3
    return c, *(torch.from_numpy(a).to(device) for a in (vals, mag, phase)), valid


@pytest.mark.parametrize("case", list(PHASE_CASES))
def test_phase_decay_kernel_is_bit_equal_to_the_plain_loop(cuda, case):
    """Kernel G vs its plain version on the same CUDA tensors: both states
    bit-equal (row 1 of the magnitude untouched), the display within atol
    1e-5 (the bound of kernel B's decay-and-dB entry: an IEEE division and
    a logf against torch's), one launch a call, a host mask as a device one."""
    from signalizer_tpu_torch.kernels import phase_decay_db as pd

    c, vals, mag, phase, valid = _phase_inputs(case, cuda, seed=len(case))
    k_state = init_line_graph_state(c, (vals.shape[0],))._replace(magnitude=mag.clone(), phase=phase.clone())
    p_state = init_line_graph_state(c, (vals.shape[0],))._replace(magnitude=mag.clone(), phase=phase.clone())
    before = counter("phase_decay_db.launches")
    got = pd.phase_decay_db(c, k_state, vals, valid)
    want = pd.phase_decay_db_plain(c, p_state, vals, valid)
    torch.cuda.synchronize()
    assert counter("phase_decay_db.launches") == before + 1
    assert got.shape == want.shape == vals.shape[:2] + (c.num_line_graphs, 2, c.axis_points)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(k_state.magnitude, p_state.magnitude) and torch.equal(k_state.phase, p_state.phase)
    assert torch.equal(k_state.magnitude[:, :, 1], mag[:, :, 1])
    if valid is not None:
        again = init_line_graph_state(c, (vals.shape[0],))._replace(magnitude=mag.clone(), phase=phase.clone())
        torch.testing.assert_close(pd.phase_decay_db(c, again, vals, torch.from_numpy(valid).to(cuda)), got,
                                   rtol=0, atol=0)
        assert torch.equal(again.magnitude, k_state.magnitude) and torch.equal(again.phase, k_state.phase)


@pytest.mark.parametrize("case,frames", PHASE_PLANS)
def test_phase_decay_kernel_one_and_two_pass_plans(cuda, monkeypatch, case, frames):
    """Kernel G with its plan replaced by T in one chunk (the mapping pass
    alone) or in chunks of ``frames`` frames (a walk pass writing each
    chunk's start, then the mapping pass from those starts): the states bit
    equal to the plain loop's and the display within 1e-5 either way, one
    wrapper call counted."""
    from signalizer_tpu_torch.kernels import phase_decay_db as pd

    t = PHASE_CASES[case][1]
    plan = (t, 1) if frames is None else (frames, -(-t // frames))
    monkeypatch.setattr(pd, "phase_plan", lambda pairs, t, k, p, sms: plan)
    c, vals, mag, phase, valid = _phase_inputs(case, cuda, seed=7 + len(case))
    k_state = init_line_graph_state(c, (vals.shape[0],))._replace(magnitude=mag.clone(), phase=phase.clone())
    p_state = init_line_graph_state(c, (vals.shape[0],))._replace(magnitude=mag.clone(), phase=phase.clone())
    before = counter("phase_decay_db.launches")
    got = pd.phase_decay_db(c, k_state, vals, valid)
    want = pd.phase_decay_db_plain(c, p_state, vals, valid)
    torch.cuda.synchronize()
    assert counter("phase_decay_db.launches") == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(k_state.magnitude, p_state.magnitude) and torch.equal(k_state.phase, p_state.phase)


def test_phase_decay_kernel_nan_zero_subnormal_and_no_sync(cuda):
    """NaN values propagate into the states as torch.maximum propagates them
    (fmaxf would drop them), zeros and subnormals are kept as the plain loop
    keeps them, and a call with a host mask makes no synchronizing call."""
    from signalizer_tpu_torch.kernels import phase_decay_db as pd

    c, vals, mag, phase, _ = _phase_inputs("k1", cuda, seed=3)
    vals[0, 2, 0, :5] = float("nan")
    vals[1, 3, 1, 7:9] = float("nan")
    vals[0, :, :, 20:40] = 0.0
    vals[1, :, 0, 40:60] = 1e-40
    mag[1, :, 0, 40:60] = 0.0
    states = [init_line_graph_state(c, (2,))._replace(magnitude=mag.clone(), phase=phase.clone()) for _ in range(2)]
    valid = [True, True, True, True, False, True, True]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pd.phase_decay_db(c, states[0], vals, valid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = pd.phase_decay_db_plain(c, states[1], vals, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5, equal_nan=True)
    for a, b in zip(states[0], states[1]):
        assert torch.equal(torch.isnan(a), torch.isnan(b)) and bool(torch.isnan(a).any())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert 0 < float(states[0].magnitude[1, 0, 0, 40]) < 1e-38  # a subnormal, not flushed


def test_phase_post_process_and_processor_launch_kernel_g(cuda):
    """The PHASE Spectrum on the card: kernel A then kernel G, once each a
    call (kernel B never), equal to stage 1 and the plain tail on the same
    tensors, and the resonator's PHASE bank through kernel G too."""
    from signalizer_tpu_torch import SpectrumProcessor
    from signalizer_tpu_torch.kernels import phase_decay_db as pd
    from signalizer_tpu_torch.views.spectrum import ResonatorSpectrumProcessor

    kw = dict(axis_points=256, window_size=1024, configuration=SpectrumChannels.PHASE,
              view_scaling=ViewScaling.LOGARITHMIC)
    proc = SpectrumProcessor.create(pairs=2, device=cuda, **kw)
    plain = init_line_graph_state(proc.constant, (2,))
    frames = _frames((2, 5, 2, 1024), seed=12, device=cuda)
    for x in (frames, frames[:, :1].contiguous()):
        counts = (counter("window_fft_mag.launches"), counter("display_map.launches"),
                  counter("display_map.decay_db_launches"), counter("phase_decay_db.launches"))
        got = proc.process(x)
        after = (counter("window_fft_mag.launches"), counter("display_map.launches"),
                 counter("display_map.decay_db_launches"), counter("phase_decay_db.launches"))
        want = pd.phase_decay_db_plain(proc.constant, plain, spectrum_values(proc.constant, x))
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(counts, after)) == (1, 0, 0, 1)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        assert torch.equal(proc._state.magnitude, plain.magnitude) and torch.equal(proc._state.phase, plain.phase)
    bank = ResonatorSpectrumProcessor.create(pairs=2, device=cuda, **kw)
    before = counter("phase_decay_db.launches")
    out = bank.process(_frames((2, 2, 800), seed=13, device=cuda))
    assert counter("phase_decay_db.launches") == before + 1
    assert out.shape == (2, 1, 2, 2, 256) and bool(torch.isfinite(out).all())


def test_phase_decay_refuses_what_it_cannot_take(cuda):
    from signalizer_tpu_torch.kernels import phase_decay_db as pd

    c, vals, mag, phase, _ = _phase_inputs("k1", cuda, seed=4)
    state = init_line_graph_state(c, (2,))
    with pytest.raises(ValueError, match="float32"):
        pd.phase_decay_db(c, state, vals[..., :1, :])
    with pytest.raises(ValueError, match="state.magnitude"):
        pd.phase_decay_db(c, state._replace(magnitude=mag[:1]), vals)
    with pytest.raises(ValueError, match="state.phase"):
        pd.phase_decay_db(c, state._replace(phase=phase.transpose(-1, -2).contiguous()), vals)
    with pytest.raises(ValueError, match="valid has 3 entries"):
        pd.phase_decay_db(c, state, vals, [True] * 3)


# kernel H's cases: name -> (pairs x rows, T, P, window, mask, readouts): the
# cfg6 tick (16 pairs x 2 rows, one 800-sample chunk) and backlog (16
# chunks of 512, the last 3 invalid), with readouts, and the other vector
# counts on a smaller bank
SCAN_CASES = {
    "cfg6_tick": ((16, 2), 1, 1024, "HANN", None, False),
    "cfg6_backlog_last_invalid": ((16, 2), 16, 1024, "HANN", "last", False),
    "cfg6_backlog_readouts": ((16, 2), 16, 1024, "HANN", "last", True),
    "v1_readouts": ((3, 1), 7, 300, "RECTANGULAR", "some", True),
    "v5": ((2, 2), 5, 130, "BLACKMAN", None, False),
    "v9_readouts": ((2, 2), 9, 257, "FLAT_TOP", "some", True),
}


def _scan_inputs(case, device):
    """A resonator constant, its plan and (state, chunks, valid, emit) on
    ``device`` for one of SCAN_CASES."""
    from signalizer_tpu_torch.core.windows import WindowType
    from signalizer_tpu_torch.kernels import resonator as rz

    lead, t, p, window, mask, emit = SCAN_CASES[case]
    w = 800 if t == 1 else 512
    bank = rz.make_resonator_constant(np.geomspace(30.0, 20000.0, p), 48000.0, 4096, device=device,
                                      window_type=WindowType[window])
    rng = np.random.default_rng(len(case) + t)
    chunks = torch.from_numpy((rng.standard_normal(lead + (t, w)) * 0.3).astype(np.float32)).to(device)
    state = torch.from_numpy((rng.standard_normal(lead + (p, bank.vectors, 2)) * 2.0).astype(np.float32)).to(device)
    valid = None
    if mask == "last":
        valid = np.ones(t, bool)
        valid[-3:] = False
    elif mask == "some":
        valid = rng.random(t) > 0.3
    return bank, rz.make_block_plan(bank, w), state, chunks, valid, emit


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_resonator_scan_kernel_is_bit_equal_to_the_plain_loop(cuda, case):
    """Kernel H vs its plain loop on the same drives: the state bit-equal,
    the readouts (re, im, magnitude, and after every chunk) within 1e-6 of
    each row's peak (the sum over the vectors in another order than
    torch's), one launch a call, the input state unchanged."""
    from signalizer_tpu_torch.kernels import resonator as rz
    from signalizer_tpu_torch.kernels import resonator_scan as rs

    bank, plan, state, chunks, valid, emit = _scan_inputs(case, cuda)
    state0 = state.clone()
    drives = rz._drive(plan.drive_matrix, chunks, bank.num_pixels, bank.vectors)
    args = (state, drives, plan.decay[..., 0], plan.decay[..., 1], bank.combine, bank.gain, valid, emit)
    before = counter("resonator_scan.launches")
    got = rs.resonator_scan(*args)
    want = rs.resonator_scan_plain(*args)
    torch.cuda.synchronize()
    assert counter("resonator_scan.launches") == before + 1 and torch.equal(state, state0)
    assert torch.equal(got.state, want.state)
    for name in ("re", "im", "magnitude") + (("readouts",) if emit else ()):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape
        assert _row_rel_err(g, w) <= 1e-6, name
    assert (got.readouts is None) == (not emit)
    if valid is not None and emit:
        bad = int(np.flatnonzero(~valid)[-1])
        assert bad == 0 or torch.equal(got.readouts[bad], got.readouts[bad - 1])


def test_resonator_scan_runs_once_per_bank_call_without_a_sync(cuda):
    """The resonator Spectrum on the card in SEPARATE and in PHASE: kernel H
    once a bank call (a tick, and a backlog with a host mask: no
    synchronizing call in the scan), the bank bit-equal to the plain loop
    on the same drives, the display against the CPU processor."""
    from signalizer_tpu_torch.kernels import resonator_scan as rs
    from signalizer_tpu_torch.views.spectrum import ResonatorSpectrumProcessor

    rng = np.random.default_rng(31)
    x = (rng.standard_normal((2, 2, 800 + 8 * 512)) * 0.3).astype(np.float32)
    valid = [True] * 5 + [False] * 3
    for cfg in (SpectrumChannels.SEPARATE, SpectrumChannels.PHASE):
        kw = dict(pairs=2, axis_points=256, window_size=1024, configuration=cfg, view_scaling=ViewScaling.LOGARITHMIC)
        card = ResonatorSpectrumProcessor.create(device=cuda, **kw)
        cpu = ResonatorSpectrumProcessor.create(device="cpu", **kw)
        for blocks, v in ((x[..., :800][:, :, None], None), (x[..., 800:].reshape(2, 2, 8, 512), valid)):
            blocks_on_card = torch.from_numpy(np.ascontiguousarray(blocks)).to(cuda)
            bank0 = card.res_state.clone()
            args = _scan_args(card, bank0, blocks_on_card, v)
            before = counter("resonator_scan.launches")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                scan = rs.resonator_scan(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            plain = rs.resonator_scan_plain(*args)
            got = card.process_chunks(blocks_on_card, valid=v)
            want = cpu.process_chunks(blocks, valid=v)
            torch.cuda.synchronize()
            assert counter("resonator_scan.launches") == before + 2
            assert torch.equal(scan.state, plain.state) and torch.equal(card.res_state, scan.state)
            peak = float(cpu.res_state.abs().max())
            torch.testing.assert_close(card.res_state.cpu(), cpu.res_state, rtol=0, atol=2e-6 * peak)
            if cfg == SpectrumChannels.SEPARATE:
                torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
            else:  # the magnitude row as SEPARATE's; the phase row in linear units at 2e-3, as PHASE is held
                torch.testing.assert_close(got[..., 0, :].cpu(), want[..., 0, :], rtol=0, atol=1e-4)
                np.testing.assert_allclose(_undb(card.constant, got[..., 1, :].cpu()),
                                           _undb(card.constant, want[..., 1, :]), atol=2e-3)


def _undb(c, results):
    """Display values back to linear units (clip_db -> 0)."""
    lower, dyr = (float(v) for v in c.display_scalars[1:3])
    lin = np.exp(np.asarray(results, np.float64) / dyr) * lower
    return np.where(np.asarray(results) == float(c.clip_db), 0.0, lin)


def _scan_args(proc, state, blocks, valid):
    """kernel H's arguments for a resonator processor's call on ``blocks``
    [pairs, 2, T, W] from ``state``, as rsnt_chunks forms them."""
    from signalizer_tpu_torch.kernels import resonator as rz
    from signalizer_tpu_torch.views.spectrum import _mix_rsnt

    plan = proc.block_plan(blocks.shape[-1])
    mixed = _mix_rsnt(proc.constant.configuration, blocks)
    drives = rz._drive(plan.drive_matrix, mixed, proc.resonator.num_pixels, proc.resonator.vectors)
    return (state, drives, plan.decay[..., 0], plan.decay[..., 1], proc.resonator.combine, proc.resonator.gain,
            valid)


def test_resonator_scan_refuses_what_it_cannot_take(cuda):
    from signalizer_tpu_torch.kernels import resonator as rz
    from signalizer_tpu_torch.kernels import resonator_scan as rs

    bank, plan, state, chunks, _, _ = _scan_inputs("v5", cuda)
    drives = rz._drive(plan.drive_matrix, chunks, bank.num_pixels, bank.vectors)
    d_re, d_im = plan.decay[..., 0], plan.decay[..., 1]
    with pytest.raises(ValueError, match="state"):
        rs.resonator_scan(state[:1], drives, d_re, d_im, bank.combine, bank.gain)
    with pytest.raises(ValueError, match="vectors"):
        rs.resonator_scan(state[..., :2, :], drives[..., :2, :], d_re[:, :2], d_im[:, :2], bank.combine[:2],
                          bank.gain)
    with pytest.raises(ValueError, match="valid has 4 entries"):
        rs.resonator_scan(state, drives, d_re, d_im, bank.combine, bank.gain, [True] * 4)
    # separate contiguous c^W tensors take the stride-1 form
    got = rs.resonator_scan(state, drives, d_re.contiguous(), d_im.contiguous(), bank.combine, bank.gain)
    want = rs.resonator_scan(state, drives, d_re, d_im, bank.combine, bank.gain)
    assert torch.equal(got.state, want.state) and torch.equal(got.magnitude, want.magnitude)


# ---------------------------------------------------------------------------
# the spectrogram's colour map (csrc/colormap.cu): byte-equal to the plain
# path at one pair; at more pairs the byte rule (the kernel's product runs in
# pair order, torch's reduction in its own): every byte within 1 LSB, at
# most 0.1% of bytes different, alpha 255
# ---------------------------------------------------------------------------


def _colormap_inputs(name, pairs, tables, dev):
    """(ratios, bounds, colours) on ``dev``: ``tables`` "one" is the default
    gradient as one [S, 3] table, "per_pair" the processor's hue-rotated
    tables [pairs, S, 3]."""
    from signalizer_tpu_torch.views.spectrogram import DEFAULT_GRADIENT, SpectrogramProcessor

    r = torch.from_numpy(cm.normalize_ratios(RATIO_SETS[name]).astype(np.float32)).to(dev)
    if tables == "one":
        colours = DEFAULT_GRADIENT
    else:
        colours = np.stack([SpectrogramProcessor._rotate(DEFAULT_GRADIENT, p, pairs) for p in range(pairs)])
    return r, cm.gradient_bounds(r), torch.from_numpy(np.ascontiguousarray(colours)).to(dev)


def _assert_columns(got, want, pairs):
    assert got.dtype == want.dtype == torch.uint8 and got.shape == want.shape
    assert bool((got[..., 3] == 255).all())
    if pairs == 1:
        assert torch.equal(got, want), f"{int((got != want).sum())} bytes differ at one pair"
        return
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    assert int(diff.max()) <= 1, f"a byte differs by {int(diff.max())}"
    assert float((diff != 0).float().mean()) <= 1e-3, f"{float((diff != 0).float().mean()):.2%} of bytes differ"


def _columns_once(x, colours, r, bounds):
    """The wrapper's columns, checking that the call launched the kernel once."""
    before = counter("colormap.launches")
    got = cm.spectrogram_columns(x, colours, r, bounds)
    torch.cuda.synchronize()
    assert counter("colormap.launches") == before + 1
    return got


@pytest.mark.parametrize("tables", ["one", "per_pair"])
def test_colormap_kernel_at_the_cells_geometry(cuda, tables):
    """1 pair, T = 512, P = 1024, the intensities the strided [:, :, 0, 0,
    :] view of a [1, 512, 2, 2, 1024] tensor as kernel B leaves them: the
    kernel's bytes are the plain path's."""
    r, bounds, colours = _colormap_inputs("default", 1, tables, cuda)
    base = torch.from_numpy(intensities(np.random.default_rng(60), (1, 512, 2, 2, 1024), bounds.cpu().numpy()))
    x = base.to(cuda)[:, :, 0, 0, :]
    assert not x.is_contiguous() and x.stride() == (512 * 4096, 4096, 1)
    got = _columns_once(x, colours, r, bounds)
    _assert_columns(got, cm.spectrogram_columns_plain(x, colours, r, bounds), 1)


@pytest.mark.parametrize("tables", ["one", "per_pair"])
@pytest.mark.parametrize("pairs", [2, 3, 16])
def test_colormap_kernel_blends_pairs(cuda, pairs, tables):
    """Several pairs through one table or hue-rotated tables, at the
    spectrogram's strided view, by the byte rule."""
    r, bounds, colours = _colormap_inputs("default", pairs, tables, cuda)
    base = intensities(np.random.default_rng(61 + pairs), (pairs, 64, 2, 2, 1024), bounds.cpu().numpy())
    x = torch.from_numpy(base).to(cuda)[:, :, 0, 0, :]
    got = _columns_once(x, colours, r, bounds)
    _assert_columns(got, cm.spectrogram_columns_plain(x, colours, r, bounds), pairs)


@pytest.mark.parametrize("pairs", [1, 3])
@pytest.mark.parametrize("name", list(RATIO_SETS))
def test_colormap_kernel_every_ratio_set(cuda, name, pairs):
    """Every ratio set, the zero-width segment included, on seeded
    intensities with each branch's values in the first row."""
    r, bounds, colours = _colormap_inputs(name, pairs, "per_pair", cuda)
    x = intensities(np.random.default_rng(70 + pairs), (pairs, 48, 256), bounds.cpu().numpy())
    branch = branch_values(bounds.cpu().numpy())
    x[:, 0, : len(branch)] = branch
    x = torch.from_numpy(x).to(cuda)
    got = _columns_once(x, colours, r, bounds)
    _assert_columns(got, cm.spectrogram_columns_plain(x, colours, r, bounds), pairs)


@pytest.mark.parametrize("name", list(RATIO_SETS))
def test_colormap_kernel_branches(cuda, name):
    """Each branch at one pair, byte for byte: below 0 and -inf black,
    exactly 0, on and beside every bound, just under and at 0.999, above 1
    and +inf the last stop; a NaN as the plain path maps it."""
    r, bounds, colours = _colormap_inputs(name, 1, "one", cuda)
    branch = branch_values(bounds.cpu().numpy())
    values = np.concatenate([branch, np.float32([np.nan])])
    x = torch.from_numpy(np.tile(values, (3, 1))[None]).to(cuda)  # [1, 3, n]: odd n, a ragged last run
    got = _columns_once(x, colours, r, bounds)
    _assert_columns(got, cm.spectrogram_columns_plain(x, colours, r, bounds), 1)
    row = got[0].cpu().numpy()
    v = values
    last = (np.asarray(colours[-1].cpu()) * 255.0).astype(np.uint8)
    assert (row[v < 0, :3] == 0).all()
    assert (row[(v >= np.float32(0.999)), :3] == last).all()


@pytest.mark.parametrize(
    "view", ["ragged_p1023", "offset_by_one", "pixels_strided", "p5", "p1_t7", "pairs_strided"],
)
@pytest.mark.parametrize("pairs", [1, 3])
def test_colormap_kernel_any_strides(cuda, view, pairs):
    """The element-by-element load path: rows not a multiple of 4 pixels
    (runs crossing rows, a ragged last run), a misaligned base, a pixel
    stride, a pair stride not a multiple of 4."""
    r, bounds, colours = _colormap_inputs("uneven", pairs, "per_pair", cuda)
    rng = np.random.default_rng(80 + pairs)
    b = bounds.cpu().numpy()
    if view == "ragged_p1023":
        x = torch.from_numpy(intensities(rng, (pairs, 9, 1023), b)).to(cuda)
    elif view == "offset_by_one":
        x = torch.from_numpy(intensities(rng, (pairs, 9, 1025), b)).to(cuda)[..., 1:]
    elif view == "pixels_strided":
        x = torch.from_numpy(intensities(rng, (pairs, 256, 9), b)).to(cuda).transpose(1, 2)
    elif view == "p5":
        x = torch.from_numpy(intensities(rng, (pairs, 11, 5), b)).to(cuda)
    elif view == "p1_t7":
        x = torch.from_numpy(rng.uniform(-0.2, 1.2, (pairs, 7, 1)).astype(np.float32)).to(cuda)
    else:
        x = torch.from_numpy(intensities(rng, (pairs, 9, 67), b)).to(cuda)[..., :64]
    got = _columns_once(x, colours, r, bounds)
    _assert_columns(got, cm.spectrogram_columns_plain(x, colours, r, bounds), pairs)


def test_colormap_kernel_refuses_what_it_cannot_take(cuda):
    r, bounds, colours = _colormap_inputs("default", 2, "per_pair", cuda)
    x = torch.rand(2, 4, 8, device=cuda)
    for bad, match in (
        ((x.double(), colours, r, bounds), "float32"),
        ((x, colours.double(), r, bounds), "float32"),
        ((x, colours, r.double(), None), "bounds"),
        ((x[0], colours, r, bounds), r"\[pairs, T, P\]"),
        ((x, colours[:1], r, bounds), "colours"),
        ((x, colours[:, :5], r, bounds), "colours"),
        ((x, colours, r[:1], bounds[:1]), "stops"),
        ((x, colours, r, bounds[:5]), "bounds"),
        ((x, colours.cpu(), r, bounds), "colours on cpu"),
    ):
        with pytest.raises(ValueError, match=match):
            cm.spectrogram_columns(*bad)
    many = cm.MAX_STOPS + 1
    r_many = torch.from_numpy(cm.normalize_ratios(np.ones(many)).astype(np.float32)).to(cuda)
    with pytest.raises(ValueError, match="stops"):
        cm.spectrogram_columns(x, torch.rand(many, 3, device=cuda), r_many)
    # the kernel's most stops are taken
    r_most = torch.from_numpy(cm.normalize_ratios(np.ones(cm.MAX_STOPS)).astype(np.float32)).to(cuda)
    c_most = torch.rand(cm.MAX_STOPS, 3, device=cuda)
    got = _columns_once(x[:1], c_most, r_most, None)
    _assert_columns(got, cm.spectrogram_columns_plain(x[:1], c_most, r_most), 1)


def test_spectrogram_ring_step_launches_the_colour_map_once(cuda):
    """One ``spectrogram_ring_step`` on the card counts ``colormap.launches``
    once, and its columns are the plain colour map's of the same step's
    intensities."""
    from signalizer_tpu_torch.core.config import DisplayMode
    from signalizer_tpu_torch.kernels.spectrum import LineGraphState
    from signalizer_tpu_torch.stream.device_ring import extract_frames
    from signalizer_tpu_torch.views.spectrogram import spectrogram_ring_step

    c = make_spectrum_constant(axis_points=256, window_size=4096, configuration=SpectrumChannels.LEFT,
                               display_mode=DisplayMode.COLOUR_SPECTRUM, device=cuda)
    hop, t_valid = 480, 12
    ring = _frames((1, 2, 4096 + 15 * hop), seed=90, device=cuda)
    new = _frames((1, 2, hop), seed=91, device=cuda)
    r, bounds, colours = _colormap_inputs("default", 1, "per_pair", cuda)
    state = init_line_graph_state(c, (1,))
    state.magnitude.copy_(_frames(tuple(state.magnitude.shape), seed=92, device=cuda).abs())
    before = LineGraphState(*(t.clone() for t in state))
    launches = counter("colormap.launches")
    cols, ring_after, _ = spectrogram_ring_step(c, ring, state, new, hop, t_valid, colours, r, hop=hop,
                                                bounds=bounds)
    torch.cuda.synchronize()
    assert counter("colormap.launches") == launches + 1
    frames = extract_frames(ring_after, c.window_size, hop, t_valid, frame_axis=-3).contiguous()
    intensity = analyze_frames(c, before, frames).results[:, :, 0, 0, :]
    _assert_columns(cols, cm.spectrogram_columns_plain(intensity, colours, r, bounds), 1)


def test_phase_processor_at_the_phase_cell_against_the_float64_reference(cuda):
    """``SpectrumProcessor`` in PHASE at the benchmark's PHASE cell (16 pairs
    x 128 frames at hop 800 of its seeded audio, 4096 points to 1024 px, two
    calls, both states carried) against the benchmark's float64 reference
    on the card, by the cell's own check and under its limits file's
    numbers (``portbench/limits/spectrum_phase16.batch128.json``, each
    number's reason in ``portbench/phase_views.py``)."""
    import json
    from pathlib import Path

    from portbench.harness import Bench, load_module

    bench = Bench()
    paths = bench.files(bench.cell("spectrum_phase16.batch128"))
    cfg, traffic, limits = (json.loads(Path(paths[k]).read_text()) for k in ("config", "traffic", "limits"))
    mod = load_module(paths["session"])
    s = mod.SESSION(cfg, traffic, cuda, 2**31 + 77, build=mod.build)
    kept, host = {}, {}
    for k in range(2):
        out = s.step(s.inputs(k))
        kept[k] = out.clone()
        host[k] = s.readback_source(out).cpu().numpy()
    numbers = s.check(kept, host, s.final_state(), 2)
    assert all(numbers[k] <= limits[k] for k in numbers), (numbers, limits)
