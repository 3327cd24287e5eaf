"""The PyTorch port's SpectrumConstant against the JAX package's.

The port copies the numpy remap-plan functions, so its tables must equal
the JAX constant's bit for bit: int and bool tables exactly, float tables
after the same float64 -> float32 rounding. No tolerance is stated
because none is allowed."""

import dataclasses

import numpy as np
import pytest
import torch

from signalizer_tpu.core.config import BinInterpolation, SpectrumChannels, ViewScaling
from signalizer_tpu.core.constant import build_remap_plan as jax_build_remap_plan
from signalizer_tpu.core.constant import host_view
from signalizer_tpu.core.constant import make_spectrum_constant as jax_make
from signalizer_tpu.core.constant import remap_frequencies as jax_remap_frequencies
from signalizer_tpu.core.windows import WindowType
from signalizer_tpu_torch.core.constant import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    build_remap_plan,
    check_device,
    constant_from_arrays,
    fft_twiddles,
    make_spectrum_constant,
    remap_frequencies,
)

# the headline geometry (bench.py:240-266), the four golden configs
# (tests/test_golden.py:25-54), and a LANCZOS and a NONE case
CASES = {
    "headline": dict(
        axis_points=1024, window_size=4096, configuration=SpectrumChannels.SEPARATE,
        bin_interpolation=BinInterpolation.LINEAR, view_scaling=ViewScaling.LOGARITHMIC,
    ),
    "golden_left_log_linear1024": dict(
        axis_points=200, window_size=1024, configuration=SpectrumChannels.LEFT,
        bin_interpolation=BinInterpolation.LINEAR, view_scaling=ViewScaling.LOGARITHMIC,
    ),
    "golden_phase_lanczos": dict(
        axis_points=160, window_size=512, configuration=SpectrumChannels.PHASE,
        bin_interpolation=BinInterpolation.LANCZOS, view_scaling=ViewScaling.LINEAR,
    ),
    "golden_midside_none": dict(
        axis_points=128, window_size=2048, configuration=SpectrumChannels.MIDSIDE,
        bin_interpolation=BinInterpolation.NONE, view_scaling=ViewScaling.LOGARITHMIC,
    ),
    "golden_complex_linear": dict(
        axis_points=160, window_size=1024, configuration=SpectrumChannels.COMPLEX,
        bin_interpolation=BinInterpolation.LINEAR, view_scaling=ViewScaling.LINEAR,
    ),
    "lanczos_complex_log_zoomed": dict(
        axis_points=96, window_size=700, configuration=SpectrumChannels.COMPLEX,
        bin_interpolation=BinInterpolation.LANCZOS, view_scaling=ViewScaling.LOGARITHMIC,
        view_left=0.1, view_right=0.9, window_type=WindowType.BLACKMAN,
    ),
    "none_merge_slope": dict(
        axis_points=64, window_size=256, configuration=SpectrumChannels.MERGE,
        bin_interpolation=BinInterpolation.NONE, view_scaling=ViewScaling.LINEAR,
        slope_a=0.5, slope_b=0.01, low_dbs=-60.0, high_dbs=-60.0,
        decay_seconds=(0.2, 0.5, 2.0), num_line_graphs=3,
    ),
}


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _jax_static(jc):
    return {name: getattr(jc, name) for name in STATIC_FIELDS}


def _jax_arrays(jc):
    return {name: np.asarray(getattr(jc, name)) for name in ARRAY_FIELDS}


def _assert_same_tables(tc, jc):
    for name in STATIC_FIELDS:
        assert getattr(tc, name) == getattr(jc, name), name
    for name, dtype in ARRAY_FIELDS.items():
        got = _as_numpy(getattr(tc, name))
        want = np.asarray(getattr(jc, name))
        assert getattr(tc, name).dtype == dtype, name
        assert got.shape == want.shape, name
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("name", list(CASES))
def test_tables_equal_jax_bit_for_bit(name):
    kw = CASES[name]
    jc = jax_make(sample_rate=48_000.0, fft_backend="xla", **kw)
    tc = make_spectrum_constant(sample_rate=48_000.0, device="cpu", **kw)
    _assert_same_tables(tc, jc)
    # the float64 host mirror rounds to the same float32 tables
    for field in ("mapped_frequencies", "slope_map", "interp_weights", "window_kernel"):
        mirror = np.asarray(host_view(jc, field)).astype(np.float32)
        assert np.array_equal(_as_numpy(getattr(tc, field)), mirror), field


@pytest.mark.parametrize("name", list(CASES))
def test_remap_plan_equals_jax_bit_for_bit(name):
    """The copied plan builders, every RemapPlan field: segment_ids too,
    which the constant does not carry (kernel B reads chunk_lo/chunk_len)."""
    kw = CASES[name]
    geometry = dict(
        view_left=kw.get("view_left", 0.0),
        view_right=kw.get("view_right", 1.0),
        configuration=kw["configuration"],
    )
    freqs = remap_frequencies(kw["axis_points"], 48_000.0, kw["view_scaling"], **geometry)
    assert np.array_equal(freqs, jax_remap_frequencies(kw["axis_points"], 48_000.0, kw["view_scaling"], **geometry))
    n = make_spectrum_constant(sample_rate=48_000.0, device="cpu", **kw).transform_size
    args = (freqs, 48_000.0, n, kw["bin_interpolation"])
    full = kw["configuration"] == SpectrumChannels.COMPLEX
    got = build_remap_plan(*args, full_circle=full)
    want = jax_build_remap_plan(*args, full_circle=full)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
        assert np.array_equal(a, b), f.name


@pytest.mark.parametrize("name", list(CASES))
def test_chunk_ranges_match_band_tables(name):
    tc = make_spectrum_constant(sample_rate=48_000.0, device="cpu", **CASES[name])
    band_idx = _as_numpy(tc.band_idx)
    band_mask = _as_numpy(tc.band_mask)
    lo = _as_numpy(tc.chunk_lo)
    length = _as_numpy(tc.chunk_len)
    assert lo.dtype == np.int32 and length.dtype == np.int32
    for x in range(tc.axis_points):
        owned = band_idx[x][band_mask[x]]
        assert length[x] == owned.size
        if owned.size:
            assert np.array_equal(owned, np.arange(lo[x], lo[x] + length[x]))
    # interp and single-bin pixels own no chunk
    dead = _as_numpy(tc.interp_mask) | _as_numpy(tc.single_mask)
    assert (length[dead] == 0).all()
    assert (length[~dead] >= 1).all()


@pytest.mark.parametrize("name", ["headline", "golden_phase_lanczos", "none_merge_slope"])
def test_constant_from_arrays_round_trips_a_jax_constant(name):
    kw = CASES[name]
    jc = jax_make(sample_rate=48_000.0, fft_backend="xla", **kw)
    carried = constant_from_arrays(_jax_static(jc), _jax_arrays(jc), "cpu")
    _assert_same_tables(carried, jc)
    built = make_spectrum_constant(sample_rate=48_000.0, device="cpu", **kw)
    for field in ("chunk_lo", "chunk_len", "fft_twiddles", "display_scalars"):
        assert torch.equal(getattr(carried, field), getattr(built, field)), field


def test_display_scalars_follow_the_db_map():
    """inv_size, lower, 1/log(upper/lower) and clip_db in f32, computed as
    the JAX _db_map computes them (exact: the same f32 operations)."""
    kw = CASES["none_merge_slope"]
    jc = jax_make(sample_rate=48_000.0, fft_backend="xla", **kw)
    tc = make_spectrum_constant(sample_rate=48_000.0, device="cpu", **kw)
    import jax.numpy as jnp

    lower = jnp.exp(jc.low_dbs * 0.11512925464970229)
    upper = jnp.exp(jc.high_dbs * 0.11512925464970229)
    want = np.array(
        [jc.inv_size, lower, 1.0 / jnp.log(upper / lower), jc.clip_db], np.float32
    )
    np.testing.assert_allclose(_as_numpy(tc.display_scalars), want, rtol=2e-7)
    # the dB-range floor of 0.1 dB applies before the scalars
    assert float(tc.high_dbs - tc.low_dbs) == pytest.approx(0.1, abs=1e-5)


def test_twiddles_are_float64_rounded_once():
    """Stage order: entry half + pos is exp(-2 pi i pos / (2 half)); the
    last N/2 entries are exp(-2 pi i k / N), and the first N/2 are the
    N/2-point transform's own table."""
    tw = fft_twiddles(4096)
    assert tw.dtype == np.float32 and tw.shape == (4096, 2)
    for half in (1, 2, 64, 1024, 2048):
        want = np.exp(-2j * np.pi * np.arange(half) / (2 * half))
        assert np.array_equal(tw[half : 2 * half, 0], want.real.astype(np.float32))
        assert np.array_equal(tw[half : 2 * half, 1], want.imag.astype(np.float32))
    k = np.arange(2048)
    ang = -2.0 * np.pi * k / 4096  # the flat table's own arithmetic
    assert np.array_equal(tw[2048:, 0], np.cos(ang).astype(np.float32))
    assert np.array_equal(tw[2048:, 1], np.sin(ang).astype(np.float32))
    assert np.array_equal(tw[:2048], fft_twiddles(2048))


def test_to_moves_every_tensor_and_replace_rederives_scalars():
    tc = make_spectrum_constant(axis_points=32, window_size=128, device="cpu")
    moved = tc.to("cpu")
    for f in dataclasses.fields(moved):
        value = getattr(moved, f.name)
        if isinstance(value, torch.Tensor):
            assert value.device == torch.device("cpu"), f.name
    louder = dataclasses.replace(tc, high_dbs=torch.tensor(-10.0))
    assert not torch.equal(louder.display_scalars, tc.display_scalars)
    assert torch.equal(louder.display_scalars[[0, 3]], tc.display_scalars[[0, 3]])


def test_cuda_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU refusal is not reachable")
    with pytest.raises(RuntimeError, match="cuda"):
        check_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        make_spectrum_constant(axis_points=32, window_size=128, device="cuda")
