"""The PyTorch port's spectrogram colour map against the JAX package on the
CPU. Inputs are made with numpy from a seed and handed to both. The segment
bounds are held bit-equal; float colours to 2e-6; RGBA8 bytes by the byte
rule: quantization truncates, so an ulp in a colour can flip a byte by one,
hence every byte within 1 LSB, at most 0.1% of bytes different, and alpha
exactly 255."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colormap_cases import RATIO_SETS, branch_values, intensities
from signalizer_tpu.kernels import colormap as jc
from signalizer_tpu.views.spectrogram import DEFAULT_GRADIENT as J_GRADIENT
from signalizer_tpu.views.spectrogram import DEFAULT_RATIOS as J_RATIOS
from signalizer_tpu_torch.kernels import colormap as tc
from signalizer_tpu_torch.utils.diagnostics import counter
from signalizer_tpu_torch.views.spectrogram import DEFAULT_GRADIENT, DEFAULT_RATIOS, SpectrogramProcessor


def assert_bytes_close(got: np.ndarray, want: np.ndarray):
    """The byte rule of the module docstring."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert (got[..., 3] == 255).all() and (want[..., 3] == 255).all()
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, f"a byte differs by {diff.max()}"
    assert (diff != 0).mean() <= 1e-3, f"{(diff != 0).mean():.2%} of bytes differ"


def _ratios(name):
    return jc.normalize_ratios(RATIO_SETS[name]).astype(np.float32)


def test_defaults_and_normalize_equal_the_jax_package():
    assert np.array_equal(DEFAULT_GRADIENT, J_GRADIENT) and np.array_equal(DEFAULT_RATIOS, J_RATIOS)
    assert tc.NUM_SPECTRUM_COLOURS == jc.NUM_SPECTRUM_COLOURS
    for r in (*RATIO_SETS.values(), np.zeros(6), np.asarray([5.0, 1, 2, 3, 4, 5])):
        assert np.array_equal(tc.normalize_ratios(r), jc.normalize_ratios(r))


@pytest.mark.parametrize("name", list(RATIO_SETS))
def test_bounds_bit_equal_to_jax_cumsum(name):
    """The segment bounds decide which segment an intensity on a bound
    falls in: the port's running sum equals ``jnp.cumsum`` bit for bit, eager
    and under jit."""
    r = _ratios(name)
    got = tc.gradient_bounds(torch.from_numpy(r)).numpy()
    assert np.array_equal(got, np.asarray(jnp.cumsum(jnp.asarray(r))))
    assert np.array_equal(got, np.asarray(jax.jit(jnp.cumsum)(jnp.asarray(r))))
    assert got[0] == 0.0


@pytest.mark.parametrize("name", list(RATIO_SETS))
def test_gradient_map_matches_jax(name):
    """One table: float colours within 2e-6, black for negative
    intensities, the last stop exactly from 0.999 up."""
    r = _ratios(name)
    bounds = np.asarray(jnp.cumsum(jnp.asarray(r)))
    x = intensities(np.random.default_rng(1), (7, 300), bounds)
    got = tc.gradient_map(torch.from_numpy(x), torch.from_numpy(DEFAULT_GRADIENT), torch.from_numpy(r)).numpy()
    want = np.asarray(jc.gradient_map(jnp.asarray(x), jnp.asarray(DEFAULT_GRADIENT), jnp.asarray(r)))
    assert got.shape == want.shape == (7, 300, 3)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert (got[x < 0] == 0).all()
    assert (got[x >= np.float32(0.999)] == DEFAULT_GRADIENT[-1]).all()


def test_blend_and_quantize_match_jax():
    rng = np.random.default_rng(2)
    rgb = rng.uniform(-0.1, 1.1, (5, 40, 64, 3)).astype(np.float32)
    blended = tc.blend_pairs(torch.from_numpy(rgb), axis=0)
    np.testing.assert_allclose(blended.numpy(), np.asarray(jc.blend_pairs(jnp.asarray(rgb), axis=0)), atol=2e-6, rtol=2e-6)
    # quantizing the same floats truncates to the same bytes
    one = rgb[0]
    got = tc.quantize_rgba8(torch.from_numpy(one)).numpy()
    assert np.array_equal(got, np.asarray(jc.quantize_rgba8(jnp.asarray(one))))
    assert (got[..., 3] == 255).all()
    k = np.arange(256, dtype=np.float32) / 255.0  # exact byte levels, and just around them
    levels = np.stack([k, np.nextafter(k, np.float32(-1)), np.nextafter(k, np.float32(2))], axis=-1)
    assert np.array_equal(
        tc.quantize_rgba8(torch.from_numpy(levels)).numpy(), np.asarray(jc.quantize_rgba8(jnp.asarray(levels)))
    )


@pytest.mark.parametrize("pairs", [1, 3])
@pytest.mark.parametrize("name", ["default", "uneven"])
def test_spectrogram_columns_match_jax(name, pairs):
    """The whole column pipeline with per-pair tables, by the byte rule."""
    r = _ratios(name)
    bounds = np.asarray(jnp.cumsum(jnp.asarray(r)))
    rng = np.random.default_rng(3 + pairs)
    x = intensities(rng, (pairs, 50, 128), bounds)
    tables = np.stack([np.roll(DEFAULT_GRADIENT, p, axis=1) for p in range(pairs)])
    tables[:, 0] = DEFAULT_GRADIENT[0]
    got = tc.spectrogram_columns(torch.from_numpy(x), torch.from_numpy(tables), torch.from_numpy(r)).numpy()
    want = np.asarray(jc.spectrogram_columns(jnp.asarray(x), jnp.asarray(tables), jnp.asarray(r)))
    assert got.shape == (50, 128, 4)
    assert_bytes_close(got, want)
    # kept bounds give the same bytes as bounds formed in the call
    kept = tc.gradient_bounds(torch.from_numpy(r))
    again = tc.spectrogram_columns(torch.from_numpy(x), torch.from_numpy(tables), torch.from_numpy(r), kept)
    assert np.array_equal(again.numpy(), got)


def test_silent_pair_is_black_and_opaque():
    r = torch.from_numpy(_ratios("default"))
    x = torch.full((2, 4, 16), -4.0)
    tables = torch.from_numpy(np.stack([DEFAULT_GRADIENT, DEFAULT_GRADIENT]))
    cols = tc.spectrogram_columns(x, tables, r).numpy()
    assert (cols[..., :3] == 0).all() and (cols[..., 3] == 255).all()


def test_gradient_map_refuses_a_mismatched_batch():
    r = torch.from_numpy(_ratios("default"))
    with pytest.raises(ValueError):
        tc.gradient_map(torch.zeros(3, 8), torch.zeros(2, 6, 3), r)
    with pytest.raises(ValueError):
        tc.gradient_map(torch.zeros(3, 8), torch.zeros(6), r)


@pytest.mark.parametrize("tables", ["one", "per_pair"])
@pytest.mark.parametrize("pairs", [1, 3])
@pytest.mark.parametrize("name", list(RATIO_SETS))
def test_spectrogram_columns_on_cpu_is_the_plain_version(name, pairs, tables):
    """On the CPU the wrapper is the plain version byte for byte, on seeded
    intensities and on every branch's, and launches nothing."""
    r = torch.from_numpy(_ratios(name))
    bounds = tc.gradient_bounds(r)
    x = intensities(np.random.default_rng(20 + pairs), (pairs, 20, 96), bounds.numpy())
    branch = branch_values(bounds.numpy())
    x[:, 0, : len(branch)] = branch
    x = torch.from_numpy(x)
    if tables == "one":
        colours = torch.from_numpy(DEFAULT_GRADIENT)
    else:
        colours = torch.from_numpy(np.stack([SpectrogramProcessor._rotate(DEFAULT_GRADIENT, p, pairs)
                                             for p in range(pairs)]))
    before = counter("colormap.launches")
    got = tc.spectrogram_columns(x, colours, r, bounds)
    want = tc.spectrogram_columns_plain(x, colours, r, bounds)
    assert got.dtype == torch.uint8 and got.shape == (20, 96, 4)
    assert torch.equal(got, want)
    assert torch.equal(tc.spectrogram_columns(x, colours, r), want)
    assert counter("colormap.launches") == before


def test_max_stops_is_the_kernels():
    """The wrapper refuses more stops than the kernel holds: its limit is a
    copy of ``kMaxStops`` in csrc/colormap.cu, and holds the program's
    gradient."""
    source = (Path(tc.__file__).resolve().parent.parent / "csrc" / "colormap.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", source)}
    assert tc.MAX_STOPS == consts["kMaxStops"]
    assert tc.MAX_STOPS >= tc.NUM_SPECTRUM_COLOURS + 1 == len(DEFAULT_GRADIENT)


def test_cuda_wrapper_refuses_float64_and_too_many_stops():
    """On a GPU the wrapper launches the kernel or raises: float64 inputs
    and more than ``MAX_STOPS`` stops are refused (no plain fallback)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    r = torch.from_numpy(_ratios("default")).to(dev)
    x = torch.rand(1, 4, 8, device=dev)
    colours = torch.from_numpy(DEFAULT_GRADIENT).to(dev)
    with pytest.raises(ValueError, match="float32"):
        tc.spectrogram_columns(x.double(), colours, r)
    with pytest.raises(ValueError, match="float32"):
        tc.spectrogram_columns(x, colours.double(), r)
    many = tc.MAX_STOPS + 1
    r_many = torch.from_numpy(tc.normalize_ratios(np.ones(many)).astype(np.float32)).to(dev)
    with pytest.raises(ValueError, match="stops"):
        tc.spectrogram_columns(x, torch.rand(many, 3, device=dev), r_many)


def colormap_model(v: np.ndarray, colours: np.ndarray, bounds: np.ndarray, max_stops: int) -> np.ndarray:
    """csrc/colormap.cu's arithmetic in numpy float32, one rounding an
    operation as the kernel writes it: the count search against bounds
    padded with +inf, the mix, the lerp, both rules, the product in pair
    order, the quantize. ``v`` [pairs, T, P]; ``colours`` [pairs, S, 3]."""
    f = np.float32
    s = bounds.shape[0]
    padded = np.concatenate([bounds, np.full(max_stops - s, np.inf, np.float32)])
    acc = np.ones(v.shape[1:] + (3,), np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        for pair in range(v.shape[0]):
            x = v[pair]
            x = np.where(x < 0, f(0), np.where(x > 1, f(1), x))
            seg = sum((~(padded[i] >= x)).astype(np.int64) for i in range(max_stops))
            seg = np.clip(seg, 1, s - 1)
            lo, hi = bounds[seg - 1], bounds[seg]
            width = hi - lo
            q = (x - lo) / np.where(width > f(1e-20), width, f(1e-20))
            mix = np.where(hi > lo, q, f(1))
            keep = f(1) - mix
            tab = colours[pair]
            rgb = tab[seg - 1] * keep[..., None] + tab[seg] * mix[..., None]
            rgb = np.where((x >= f(0.999))[..., None], tab[-1], rgb)
            rgb = np.where((v[pair] < 0)[..., None], f(0), rgb)
            acc = acc * (f(1) - rgb)
        y = f(1) - acc
        y = np.where(y < 0, f(0), np.where(y > 1, f(1), y))
        q8 = (y * f(255)).astype(np.int64).astype(np.uint8)
    return np.concatenate([q8, np.full(q8.shape[:-1] + (1,), 255, np.uint8)], axis=-1)


@pytest.mark.parametrize("pairs", [1, 3])
@pytest.mark.parametrize("name", list(RATIO_SETS))
def test_kernel_arithmetic_model_is_the_plain_version(name, pairs):
    """The kernel's order of operations, modelled in numpy, gives the plain
    path's bytes on the CPU: exactly at one pair (NaN included), by the
    byte rule at three (the pair order of the product)."""
    r = torch.from_numpy(_ratios(name))
    bounds = tc.gradient_bounds(r)
    x = intensities(np.random.default_rng(30 + pairs), (pairs, 16, 128), bounds.numpy())
    branch = np.concatenate([branch_values(bounds.numpy()), np.float32([np.nan])])
    x[:, 0, : len(branch)] = branch
    tables = np.stack([SpectrogramProcessor._rotate(DEFAULT_GRADIENT, p, pairs) for p in range(pairs)])
    got = colormap_model(x, tables, bounds.numpy(), tc.MAX_STOPS)
    want = tc.spectrogram_columns_plain(torch.from_numpy(x), torch.from_numpy(tables), r, bounds).numpy()
    if pairs == 1:
        assert np.array_equal(got, want)
    else:
        assert_bytes_close(got, want)
