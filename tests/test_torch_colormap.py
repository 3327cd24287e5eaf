"""The PyTorch port's spectrogram colour map against the JAX package on the
CPU. Inputs are made with numpy from a seed and handed to both. The segment
bounds are held bit-equal; float colours to 2e-6; RGBA8 bytes by the byte
rule: quantization truncates, so an ulp in a colour can flip a byte by one,
hence every byte within 1 LSB, at most 0.1% of bytes different, and alpha
exactly 255."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.kernels import colormap as jc
from signalizer_tpu.views.spectrogram import DEFAULT_GRADIENT as J_GRADIENT
from signalizer_tpu.views.spectrogram import DEFAULT_RATIOS as J_RATIOS
from signalizer_tpu_torch.kernels import colormap as tc
from signalizer_tpu_torch.views.spectrogram import DEFAULT_GRADIENT, DEFAULT_RATIOS

RATIO_SETS = {
    "default": DEFAULT_RATIOS,
    "uneven": np.asarray([0.0, 0.05, 0.4, 0.1, 0.3, 0.15], np.float32),
    "thirds": np.asarray([0.0, 1.0, 1.0, 1.0, 0.0, 0.0], np.float32),
    "with_zero_segment": np.asarray([0.0, 0.3, 0.0, 0.3, 0.2, 0.2], np.float32),
}


def assert_bytes_close(got: np.ndarray, want: np.ndarray):
    """The byte rule of the module docstring."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert (got[..., 3] == 255).all() and (want[..., 3] == 255).all()
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, f"a byte differs by {diff.max()}"
    assert (diff != 0).mean() <= 1e-3, f"{(diff != 0).mean():.2%} of bytes differ"


def _ratios(name):
    return jc.normalize_ratios(RATIO_SETS[name]).astype(np.float32)


def intensities(rng, shape, bounds):
    """Seeded intensities in [-0.2, 1.2] with values on both sides of 0,
    0.999 and 1, and on every segment bound."""
    x = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    flat = x.reshape(-1)
    special = np.concatenate([
        np.float32([0.0, -0.0, -1e-7, 1e-7, 0.999, np.nextafter(np.float32(0.999), np.float32(0)),
                    np.nextafter(np.float32(0.999), np.float32(2)), 1.0, 1.0001, -1.0]),
        bounds, np.nextafter(bounds, np.float32(-1)), np.nextafter(bounds, np.float32(2)),
    ]).astype(np.float32)
    flat[: len(special)] = special
    return x


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
