"""Inputs shared by the colour map's CPU tests (``test_torch_colormap.py``)
and its card tests (``test_torch_cuda.py``): numpy only, no jax."""

import numpy as np

from signalizer_tpu_torch.views.spectrogram import DEFAULT_RATIOS

RATIO_SETS = {
    "default": DEFAULT_RATIOS,
    "uneven": np.asarray([0.0, 0.05, 0.4, 0.1, 0.3, 0.15], np.float32),
    "thirds": np.asarray([0.0, 1.0, 1.0, 1.0, 0.0, 0.0], np.float32),
    "with_zero_segment": np.asarray([0.0, 0.3, 0.0, 0.3, 0.2, 0.2], np.float32),
}


def branch_values(bounds) -> np.ndarray:
    """Intensities on each branch of the colour map: below 0 (-inf
    included), exactly 0 and -0, on, just under and just over every
    segment bound, just under and at 0.999, 1 and above (+inf included)."""
    bounds = np.asarray(bounds, np.float32)
    full = np.float32(0.999)
    return np.concatenate([
        np.float32([-np.inf, -1.0, -1e-7, -1e-30, 0.0, -0.0, 1e-30, 1e-7, np.nextafter(full, np.float32(0)), full,
                    np.nextafter(full, np.float32(2)), 1.0, 1.0001, 7.5, np.inf]),
        bounds, np.nextafter(bounds, np.float32(-1)), np.nextafter(bounds, np.float32(2)),
    ]).astype(np.float32)


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
