"""Hue rotation for multi-pair displays.

The port's own copy of ``with_rotated_hue`` and ``pair_key_table`` from
:mod:`signalizer_tpu.utils.colour` (ref: ColourRotation,
Source/Common/CommonSignalizer.h:921-954): channel pair k of n gets the
base colour hue-rotated by k/n so overlaid pairs stay distinguishable.
Tests hold the table bit-equal to the JAX package's.
"""

from __future__ import annotations

import colorsys
from typing import Sequence, Tuple

import numpy as np


def with_rotated_hue(rgb: Sequence[float], rotation: float) -> Tuple[float, float, float]:
    """ref: juce Colour::withRotatedHue as used by ColourRotation."""
    h, l, s = colorsys.rgb_to_hls(*rgb[:3])
    return colorsys.hls_to_rgb((h + rotation) % 1.0, l, s)


def pair_key_table(primary, secondary, pairs: int) -> np.ndarray:
    """Per-pair oscilloscope key colours: pair 0 keeps the user's
    primary/secondary, pairs beyond hue-rotate both by ``p / pairs``
    (ref: CHANGELOG 0.4.0 "colours beyond the first pair are automatically
    distinct but based on the primary pair"; ColourRotation,
    CommonSignalizer.h:936). Returns [pairs, 2, 3] float32."""
    out = np.empty((max(1, pairs), 2, 3), np.float32)
    for p in range(max(1, pairs)):
        rot = p / max(1, pairs)
        out[p, 0] = with_rotated_hue(primary, rot) if p else tuple(primary[:3])
        out[p, 1] = with_rotated_hue(secondary, rot) if p else tuple(secondary[:3])
    return out
