"""Colour utilities: hue rotation for multi-pair displays, legends.

Equivalents of the reference's ColourRotation / FloatColour / LegendCache
(ref: Source/Common/CommonSignalizer.h:921-954, :990-1081, :1139-1163):
channel pair k of n gets the base colour hue-rotated by k/n so overlaid
pairs stay distinguishable.

The port's own copy of :mod:`signalizer_tpu.utils.colour`, arithmetic and names unchanged;
tests/test_torch_params_state.py holds the two equal.
"""

from __future__ import annotations

import colorsys
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np


def with_rotated_hue(rgb: Sequence[float], rotation: float) -> Tuple[float, float, float]:
    """ref: juce Colour::withRotatedHue as used by ColourRotation."""
    h, l, s = colorsys.rgb_to_hls(*rgb[:3])
    return colorsys.hls_to_rgb((h + rotation) % 1.0, l, s)


class ColourRotation:
    """Indexable rotated-palette (ref: ColourRotation — base colour +
    ``base.withRotatedHue(index / size)``, CommonSignalizer.h:936)."""

    def __init__(self, base: Sequence[float], size: int, dont_rotate_first: bool = False):
        self.base = tuple(float(c) for c in base[:3])
        self.size = max(1, size)
        self.dont_rotate_first = dont_rotate_first
        self._table = np.asarray(
            [
                self.base
                if (i == 0 and dont_rotate_first) or self.size == 1
                else with_rotated_hue(self.base, i / self.size)
                for i in range(self.size)
            ],
            np.float32,
        )

    def __getitem__(self, index: int) -> np.ndarray:
        return self._table[index % self.size]

    def as_array(self) -> np.ndarray:
        return self._table


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


@dataclass
class LegendEntry:
    name: str
    colour: Tuple[float, float, float]


@dataclass
class Legend:
    """Channel legend (ref: LegendCache — cached text + swatch list)."""

    entries: List[LegendEntry] = field(default_factory=list)

    @classmethod
    def for_pairs(
        cls,
        channel_names: Sequence[str],
        base_colour: Sequence[float],
        pairs: int,
        secondary_colour: Sequence[float] = None,
    ) -> "Legend":
        """Left channels take the primary colour, right channels the
        secondary (ref: Oscilloscope.cpp:322/326 primaryRotation[c] vs
        secondaryRotation[c]), each hue-rotated per pair."""
        rot = ColourRotation(base_colour, max(pairs, 1))
        rot2 = (
            ColourRotation(secondary_colour, max(pairs, 1))
            if secondary_colour is not None
            else rot
        )
        entries = []
        for i, name in enumerate(channel_names):
            table = rot if i % 2 == 0 else rot2
            entries.append(LegendEntry(name, tuple(table[i // 2])))
        return cls(entries)
