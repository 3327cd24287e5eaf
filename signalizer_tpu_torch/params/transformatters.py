"""The oscilloscope's time mode.

The port's own copy of ``TimeMode`` from
:mod:`signalizer_tpu.params.transformatters`, same names and values. The
transformatters themselves (value <-> text maps of the parameter layer)
come with the engine's entry points.
"""

from __future__ import annotations

import enum


class TimeMode(enum.IntEnum):
    """ref: OscilloscopeParameters.h:60-63."""

    TIME = 0
    CYCLES = 1
    BEATS = 2
