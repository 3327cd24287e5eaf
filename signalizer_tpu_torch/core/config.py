"""Stream limits and the channel, interpolation, scaling and algorithm
enums of the port.

The port's own copy of the stream constants, the enums and ``next_pow2`` of
:mod:`signalizer_tpu.core.config` (ref: Source/Config/
SignalizerConfiguration.h:60-62 and the channel enums in
Source/Common/CommonSignalizer.h:458-539), with the same names and values:
the enums are ``IntEnum``s, so a member of either package compares equal to
its counterpart. Tests hold the two sets equal.
"""

from __future__ import annotations

import enum

# ref: SignalizerConfiguration.h:60-62 — AudioStream<float, 256>, 16 channels.
MAX_INPUT_CHANNELS: int = 16
STREAM_PACKET_SIZE: int = 256
DEFAULT_HISTORY_SIZE: int = 48_000  # ref: ConcurrentConfig.h:41-43


class OscChannels(enum.IntEnum):
    """Oscilloscope channel interpretation (ref: CommonSignalizer.h:458-494)."""

    LEFT = 0
    RIGHT = 1
    MERGE = 2  # (L + R), aka MID
    MID = 2
    SIDE = 3  # (L - R)
    OFFSET_FOR_MONO = 3  # configs above this need >1 channel
    SEPARATE = 4
    MIDSIDE = 5

    @property
    def is_mono(self) -> bool:
        return self <= OscChannels.OFFSET_FOR_MONO


class SpectrumChannels(enum.IntEnum):
    """Spectrum channel interpretation (ref: CommonSignalizer.h:495-539)."""

    LEFT = 0
    RIGHT = 1
    MERGE = 2  # (L + R)/2, aka MID
    MID = 2
    SIDE = 3  # (L - R)/2
    OFFSET_FOR_MONO = 3
    PHASE = 4  # mid magnitude + phase-cancellation graph
    SEPARATE = 5  # two magnitude rows (L, R)
    MIDSIDE = 6  # two magnitude rows (mid, side)
    COMPLEX = 7  # ch1 + i*ch2 as one complex sequence, full circle 0..fs

    @property
    def is_mono(self) -> bool:
        return self <= SpectrumChannels.OFFSET_FOR_MONO

    @property
    def state_channels(self) -> int:
        """Result rows produced (ref: TransformConstant.h:183-186)."""
        return 2 if self > SpectrumChannels.OFFSET_FOR_MONO else 1


class BinInterpolation(enum.IntEnum):
    """Bin→pixel interpolation (ref: SpectrumParameters.h binInterpolation)."""

    NONE = 0  # nearest bin (+0.5 centering)
    LINEAR = 1
    LANCZOS = 2  # Lanczos-5 windowed sinc


class ViewScaling(enum.IntEnum):
    """Frequency axis scaling (ref: SpectrumParameters.h viewScaling)."""

    LINEAR = 0
    LOGARITHMIC = 1


class DisplayMode(enum.IntEnum):
    """Spectrum display mode (ref: SpectrumParameters.h displayMode)."""

    LINE_GRAPH = 0
    COLOUR_SPECTRUM = 1  # spectrogram


class TransformAlgorithm(enum.IntEnum):
    """Spectrum analysis algorithm (ref: SpectrumParameters.h algorithm)."""

    FFT = 0
    RESONATOR = 1  # constant-Q complex resonator bank ("RSNT")


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (ref: cpl Math::nextPow2Inc semantics)."""
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())
