"""The port keeps its own copies of the JAX package's jax-free helpers
(enums, windows, the decay-pole design, ``TimeMode``, the key-colour table):
each copy against its original, on the CPU. This is the only port test
that imports those modules of the JAX package."""

import enum

import numpy as np
import pytest

from signalizer_tpu.core import config as jconfig
from signalizer_tpu.core import scaling as jscaling
from signalizer_tpu.core import windows as jwindows
from signalizer_tpu.params import transformatters as jtransformatters
from signalizer_tpu.utils import colour as jcolour
from signalizer_tpu_torch.core import config as tconfig
from signalizer_tpu_torch.core import scaling as tscaling
from signalizer_tpu_torch.core import windows as twindows
from signalizer_tpu_torch.params import transformatters as ttransformatters
from signalizer_tpu_torch.utils import colour as tcolour


def _same_enum(ours, theirs):
    assert issubclass(ours, enum.IntEnum) and ours is not theirs
    # __members__ includes aliases (MID, OFFSET_FOR_MONO)
    assert {k: int(v) for k, v in ours.__members__.items()} == {
        k: int(v) for k, v in theirs.__members__.items()
    }
    for name, member in ours.__members__.items():
        assert member == theirs[name] and hash(member) == hash(theirs[name])


@pytest.mark.parametrize(
    "name",
    ["OscChannels", "SpectrumChannels", "BinInterpolation", "ViewScaling", "DisplayMode", "TransformAlgorithm"],
)
def test_config_enums_equal_the_jax_package(name):
    ours, theirs = getattr(tconfig, name), getattr(jconfig, name)
    _same_enum(ours, theirs)
    for member in ours:
        for prop in ("is_mono", "state_channels"):
            if hasattr(member, prop):
                assert getattr(member, prop) == getattr(theirs(member), prop), (member, prop)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 24, 255, 256, 257, 4096, 20000, 2**20 + 1])
def test_next_pow2_equals_the_jax_package(n):
    assert tconfig.next_pow2(n) == jconfig.next_pow2(n)


@pytest.mark.parametrize("size", [8, 255, 4096])
@pytest.mark.parametrize("wtype", list(jwindows.WindowType), ids=lambda w: w.name)
def test_generate_window_is_bit_equal(wtype, size):
    """Every window type at the keyword variants the constant passes
    (symmetric and periodic, alpha, beta): kernels and scales identical."""
    _same_enum(twindows.WindowType, jwindows.WindowType)
    for kw in (
        {},
        dict(symmetric=False),
        dict(symmetric=True, alpha=2.5, beta=8.0),
        dict(symmetric=False, alpha=1.25, beta=3.0),
    ):
        ours, scale = twindows.generate_window(twindows.WindowType(wtype), size, **kw)
        theirs, jscale = jwindows.generate_window(wtype, size, **kw)
        assert ours.dtype == theirs.dtype == np.float64
        assert np.array_equal(ours, theirs), kw
        assert scale == jscale
        assert twindows.window_scale(twindows.WindowType(wtype), size, **kw) == jscale
    if wtype in jwindows.FINITE_DFT_WINDOWS:
        assert twindows.window_coefficients(twindows.WindowType(wtype)) == jwindows.window_coefficients(wtype)
    else:
        with pytest.raises(KeyError):
            twindows.window_coefficients(twindows.WindowType(wtype))


@pytest.mark.parametrize("fps", [0.0, 30.0, 60.0, 93.75])
@pytest.mark.parametrize("seconds", [-1.0, 0.0, 0.01, 0.1, 1.0, 7.5])
def test_peak_decay_pole_is_bit_equal(seconds, fps):
    assert tscaling.peak_decay_pole(seconds, fps) == jscaling.peak_decay_pole(seconds, fps)
    assert tscaling.peak_decay_pole(seconds, fps, 0.5) == jscaling.peak_decay_pole(seconds, fps, 0.5)


def test_time_mode_equals_the_jax_package():
    _same_enum(ttransformatters.TimeMode, jtransformatters.TimeMode)


@pytest.mark.parametrize("pairs", [0, 1, 2, 5, 16])
@pytest.mark.parametrize(
    "primary,secondary",
    [
        ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0)),
        ((0.9, 0.2, 0.1), (0.1, 0.4, 0.8)),
        ((0.3, 0.3, 0.3, 1.0), (0.0, 1.0, 0.5, 0.5)),
    ],
    ids=["white", "red_blue", "rgba"],
)
def test_pair_key_table_is_bit_equal(primary, secondary, pairs):
    ours = tcolour.pair_key_table(primary, secondary, pairs)
    theirs = jcolour.pair_key_table(primary, secondary, pairs)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape
    assert np.array_equal(ours, theirs)
    assert tcolour.with_rotated_hue(primary, 0.37) == jcolour.with_rotated_hue(primary, 0.37)
