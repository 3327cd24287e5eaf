"""Composite parameter bundles: colour, window design, power slope, 3D
transform (ref: cpl values — ParameterColourValue, ParameterWindowDesignValue,
ParameterPowerSlopeValue, ParameterTransformValue; SURVEY.md §2.9).

The port's own copy of :mod:`signalizer_tpu.params.values`, arithmetic and names unchanged;
tests/test_torch_params_state.py holds the two equal.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from signalizer_tpu_torch.core.windows import WindowType, generate_window
from signalizer_tpu_torch.params.parameters import (
    BasicFormatter,
    BooleanFormatter,
    BooleanRange,
    ChoiceFormatter,
    ExponentialRange,
    IntegerLinearRange,
    LinearRange,
    Parameter,
    PercentageFormatter,
    UnitFormatter,
    UnityRange,
)


class ColourValue:
    """RGBA parameter bundle (ref: ParameterColourValue)."""

    def __init__(self, name: str, default=(1.0, 1.0, 1.0, 1.0)):
        self.name = name
        fmt = PercentageFormatter()
        self.r = Parameter(f"{name}.R", UnityRange(), fmt, default[0])
        self.g = Parameter(f"{name}.G", UnityRange(), fmt, default[1])
        self.b = Parameter(f"{name}.B", UnityRange(), fmt, default[2])
        self.a = Parameter(f"{name}.A", UnityRange(), fmt, default[3])

    def parameters(self) -> List[Parameter]:
        return [self.r, self.g, self.b, self.a]

    def get_rgba(self) -> Tuple[float, float, float, float]:
        return (
            self.r.get_transformed(),
            self.g.get_transformed(),
            self.b.get_transformed(),
            self.a.get_transformed(),
        )

    def get_rgb(self) -> np.ndarray:
        return np.asarray(self.get_rgba()[:3], np.float32)

    def set_rgba(self, rgba) -> None:
        for p, v in zip(self.parameters(), rgba):
            p.set_transformed(float(v))


class WindowDesignValue:
    """DSP window designer (ref: ParameterWindowDesignValue +
    generateWindow<T>, used at TransformConstant.h:104-107)."""

    WINDOW_NAMES = [w.name.lower().replace("_", " ") for w in WindowType]

    def __init__(self, name: str, default: WindowType = WindowType.HANN):
        self.name = name
        self.window_type = Parameter(
            f"{name}.Type",
            IntegerLinearRange(0, len(WindowType) - 1),
            ChoiceFormatter(self.WINDOW_NAMES),
            int(default) / max(len(WindowType) - 1, 1),
        )
        self.alpha = Parameter(f"{name}.Alpha", LinearRange(0.0, 10.0), BasicFormatter(), 0.25)
        self.beta = Parameter(f"{name}.Beta", LinearRange(0.0, 20.0), BasicFormatter(), 0.4)
        self.symmetric = Parameter(
            f"{name}.Symmetric", BooleanRange(), BooleanFormatter(), 1.0
        )

    def parameters(self) -> List[Parameter]:
        return [self.window_type, self.alpha, self.beta, self.symmetric]

    def get_window_type(self) -> WindowType:
        return WindowType(int(round(self.window_type.get_transformed())))

    def generate_window(self, size: int) -> Tuple[np.ndarray, float]:
        """Returns (kernel, scale) — scale is the reciprocal coherent gain
        (the reference returns windowKernelScale the same way)."""
        return generate_window(
            self.get_window_type(),
            size,
            symmetric=self.symmetric.get_transformed() > 0.5,
            alpha=self.alpha.get_transformed(),
            beta=self.beta.get_transformed(),
        )


class PowerSlopeValue:
    """Power-law spectrum tilt (ref: ParameterPowerSlopeValue; derive() ->
    {a, b} consumed by generateSlopeMap, TransformConstant.h:109-118).

    slope is dB per octave-of-``base``; pivot is the unity-gain frequency:
    m(f) = b * f^a with a = slope / (20 log10(base)), b = pivot^-a.
    """

    def __init__(self, name: str):
        self.name = name
        self.base = Parameter(f"{name}.Base", LinearRange(2.0, 10.0), BasicFormatter(), 0.0)
        self.pivot = Parameter(
            f"{name}.Pivot", ExponentialRange(10.0, 20_000.0), UnitFormatter("Hz"), 0.5
        )
        self.slope = Parameter(
            f"{name}.Slope", LinearRange(-30.0, 30.0), UnitFormatter("dB/oct"), 0.5
        )

    def parameters(self) -> List[Parameter]:
        return [self.base, self.pivot, self.slope]

    def derive(self) -> Tuple[float, float]:
        base = self.base.get_transformed()
        pivot = self.pivot.get_transformed()
        slope = self.slope.get_transformed()
        a = slope / (20.0 * math.log10(base))
        b = pivot ** (-a)
        return a, b


class TransformValue:
    """3x3 3D transform bundle: position/rotation/scale xyz
    (ref: ParameterTransformValue, used by the vectorscope's 3D view)."""

    AXES = ("X", "Y", "Z")

    def __init__(self, name: str):
        self.name = name
        self.position = [
            Parameter(f"{name}.Pos.{ax}", LinearRange(-1.0, 1.0), BasicFormatter(), 0.5)
            for ax in self.AXES
        ]
        self.rotation = [
            Parameter(f"{name}.Rot.{ax}", LinearRange(0.0, 360.0), UnitFormatter("deg"), 0.0)
            for ax in self.AXES
        ]
        self.scale = [
            Parameter(f"{name}.Scale.{ax}", LinearRange(0.0, 4.0), BasicFormatter(), 0.25)
            for ax in self.AXES
        ]

    def parameters(self) -> List[Parameter]:
        return [*self.position, *self.rotation, *self.scale]

    def matrix(self) -> np.ndarray:
        """Compose rotation (XYZ Euler, degrees) and scale into 3x3."""
        rx, ry, rz = (math.radians(p.get_transformed()) for p in self.rotation)
        sx, sy, sz = (p.get_transformed() for p in self.scale)

        def rot_x(a):
            c, s = math.cos(a), math.sin(a)
            return np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]])

        def rot_y(a):
            c, s = math.cos(a), math.sin(a)
            return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])

        def rot_z(a):
            c, s = math.cos(a), math.sin(a)
            return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])

        return (rot_z(rz) @ rot_y(ry) @ rot_x(rx)) @ np.diag([sx, sy, sz])

    def translation(self) -> np.ndarray:
        return np.asarray([p.get_transformed() for p in self.position])
