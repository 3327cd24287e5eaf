"""Editor page layouts as data — the Controllers' data model.

The reference's SpectrumController / OscilloscopeController /
VectorscopeController are JUCE editor pages binding widgets to parameters
(ref: SpectrumController.cpp:262-367, OscilloscopeController.cpp:222-306,
VectorscopeController.cpp:149-210). The widgets are GUI scope; the *page
structure* — which parameters appear on which page/section, in which
column — is information any embedding UI needs to rebuild the same
editor, so it ships here as plain data keyed by the Contents' parameter
base names (a ``Control`` with name ``"Line0One"`` refers to the whole
colour bundle registered under that prefix).

``layout_for(content)`` returns the matching layout;
tests/test_knob_inventory.py asserts every referenced name resolves to a
registered parameter or bundle.

The port's own copy of :mod:`signalizer_tpu.views.controllers`, arithmetic and names unchanged;
tests/test_torch_params_state.py holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class Control:
    """One widget slot: the parameter/bundle base name + matrix column
    (ref: MatrixSection::addControl(param, column))."""

    name: str
    column: int = 0
    special: str = ""  # non-parameter widgets: "presets", "tracker"


@dataclass(frozen=True)
class Section:
    name: str
    controls: Tuple[Control, ...]


@dataclass(frozen=True)
class Page:
    name: str
    icon: str  # the reference's svg icon role
    sections: Tuple[Section, ...]


def _c(*pairs) -> Tuple[Control, ...]:
    return tuple(Control(n, col) for n, col in pairs)


# ref: VectorscopeController.cpp:149-210
VECTORSCOPE_LAYOUT: Tuple[Page, ...] = (
    Page("Settings", "gear", (
        Section("Transform", _c(("Transform", 0))),
        Section("Utility", _c(
            ("AutoGain", 0), ("EnvelopeWindow", 0), ("InputGain", 0),
            ("OperationalMode", 1), ("StereoWindow", 1),
            ("WaveZRotation", 0), ("WindowSize", 1),
        )),
    )),
    Page("Rendering", "brush", (
        Section("Options", _c(
            ("Antialias", 0), ("FadeOlderPoints", 1), ("InterconnectSamples", 2),
        )),
        Section("Look", _c(
            ("DrawingColour", 0), ("GraphColour", 0), ("BackgroundColour", 0),
            ("SkeletonColour", 0), ("MeterColour", 1), ("WidgetColour", 1),
            ("PrimitiveSize", 1),
        )),
    )),
    Page("Utility", "wrench", (
        Section("Presets", (Control("", 0, special="presets"),)),
        Section("Options", _c(("Diagnostics", 0), ("ScalePolarModeToFill", 1))),
    )),
)

# ref: OscilloscopeController.cpp:222-306
OSCILLOSCOPE_LAYOUT: Tuple[Page, ...] = (
    Page("Settings", "gear", (
        Section("Options", _c(("OverlayChannels", 0), ("CursorTracker", 1))),
        Section("Utility", _c(
            ("InputGain", 0), ("ChannelConfiguration", 1),
            ("EnvelopeWindow", 0), ("AutoGain", 1), ("PctDivision", 0),
        )),
        Section("Spatial", _c(
            ("WindowSize", 0), ("TimeMode", 1),
            ("TriggerMode", 0), ("TriggerPhase", 1),
            ("TThreshold", 0), ("THysteresis", 1),
            ("CustomTriggerFrequency", 0), ("CustomTrigger", 1),
            ("TriggeringChannel", 0),
        )),
    )),
    Page("Rendering", "brush", (
        Section("Options", _c(("Antialias", 0), ("Diagnostics", 1), ("DotSamples", 2))),
        Section("Look", _c(
            ("PrimitiveSize", 0), ("SampleInterpolation", 1),
            ("GraphColour", 0), ("BackgroundColour", 1), ("WidgetColour", 0),
        )),
        Section("Spectral colouring", _c(
            ("ColourSmoothing", 0), ("ChannelColouring", 1),
            ("PrimaryColour", 0), ("SecondaryColour", 1),
            ("FColourBlend", 0), ("LowColour", 1),
            ("MidColour", 0), ("HighColour", 1),
        )),
    )),
    Page("Utility", "wrench", (
        Section("Presets", (Control("", 0, special="presets"),)),
    )),
)

# ref: SpectrumController.cpp:262-367
SPECTRUM_LAYOUT: Tuple[Page, ...] = (
    Page("Settings", "gear", (
        Section("", _c(
            ("ViewScaling", 0), ("ChannelConfiguration", 0),
            ("DisplayMode", 1), ("FTracker", 1),
        )),
        Section("", _c(
            ("LowerBound", 1), ("UpperBound", 0), ("BlobSize", 0),
            ("WindowSize", 1), ("PctDivision", 0), ("SpectrumStretch", 1),
        )),
        Section("", _c(("Line0Decay", 0), ("Line1Decay", 1))),
    )),
    Page("Algorithm", "formulae", (
        Section("", _c(("Algorithm", 0), ("BinInterpolation", 1))),
        Section("", _c(("DspWin", 0),)),
        Section("", _c(("Slope", 0),)),
        Section("", _c(("FreeQ", 0),)),
    )),
    Page("Rendering", "brush", (
        Section("", _c(("Grid", 0), ("Bck", 1), ("Widget", 0))),
        Section("", _c(
            ("Line0One", 0), ("Line0Two", 1), ("Line1One", 0), ("Line1Two", 1),
        )),
        Section("", _c(
            ("Grad0", 0), ("GradRatio0", 1), ("Grad1", 0), ("GradRatio1", 1),
            ("Grad2", 0), ("GradRatio2", 1), ("Grad3", 0), ("GradRatio3", 1),
            ("Grad4", 0), ("GradRatio4", 1),
        )),
    )),
    Page("Utility", "wrench", (
        Section("", (Control("", 0, special="presets"),)),
        Section("", _c(
            ("FrameSmoothing", 0), ("PrimitiveSize", 1),
            ("FloodFillAlpha", 0), ("RefTuning", 1),
            ("TrackerSmoothing", 0), ("Diagnostics", 1),
        )),
    )),
)


def layout_for(content) -> Tuple[Page, ...]:
    """The editor layout matching a Content instance."""
    name = getattr(content, "NAME", "")
    return {
        "Spectrum": SPECTRUM_LAYOUT,
        "Oscilloscope": OSCILLOSCOPE_LAYOUT,
        "Vectorscope": VECTORSCOPE_LAYOUT,
    }[name]


def layout_parameter_names(layout: Tuple[Page, ...]) -> List[str]:
    """All parameter/bundle base names a layout references."""
    out: List[str] = []
    for page in layout:
        for section in page.sections:
            for control in section.controls:
                if control.name:
                    out.append(control.name)
    return out
