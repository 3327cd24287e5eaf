"""View parameter contents — the declarative parameter inventories.

Equivalents of the reference's per-view "Content" classes with the same
knobs, ranges, unit semantics and registration prefixes
(ref: Source/Spectrum/SpectrumParameters.h:38-441,
Source/Oscilloscope/OscilloscopeParameters.h,
Source/Vectorscope/VectorscopeParameters.h; registration order =
Vectorscope, Oscilloscope, Spectrum per MainEditor ContentCreationList,
Source/Editor/MainEditor.cpp:70-75).

Each Content exposes:
* a sealed :class:`ParameterSet` with the view's prefix ("VS."/"OS."/"SC.")
* ``serialize``/``deserialize`` (versioned keyed tree)
* a factory producing the view's device configuration (e.g.
  ``SpectrumContent.make_constant()``), the bridge from knobs to kernels.

The port's copy of :mod:`signalizer_tpu.views.content`: the knobs, ranges,
defaults and serialization are unchanged (tests/test_torch_params_state.py
holds every parameter equal to the original's). Where a content reaches a
device or a view it is the port's: ``make_constant`` builds the constant on
the ``device`` it is given, ``make_render_feed`` reads the constant's host
copies (:func:`~signalizer_tpu_torch.core.constant.host_view`, never a
device tensor), and the processor keywords name the port's view enums.
"""

from __future__ import annotations

from signalizer_tpu_torch.core.config import (
    BinInterpolation,
    DisplayMode,
    OscChannels,
    SpectrumChannels,
    TransformAlgorithm,
    ViewScaling,
)
from signalizer_tpu_torch.core.constant import (
    MAX_DBS,
    MIN_DBS,
    NUM_LINE_GRAPHS,
    SpectrumConstant,
    make_spectrum_constant,
)
from signalizer_tpu_torch.params.parameters import (
    AmplitudeDBFormatter,
    BasicFormatter,
    BooleanFormatter,
    BooleanRange,
    ChoiceFormatter,
    DBFormatter,
    ExponentialRange,
    IntegerLinearRange,
    LinearRange,
    Parameter,
    ParameterSet,
    PercentageFormatter,
    ReverseUnityRange,
    UnitFormatter,
    UnityRange,
)
from signalizer_tpu_torch.params.transformatters import (
    AudioHistoryTransformatter,
    LinearHzFormatter,
    TimeMode,
    WindowSizeTransformatter,
)
from signalizer_tpu_torch.params.values import (
    ColourValue,
    PowerSlopeValue,
    TransformValue,
    WindowDesignValue,
)
from signalizer_tpu_torch.state.serialize import (
    Archive,
    SerializableObject,
    deserialize_parameter_set,
    serialize_parameter_set,
)

NUM_SPECTRUM_COLOURS = 5  # ref: SpectrumParameters.h:77


def _choice(name: str, options, default_index: int = 0) -> Parameter:
    n = len(options) - 1
    return Parameter(
        name,
        IntegerLinearRange(0, n),
        ChoiceFormatter(options),
        default_index / n if n else 0.0,
    )


def _decay_fraction_to_seconds(fraction: float) -> float:
    """Line-decay knob (the fraction reached after 0.1 s; ref:
    setDecayAsFraction(fraction, 0.1), Spectrum.cpp:393) -> the
    seconds-to-10% parameter our constant factory takes. Exact:
    pole^(0.1*fps) = fraction  <=>  0.1^(1/(t*fps)) = fraction^(1/(0.1*fps))
    with t = 0.1*ln(0.1)/ln(fraction)."""
    import math

    fraction = min(max(fraction, 1e-9), 1.0 - 1e-9)
    return 0.1 * math.log(0.1) / math.log(fraction)


class SpectrumContent(SerializableObject):
    """ref: SpectrumParameters.h:38-441 (~40 parameters)."""

    NAME = "Spectrum"
    PREFIX = "SC."

    def __init__(self, sample_rate: float = 48_000.0, history_capacity: int = 48_000):
        ps = self.parameter_set = ParameterSet(self.NAME, self.PREFIX)
        self.audio_history_transformatter = AudioHistoryTransformatter(
            sample_rate, history_capacity,
            mode=AudioHistoryTransformatter.Mode.SAMPLES,  # ref: Samples
        )
        dyn = LinearRange(MIN_DBS, MAX_DBS)

        self.view_scaling = ps.register_parameter(_choice("ViewScaling", ["linear", "logarithmic"], 1))
        self.algorithm = ps.register_parameter(_choice("Algorithm", ["FFT", "Resonator"]))
        self.channel_configuration = ps.register_parameter(
            _choice(
                "ChannelConfiguration",
                ["left", "right", "merge", "side", "phase", "separate", "mid/side", "complex"],
            )
        )
        self.display_mode = ps.register_parameter(_choice("DisplayMode", ["line graph", "colour spectrum"]))
        self.bin_interpolation = ps.register_parameter(_choice("BinInterpolation", ["none", "linear", "lanczos"], 2))
        # which data the cursor tracker peak-searches (ref:
        # SpectrumParameters.h:164-176 frequencyTrackingOptions: None /
        # Transform / Main graph / Aux graph i)
        self.frequency_tracker = ps.register_parameter(
            _choice("FTracker", ["none", "transform", "main graph", "aux graph 1"])
        )
        self.low_dbs = ps.register_parameter(Parameter("LowerBound", dyn, DBFormatter(), dyn.normalize(-96.0)))
        self.high_dbs = ps.register_parameter(Parameter("UpperBound", dyn, DBFormatter(), dyn.normalize(0.0)))
        # linear n*capacity transformatter (ref base); default lands the
        # classic 4096-sample analysis window
        self.window_size = ps.register_parameter(
            Parameter("WindowSize", self.audio_history_transformatter,
                      self.audio_history_transformatter,
                      min(4096.0 / max(history_capacity, 1), 1.0))
        )
        # ref: pctForDivision uses basicFormatter (SpectrumParameters.h:120)
        self.pct_for_division = ps.register_parameter(Parameter("PctDivision", UnityRange(), BasicFormatter(), 0.5))
        self.blob_size = ps.register_parameter(
            Parameter("BlobSize", ExponentialRange(0.5, 1000.0), UnitFormatter("ms"), 0.5)
        )
        self.frame_update_smoothing = ps.register_parameter(
            Parameter("FrameSmoothing", LinearRange(0.0, 0.996), BasicFormatter(), 0.1)
        )
        self.spectrum_stretching = ps.register_parameter(
            Parameter("SpectrumStretch", LinearRange(1.0, 20.0), BasicFormatter(), 0.0)
        )
        self.primitive_size = ps.register_parameter(
            Parameter("PrimitiveSize", LinearRange(0.01, 10.0), UnitFormatter("pts"), 0.1)
        )
        self.flood_fill_alpha = ps.register_parameter(
            Parameter("FloodFillAlpha", UnityRange(), PercentageFormatter(), 0.2)
        )
        self.reference_tuning = ps.register_parameter(
            Parameter("RefTuning", LinearRange(220.0, 880.0), UnitFormatter("Hz"), (440.0 - 220.0) / 660.0)
        )
        self.view_left = ps.register_parameter(Parameter("ViewLeft", UnityRange(), BasicFormatter(), 0.0))
        # reverseUnitRange: normalized 0 = right edge (ref:
        # SpectrumParameters.h:98,128 — automation 0->1 zooms inward)
        self.view_right = ps.register_parameter(Parameter("ViewRight", ReverseUnityRange(), BasicFormatter(), 0.0))
        self.free_q = ps.register_parameter(Parameter("FreeQ", BooleanRange(), BooleanFormatter(), 0.0))
        self.diagnostics = ps.register_parameter(Parameter("Diagnostics", BooleanRange(), BooleanFormatter(), 0.0))
        self.tracker_smoothing = ps.register_parameter(
            Parameter("TrackerSmoothing", LinearRange(0.0, 1000.0), UnitFormatter("ms"), 0.0)
        )
        self.show_legend = ps.register_parameter(Parameter("ShowLegend", BooleanRange(), BooleanFormatter(), 1.0))

        self.spec_ratios = [
            ps.register_parameter(Parameter(f"GradRatio{i}", UnityRange(), PercentageFormatter(), 0.5))
            for i in range(NUM_SPECTRUM_COLOURS)
        ]
        self.grid_colour = ps.register_bundle(ColourValue("Grid", (0.5, 0.5, 0.5, 1.0)))
        self.background_colour = ps.register_bundle(ColourValue("Bck", (0.0, 0.0, 0.0, 1.0)))
        # knob defaults = the classic dark->blue->green->yellow->red heat
        # map (the reference ships its gradient via presets; an unset
        # bundle must not mean an all-white spectrogram)
        grad_defaults = (
            (0.0, 0.0, 0.5, 1.0),
            (0.0, 0.5, 1.0, 1.0),
            (0.0, 1.0, 0.0, 1.0),
            (1.0, 1.0, 0.0, 1.0),
            (1.0, 0.0, 0.0, 1.0),
        )
        self.spec_colours = [
            ps.register_bundle(ColourValue(f"Grad{i}", grad_defaults[i]))
            for i in range(NUM_SPECTRUM_COLOURS)
        ]
        self.widget_colour = ps.register_bundle(ColourValue("Widget"))

        # 2 line graphs x (decay + 2 colours), ref: lines[LineEnd].
        # The knob's transformed value is the decay FRACTION reached after
        # 0.1 s (ref: unitRange + dbSecFormatter, SpectrumParameters.h:151;
        # consumed by setDecayAsFraction(fraction, 0.1), Spectrum.cpp:393);
        # default 0.794 ~= decay to 10% in 1 s
        self.lines = []
        for i in range(NUM_LINE_GRAPHS):
            decay = ps.register_parameter(
                Parameter(f"Line{i}Decay", UnityRange(), AmplitudeDBFormatter("dB/s"), 0.794)
            )
            one = ps.register_bundle(ColourValue(f"Line{i}One"))
            two = ps.register_bundle(ColourValue(f"Line{i}Two"))
            self.lines.append((decay, one, two))

        self.dsp_win = ps.register_bundle(WindowDesignValue("DspWin"))
        self.slope = ps.register_bundle(PowerSlopeValue("Slope"))
        ps.seal()

    def available_windows(self):
        """Window list by algorithm (ref: SpectrumController.cpp:136-169 —
        the resonator's windowed readout only supports finite-cosine-sum
        windows)."""
        from signalizer_tpu_torch.core.windows import FINITE_DFT_WINDOWS, WindowType

        if int(self.algorithm.get_transformed()) == int(TransformAlgorithm.RESONATOR):
            return tuple(FINITE_DFT_WINDOWS)
        return tuple(WindowType)

    # --- bridge to kernels ---------------------------------------------------
    def make_constant(self, *, axis_points: int, sample_rate: float = 48_000.0,
                      frames_per_second: float = 60.0, device=None) -> SpectrumConstant:
        """The spectrum constant of the current knobs on ``device``
        (``None``: the GPU, raising without one)."""
        a, b = self.slope.derive()
        return make_spectrum_constant(
            device=device,
            axis_points=axis_points,
            window_size=max(32, int(round(self.window_size.get_transformed()))),
            sample_rate=sample_rate,
            configuration=SpectrumChannels(int(self.channel_configuration.get_transformed())),
            bin_interpolation=BinInterpolation(int(self.bin_interpolation.get_transformed())),
            view_scaling=ViewScaling(int(self.view_scaling.get_transformed())),
            algo=TransformAlgorithm(int(self.algorithm.get_transformed())),
            display_mode=DisplayMode(int(self.display_mode.get_transformed())),
            window_type=self.dsp_win.get_window_type(),
            window_symmetric=self.dsp_win.symmetric.get_transformed() > 0.5,
            window_alpha=self.dsp_win.alpha.get_transformed(),
            window_beta=self.dsp_win.beta.get_transformed(),
            view_left=self.view_left.get_transformed(),
            view_right=self.view_right.get_transformed(),
            low_dbs=self.low_dbs.get_transformed(),
            high_dbs=self.high_dbs.get_transformed(),
            clip_db=MIN_DBS,
            slope_a=a,
            slope_b=b,
            decay_seconds=tuple(
                _decay_fraction_to_seconds(l[0].get_transformed()) for l in self.lines
            ),
            frames_per_second=frames_per_second,
        )

    def make_render_feed(self, constant: SpectrumConstant, *, pairs: int = 1):
        """Line-graph vertex/legend feed with the render knobs applied
        (ref: renderTransformAsGraph, SpectrumRendering.cpp:793-897 —
        consumes floodFillAlpha, primitiveSize, line colours, showLegend,
        grid/background colours)."""
        from signalizer_tpu_torch.core.constant import host_view
        from signalizer_tpu_torch.views.line_graph import LineGraphRenderFeed

        return LineGraphRenderFeed(
            mapped_frequencies=host_view(constant, "mapped_frequencies"),
            line_colours=[
                (one.get_rgba(), two.get_rgba()) for _, one, two in self.lines
            ],
            pairs=pairs,
            flood_fill_alpha=self.flood_fill_alpha.get_transformed(),
            primitive_size=self.primitive_size.get_transformed(),
            show_legend=self.show_legend.get_transformed() > 0.5,
            grid_colour=self.grid_colour.get_rgba(),
            background_colour=self.background_colour.get_rgba(),
            low_dbs=self.low_dbs.get_transformed(),
            high_dbs=self.high_dbs.get_transformed(),
            divisions_pct=self.pct_for_division.get_transformed(),
            configuration=SpectrumChannels(
                int(self.channel_configuration.get_transformed())
            ),
        )

    def make_gradient(self):
        """Spectrogram gradient from the knobs: (colours [6, 3], ratios
        [6]) — stop 0 is the background colour at intensity 0, stops 1-5
        the five Grad colours over the normalized GradRatio widths
        (ref: specColours/specRatios consumed by blendAndDispatchSpectrums,
        SpectrumDSP.cpp:119-169)."""
        import numpy as np

        colours = np.asarray(
            [self.background_colour.get_rgba()[:3]]
            + [c.get_rgba()[:3] for c in self.spec_colours],
            np.float32,
        )
        ratios = np.asarray(
            [0.0] + [r.get_transformed() for r in self.spec_ratios], np.float32
        )
        return colours, ratios

    def make_render_hints(self) -> dict:
        """View-shell settings the GL renderer consumes in the reference
        (SpectrumRendering.cpp overlay/grid setup); the viewer applies
        them."""
        return dict(
            diagnostics=self.diagnostics.get_transformed() > 0.5,
            pct_for_division=self.pct_for_division.get_transformed(),
            widget_colour=self.widget_colour.get_rgba(),
        )

    def make_tracker(self, sample_rate: float = 48_000.0, *,
                     frame_rate: float = 60.0, window_kernel=None):
        """Cursor frequency tracker with TrackerSmoothing and RefTuning
        applied (ref: drawFrequencyTracking, SpectrumRendering.cpp:377-470)."""
        from signalizer_tpu_torch.kernels.tracker import FrequencyTracker

        source = int(self.frequency_tracker.get_transformed())
        if source == 0:  # none
            return None
        return FrequencyTracker(
            sample_rate,
            a4_reference=self.reference_tuning.get_transformed(),
            smoothing_ms=self.tracker_smoothing.get_transformed(),
            frame_rate=frame_rate,
            window_kernel=window_kernel,
            source=("transform", "graph0", "graph1")[source - 1],
        )

    VERSION = 1

    def serialize(self, archive: Archive) -> None:
        archive.version = self.VERSION
        serialize_parameter_set(self.parameter_set, archive.child("Parameters"))

    def deserialize(self, archive: Archive) -> None:
        serialize = archive.find_child("Parameters")
        if serialize is not None:
            deserialize_parameter_set(self.parameter_set, serialize)


class OscilloscopeContent(SerializableObject):
    """ref: OscilloscopeParameters.h (LookaheadSize 8192, kernel size 10)."""

    NAME = "Oscilloscope"
    PREFIX = "OS."
    LOOKAHEAD_SIZE = 8192  # ref: :46
    INTERPOLATION_KERNEL_SIZE = 10  # ref: :47

    def __init__(self, sample_rate: float = 48_000.0, history_capacity: int = 48_000):
        ps = self.parameter_set = ParameterSet(self.NAME, self.PREFIX)
        self.window_transformatter = WindowSizeTransformatter(sample_rate, history_capacity)
        hz_fmt = LinearHzFormatter(sample_rate)

        # ref: windowRange is LINEAR (0, 1000) ms (OscilloscopeParameters.h:364)
        self.envelope_window = ps.register_parameter(
            Parameter("EnvelopeWindow", LinearRange(0.0, 1000.0), UnitFormatter("ms"), 0.5)
        )
        self.input_gain = ps.register_parameter(
            Parameter("InputGain", LinearRange(-120.0, 120.0), DBFormatter(), 0.5)
        )
        self.window_size = ps.register_parameter(
            Parameter("WindowSize", self.window_transformatter, self.window_transformatter, 0.5)
        )
        self.antialias = ps.register_parameter(Parameter("Antialias", BooleanRange(), BooleanFormatter(), 1.0))
        self.diagnostics = ps.register_parameter(Parameter("Diagnostics", BooleanRange(), BooleanFormatter(), 0.0))
        self.primitive_size = ps.register_parameter(
            Parameter("PrimitiveSize", LinearRange(0.01, 10.0), UnitFormatter("pts"), 0.1)
        )
        self.pct_for_division = ps.register_parameter(Parameter("PctDivision", UnityRange(), PercentageFormatter(), 0.5))
        self.trigger_phase_offset = ps.register_parameter(
            Parameter("TriggerPhase", LinearRange(-180.0, 180.0), UnitFormatter("deg"), 0.5)
        )
        self.dot_samples = ps.register_parameter(Parameter("DotSamples", BooleanRange(), BooleanFormatter(), 0.0))
        self.trigger_on_custom_frequency = ps.register_parameter(
            Parameter("CustomTrigger", BooleanRange(), BooleanFormatter(), 0.0)
        )
        # ref: customTriggerRange is LINEAR (5, 48000) Hz (:369)
        self.custom_trigger_frequency = ps.register_parameter(
            Parameter("CustomTriggerFrequency", LinearRange(5.0, 48_000.0), hz_fmt, 0.5)
        )
        self.overlay_channels = ps.register_parameter(Parameter("OverlayChannels", BooleanRange(), BooleanFormatter(), 1.0))
        self.colour_smoothing = ps.register_parameter(
            Parameter("ColourSmoothing", ExponentialRange(0.001, 1000.0), UnitFormatter("ms"), 0.5)
        )
        self.cursor_tracker = ps.register_parameter(Parameter("CursorTracker", BooleanRange(), BooleanFormatter(), 0.0))
        self.frequency_colouring_blend = ps.register_parameter(
            Parameter("FColourBlend", UnityRange(), PercentageFormatter(), 0.0)
        )
        self.trigger_hysteresis = ps.register_parameter(Parameter("THysteresis", UnityRange(), PercentageFormatter(), 0.0))
        # ref: triggerThresholdRange LINEAR (0, 4) amplitude shown in dB
        # (:371,402); triggerChannelRange is 1-BASED (1, 16) (:372,403)
        self.trigger_threshold = ps.register_parameter(
            Parameter("TThreshold", LinearRange(0.0, 4.0), AmplitudeDBFormatter(), 0.0)
        )
        self.triggering_channel = ps.register_parameter(
            Parameter("TriggeringChannel", IntegerLinearRange(1, 16), BasicFormatter(), 0.0)
        )
        self.show_legend = ps.register_parameter(Parameter("ShowLegend", BooleanRange(), BooleanFormatter(), 1.0))
        # ViewRight/ViewBottom use reverseUnitRange (normalized 0 = the
        # far edge; ref: :420-423), all four with basicFormatter
        self.view_offsets = [
            ps.register_parameter(Parameter(f"View{n}", rng, BasicFormatter(), 0.0))
            for n, rng in (("Left", UnityRange()), ("Top", UnityRange()),
                           ("Right", ReverseUnityRange()), ("Bottom", ReverseUnityRange()))
        ]
        self.auto_gain = ps.register_parameter(_choice("AutoGain", ["none", "rms", "peak decay"]))
        self.channel_configuration = ps.register_parameter(
            _choice("ChannelConfiguration", ["left", "right", "merge", "side", "separate", "mid/side"])
        )
        self.sub_sample_interpolation = ps.register_parameter(
            _choice("SampleInterpolation", ["none", "rectangular", "linear", "lanczos"], 3)
        )
        self.trigger_mode = ps.register_parameter(
            _choice("TriggerMode", ["none", "spectral", "window", "envelope hold", "zero crossing"])
        )
        self.time_mode = ps.register_parameter(_choice("TimeMode", ["time", "cycles", "beats"]))
        self.channel_colouring = ps.register_parameter(_choice("ChannelColouring", ["static", "spectral energy"]))
        # the window knob's unit semantics follow the time mode live
        # (ref: the timeMode listener retransforming windowSize,
        # OscilloscopeParameters.h:465-489)
        self.time_mode.add_rt_listener(self._on_time_mode)

        self.primary_colour = ps.register_bundle(ColourValue("PrimaryColour", (0.0, 1.0, 0.0, 1.0)))
        self.secondary_colour = ps.register_bundle(ColourValue("SecondaryColour", (1.0, 0.0, 0.0, 1.0)))
        self.graph_colour = ps.register_bundle(ColourValue("GraphColour", (0.5, 0.5, 0.5, 1.0)))
        self.background_colour = ps.register_bundle(ColourValue("BackgroundColour", (0.0, 0.0, 0.0, 1.0)))
        self.low_colour = ps.register_bundle(ColourValue("LowColour", (1.0, 0.1, 0.1, 1.0)))
        self.mid_colour = ps.register_bundle(ColourValue("MidColour", (0.1, 1.0, 0.1, 1.0)))
        self.high_colour = ps.register_bundle(ColourValue("HighColour", (0.1, 0.1, 1.0, 1.0)))
        self.widget_colour = ps.register_bundle(ColourValue("WidgetColour"))
        self.transform = ps.register_bundle(TransformValue("Transform"))
        ps.seal()

    def effective_window_samples(self, sample_rate: float, bpm: float = 120.0,
                                 cycle_samples: float = 0.0) -> float:
        """Per-time-mode effective window (ref: Oscilloscope.cpp:293-308:
        Beats divides the playhead tempo by the bar division with the bpm
        floored at 10; Cycles scales the *detected* cycleSamples)."""
        v = self.window_size.get_transformed()
        mode = TimeMode(int(self.time_mode.get_transformed()))
        if mode == TimeMode.TIME:
            return v
        if mode == TimeMode.CYCLES:
            return max(128.0, v * max(cycle_samples, 1.0) + 1.0)
        return max(128.0, sample_rate * 60.0 / (max(10.0, bpm) * max(v, 1e-9)))

    def _on_time_mode(self, parameter, source) -> None:
        self.window_transformatter.time_mode = TimeMode(int(parameter.get_transformed()))

    def make_render_hints(self) -> dict:
        """View-shell settings the GL renderer consumes in the reference
        (OscilloscopeRendering.cpp draw setup); here the viewer applies
        them (see :func:`signalizer_tpu.views.render.render_oscilloscope`)."""
        return dict(
            antialias=self.antialias.get_transformed() > 0.5,
            primitive_size=self.primitive_size.get_transformed(),
            dot_samples=self.dot_samples.get_transformed() > 0.5,
            overlay_channels=self.overlay_channels.get_transformed() > 0.5,
            show_legend=self.show_legend.get_transformed() > 0.5,
            cursor_tracker=self.cursor_tracker.get_transformed() > 0.5,
            diagnostics=self.diagnostics.get_transformed() > 0.5,
            pct_for_division=self.pct_for_division.get_transformed(),
            view_box=tuple(p.get_transformed() for p in self.view_offsets),
            graph_colour=self.graph_colour.get_rgba(),
            background_colour=self.background_colour.get_rgba(),
            widget_colour=self.widget_colour.get_rgba(),
            transform=(self.transform.matrix(), self.transform.translation()),
        )

    def make_processor_kwargs(self, sample_rate: float = 48_000.0, *,
                              bpm: float = 120.0, cycle_samples: float = 0.0) -> dict:
        from signalizer_tpu_torch.views.oscilloscope import (
            AutoGain,
            SubSampleInterpolation,
            TriggerMode,
        )

        return dict(
            sample_rate=sample_rate,
            channel_mode=OscChannels(int(self.channel_configuration.get_transformed())),
            trigger_mode=TriggerMode(int(self.trigger_mode.get_transformed())),
            interpolation=SubSampleInterpolation(int(self.sub_sample_interpolation.get_transformed())),
            window_samples=self.effective_window_samples(sample_rate, bpm, cycle_samples),
            lookahead=self.LOOKAHEAD_SIZE,
            trigger_threshold=self.trigger_threshold.get_transformed(),
            trigger_hysteresis=self.trigger_hysteresis.get_transformed(),
            trigger_phase_degrees=self.trigger_phase_offset.get_transformed(),
            autogain=AutoGain(int(self.auto_gain.get_transformed())),
            envelope_window_ms=self.envelope_window.get_transformed(),
            colour_enabled=int(self.channel_colouring.get_transformed()) == 1,
            colour_smooth_ms=self.colour_smoothing.get_transformed(),
            band_colours=(
                tuple(self.low_colour.get_rgb()),
                tuple(self.mid_colour.get_rgb()),
                tuple(self.high_colour.get_rgb()),
            ),
            key_colour=tuple(self.primary_colour.get_rgb()),
            secondary_colour=tuple(self.secondary_colour.get_rgb()),
            # the kernel's blend IS the energy-colour weight; the reference's
            # internal variable is 1 - knob and lerps TOWARD the key colour
            # by that amount (OscilloscopeDSP.inl:503, :493), so knob ==
            # energy weight — no inversion here. Polarity pinned by the
            # shipped corpus: coloured.oscilloscope.sgn carries FColBlend
            # 1.0, init 0.8 (full/strong frequency colouring).
            colour_blend=self.frequency_colouring_blend.get_transformed(),
            manual_gain=10.0 ** (self.input_gain.get_transformed() / 20.0),
            # the knob is 1-based like the reference (trigger1Base - 1,
            # OscilloscopeDSP.inl:496-501); kernels index 0-based
            trigger_channel=max(0, int(self.triggering_channel.get_transformed()) - 1),
            custom_trigger=self.trigger_on_custom_frequency.get_transformed() > 0.5,
            custom_trigger_frequency=self.custom_trigger_frequency.get_transformed(),
            time_mode=TimeMode(int(self.time_mode.get_transformed())),
            window_value=self.window_size.get_transformed(),
            bpm=bpm,
        )

    VERSION = 1

    def serialize(self, archive: Archive) -> None:
        archive.version = self.VERSION
        serialize_parameter_set(self.parameter_set, archive.child("Parameters"))

    def deserialize(self, archive: Archive) -> None:
        child = archive.find_child("Parameters")
        if child is not None:
            deserialize_parameter_set(self.parameter_set, child)


class VectorScopeContent(SerializableObject):
    """ref: VectorscopeParameters.h (265 LoC)."""

    NAME = "Vectorscope"
    PREFIX = "VS."

    def __init__(self, sample_rate: float = 48_000.0, history_capacity: int = 48_000):
        ps = self.parameter_set = ParameterSet(self.NAME, self.PREFIX)
        self.audio_history_transformatter = AudioHistoryTransformatter(sample_rate, history_capacity)

        # ref: windowRange is LINEAR (0, 1000) ms (VectorscopeParameters.h:50)
        # — the kernels consume get_normalized() as seconds, which with a
        # linear ms range is exactly the displayed value / 1000
        self.envelope_window = ps.register_parameter(
            Parameter("EnvelopeWindow", LinearRange(0.0, 1000.0), UnitFormatter("ms"), 0.5)
        )
        self.stereo_window = ps.register_parameter(
            Parameter("StereoWindow", LinearRange(0.0, 1000.0), UnitFormatter("ms"), 0.5)
        )
        self.input_gain = ps.register_parameter(
            Parameter("InputGain", LinearRange(-120.0, 120.0), DBFormatter(), 0.5)
        )
        self.window_size = ps.register_parameter(
            Parameter("WindowSize", self.audio_history_transformatter,
                      self.audio_history_transformatter,
                      min(4096.0 / max(history_capacity, 1), 1.0))
        )
        self.wave_z_rotation = ps.register_parameter(
            Parameter("WaveZRotation", LinearRange(0.0, 360.0), UnitFormatter("deg"), 0.0)
        )
        self.antialias = ps.register_parameter(Parameter("Antialias", BooleanRange(), BooleanFormatter(), 1.0))
        self.fade_older_points = ps.register_parameter(Parameter("FadeOlderPoints", BooleanRange(), BooleanFormatter(), 1.0))
        self.interconnect_samples = ps.register_parameter(Parameter("InterconnectSamples", BooleanRange(), BooleanFormatter(), 1.0))
        self.diagnostics = ps.register_parameter(Parameter("Diagnostics", BooleanRange(), BooleanFormatter(), 0.0))
        self.primitive_size = ps.register_parameter(
            Parameter("PrimitiveSize", LinearRange(0.01, 10.0), UnitFormatter("pts"), 0.1)
        )
        self.show_legend = ps.register_parameter(Parameter("ShowLegend", BooleanRange(), BooleanFormatter(), 1.0))
        self.scale_polar_mode_to_fill = ps.register_parameter(
            Parameter("ScalePolarModeToFill", BooleanRange(), BooleanFormatter(), 0.0)
        )
        self.auto_gain = ps.register_parameter(_choice("AutoGain", ["none", "rms", "peak decay"]))
        self.operational_mode = ps.register_parameter(_choice("OperationalMode", ["lissajous", "polar"]))

        self.waveform_colour = ps.register_bundle(ColourValue("DrawingColour", (0.0, 1.0, 0.0, 1.0)))
        self.axis_colour = ps.register_bundle(ColourValue("GraphColour", (0.5, 0.5, 0.5, 1.0)))
        self.background_colour = ps.register_bundle(ColourValue("BackgroundColour", (0.0, 0.0, 0.0, 1.0)))
        self.skeleton_colour = ps.register_bundle(ColourValue("SkeletonColour", (0.3, 0.3, 0.3, 1.0)))
        self.meter_colour = ps.register_bundle(ColourValue("MeterColour", (0.1, 0.6, 1.0, 1.0)))
        self.widget_colour = ps.register_bundle(ColourValue("WidgetColour"))
        self.transform = ps.register_bundle(TransformValue("Transform"))
        ps.seal()

    def make_processor_kwargs(self, sample_rate: float = 48_000.0) -> dict:
        from signalizer_tpu_torch.views.vectorscope import AutoGain, OperationalMode

        return dict(
            sample_rate=sample_rate,
            mode=OperationalMode(int(self.operational_mode.get_transformed())),
            autogain=AutoGain(int(self.auto_gain.get_transformed())),
            envelope_window=self.envelope_window.get_normalized(),
            stereo_window=self.stereo_window.get_normalized(),
            rotation=self.wave_z_rotation.get_transformed() / 360.0,
            user_gain=10.0 ** (self.input_gain.get_transformed() / 20.0),
            scale_to_fill=self.scale_polar_mode_to_fill.get_transformed() > 0.5,
        )

    def make_render_hints(self) -> dict:
        """View-shell settings the GL renderer consumes in the reference
        (VectorscopeRendering.cpp draw setup); the viewer applies them
        (see :func:`signalizer_tpu.views.render.render_vectorscope`)."""
        return dict(
            antialias=self.antialias.get_transformed() > 0.5,
            fade_older_points=self.fade_older_points.get_transformed() > 0.5,
            interconnect_samples=self.interconnect_samples.get_transformed() > 0.5,
            primitive_size=self.primitive_size.get_transformed(),
            show_legend=self.show_legend.get_transformed() > 0.5,
            diagnostics=self.diagnostics.get_transformed() > 0.5,
            waveform_colour=self.waveform_colour.get_rgba(),
            axis_colour=self.axis_colour.get_rgba(),
            background_colour=self.background_colour.get_rgba(),
            skeleton_colour=self.skeleton_colour.get_rgba(),
            meter_colour=self.meter_colour.get_rgba(),
            widget_colour=self.widget_colour.get_rgba(),
            transform=(self.transform.matrix(), self.transform.translation()),
        )

    VERSION = 1

    def serialize(self, archive: Archive) -> None:
        archive.version = self.VERSION
        serialize_parameter_set(self.parameter_set, archive.child("Parameters"))

    def deserialize(self, archive: Archive) -> None:
        child = archive.find_child("Parameters")
        if child is not None:
            deserialize_parameter_set(self.parameter_set, child)


# registration order mirrors the reference (MainEditor.cpp:70-75)
CONTENT_CREATION_LIST = (VectorScopeContent, OscilloscopeContent, SpectrumContent)
