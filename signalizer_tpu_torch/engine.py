"""SignalizerEngine — the top-level instance (embedding / library API).

Equivalent of the reference's AudioProcessor + MainEditor wiring minus the
GUI (ref: Source/Processor/PluginProcessor.{h,cpp} — stream creation :46-114,
flat host-parameter API :414-438, state save/restore :224-406; MainEditor's
MixGraphListener ownership, MainEditor.cpp:145-146; the single-TU embedding
build the reference offers, Source/Unity/SignalizerSource.cpp). One engine
== one "plugin instance": a realtime input stream, a HostGraph node, a
MixGraph producing the presentation stream, the three view contents and
their processors, plus full-session serialization.

The port's counterpart of :mod:`signalizer_tpu.engine`: the same parameters,
presets, archives and stream wiring (archives cross between the two packages
both ways), with every processor built on the engine's ``device``.
``device=None`` is the GPU and raises without one; the CPU is used only for
``device="cpu"``. The factory preset corpus is the port's own copy
(``signalizer_tpu_torch/presets``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from signalizer_tpu_torch.core.config import DEFAULT_HISTORY_SIZE, MAX_INPUT_CHANNELS
from signalizer_tpu_torch.core.constant import resolve_device
from signalizer_tpu_torch.params.parameters import ParameterMap
from signalizer_tpu_torch.state.presets import PresetManager
from signalizer_tpu_torch.state.serialize import Archive, SerializableObject
from signalizer_tpu_torch.stream.audio_stream import AudioStream, AudioStreamInfo, Playhead
from signalizer_tpu_torch.stream.host_graph import HostGraph
from signalizer_tpu_torch.stream.mix_graph import MixGraph
from signalizer_tpu_torch.utils.diagnostics import Diagnostics, SharedBehaviour
from signalizer_tpu_torch.views.content import (
    OscilloscopeContent,
    SpectrumContent,
    VectorScopeContent,
)


@dataclass
class ConcurrentConfig:
    """Engine facts snapshot (ref: Source/Common/ConcurrentConfig.h:39-46)."""

    sample_rate: float = 48_000.0
    history_size: int = DEFAULT_HISTORY_SIZE
    history_capacity: int = DEFAULT_HISTORY_SIZE
    bpm: float = 120.0
    num_channels: int = 2


class SignalizerEngine(SerializableObject):
    """One analysis instance."""

    VERSION = 1

    def __init__(
        self,
        name: str = "signalizer",
        *,
        channels: int = 2,
        sample_rate: float = 48_000.0,
        history_capacity: int = DEFAULT_HISTORY_SIZE,
        threaded: bool = False,
        preset_dir: Optional[str] = None,
        load_default_preset: bool = True,
        device=None,
    ):
        if channels > MAX_INPUT_CHANNELS:
            raise ValueError(f"at most {MAX_INPUT_CHANNELS} channels")
        # the device every processor of this engine is built on
        self.device = resolve_device(device)
        self.config = ConcurrentConfig(
            sample_rate=sample_rate,
            history_capacity=history_capacity,
            num_channels=channels,
        )
        self.behaviour = SharedBehaviour()
        self.diagnostics = Diagnostics()
        # global editor-shell settings (ref: MainEditor's refresh/render/
        # colour-scheme knobs, MainEditor.cpp:1046-1080) as a data model
        from signalizer_tpu_torch.views.editor_settings import EditorSettings

        self.editor_settings = EditorSettings()

        info = AudioStreamInfo(
            channels=channels,
            sample_rate=sample_rate,
            audio_history_capacity=history_capacity,
        )
        self.realtime_input, self.realtime_output = AudioStream.create(threaded, info)
        self.host_graph = HostGraph(name, channels=channels)
        self.host_graph.stream_output = self.realtime_output
        self.mix_graph = MixGraph(self.host_graph, self.realtime_output)

        # contents in the reference's registration order (MainEditor.cpp:70-75)
        self.vectorscope = VectorScopeContent(sample_rate, history_capacity)
        self.oscilloscope = OscilloscopeContent(sample_rate, history_capacity)
        self.spectrum = SpectrumContent(sample_rate, history_capacity)
        self.parameter_map = ParameterMap()
        for content in (self.vectorscope, self.oscilloscope, self.spectrum):
            self.parameter_map.add_set(content.parameter_set)

        # keep window-size transformatters in sync with stream properties
        # (ref: onStreamPropertiesChanged rescale, CommonSignalizer.h:326)
        engine = self

        class _PropertyWatcher:
            def on_stream_audio(self, ctx, block):
                pass

            def on_stream_properties_changed(self, ctx, before):
                info = ctx.info
                for tf in (
                    engine.vectorscope.audio_history_transformatter,
                    engine.oscilloscope.window_transformatter,
                    engine.spectrum.audio_history_transformatter,
                ):
                    tf.set_stream_properties(info.sample_rate, info.audio_history_capacity)
                engine.config.sample_rate = info.sample_rate
                engine.config.num_channels = info.channels

            def on_stream_died(self, ctx):
                pass

        self._property_watcher = _PropertyWatcher()
        self.realtime_output.add_listener(self._property_watcher)

        # factory corpus always available; user dir optional
        # (ref: default.main loaded at construction, PluginProcessor.cpp:83-101)
        self.presets = PresetManager(preset_dir)
        if load_default_preset:
            default = self.presets.load_default()
            if default is not None:
                self.deserialize(default)

        self._playhead = Playhead()

    # --- audio entry (ref: processBlock, PluginProcessor.cpp:163-208) ------
    def process_block(self, block: np.ndarray, playhead: Optional[Playhead] = None) -> None:
        block = np.asarray(block, np.float32)
        if playhead is None:
            playhead = self._playhead
        self.realtime_input.process_incoming_audio(block, playhead)
        self._playhead = playhead.advanced(block.shape[1])
        self.config.bpm = playhead.bpm

    @property
    def presentation_output(self):
        """The mixed multichannel stream all views consume."""
        return self.mix_graph.presentation_output

    def get_presentation_history(self, n: int) -> np.ndarray:
        return self.presentation_output.get_history(n)

    def _apply_history_capacity(self, cap: int) -> None:
        """Resize BOTH live streams: the realtime input ring and the
        presentation stream the views actually read — restoring a larger
        capacity only on the input would leave get_presentation_history
        unable to serve the windows the restore promised.

        Clamped: archives and .sgn imports carry this as a raw integer,
        and an unchecked value sizes real ring allocations (2^24 samples
        ~ 350 s @ 48 kHz, beyond the reference's whole history range)."""
        cap = int(min(max(int(cap), 1), 1 << 24))
        self.config.history_capacity = int(cap)
        for inp in (self.realtime_input, self.mix_graph.presentation_input):
            inp.initialize_info(
                lambda info: setattr(info, "audio_history_capacity", int(cap))
            )

    # --- flat host parameter API (ref: PluginProcessor.cpp:414-438) --------
    def num_parameters(self) -> int:
        return self.parameter_map.num_parameters()

    def get_parameter(self, index: int) -> float:
        return self.parameter_map.find_parameter(index).get_normalized()

    def set_parameter(self, index: int, normalized: float) -> None:
        self.parameter_map.find_parameter(index).update_from_host_normalized(normalized)

    def get_parameter_name(self, index: int) -> str:
        return self.parameter_map.find_parameter(index).exported_name

    def get_parameter_text(self, index: int) -> str:
        return self.parameter_map.find_parameter(index).get_display_text()

    def pulse_ui(self) -> None:
        self.parameter_map.pulse_ui()

    # --- host automation (ref: AutomatedProcessor callbacks,
    # PluginProcessor.cpp:116-129 — UI edits flow back to the host as
    # transmitChangeMessage between begin/endChangeGesture) --------------
    def set_automation_host(self, host) -> None:
        """Register the host-automation sink. ``host`` provides
        ``transmit_change(index, normalized)`` and optionally
        ``begin_gesture(index)`` / ``end_gesture(index)``. UI- and
        text-sourced parameter edits are forwarded with their flat index."""
        self._automation_host = host
        if getattr(self, "_automation_wired", False):
            return
        self._automation_wired = True
        engine = self

        def forward(parameter, source):
            h = getattr(engine, "_automation_host", None)
            if h is not None and source in ("ui", "text"):
                idx = engine.parameter_map.flat_index_of(parameter)
                h.transmit_change(idx, parameter.get_normalized())

        for i in range(self.parameter_map.num_parameters()):
            self.parameter_map.find_parameter(i).add_rt_listener(forward)

    def begin_parameter_gesture(self, index: int) -> None:
        h = getattr(self, "_automation_host", None)
        if h is not None and hasattr(h, "begin_gesture"):
            h.begin_gesture(index)

    def end_parameter_gesture(self, index: int) -> None:
        h = getattr(self, "_automation_host", None)
        if h is not None and hasattr(h, "end_gesture"):
            h.end_gesture(index)

    # --- view factories ---------------------------------------------------------
    def make_spectrum_processor(self, *, axis_points: int = 1024, pairs: int = 1,
                                frames_per_second: float = 60.0):
        from signalizer_tpu_torch.core.config import TransformAlgorithm
        from signalizer_tpu_torch.views.spectrum import (
            ResonatorSpectrumProcessor,
            SpectrumProcessor,
        )

        constant = self.spectrum.make_constant(
            axis_points=axis_points,
            sample_rate=self.config.sample_rate,
            frames_per_second=frames_per_second,
            device=self.device,
        )
        # the Algorithm knob routes between the FFT and the resonator bank
        # (ref: TransformAlgorithm dispatch, TransformDSP.inl:1213-1295)
        if constant.algo == TransformAlgorithm.RESONATOR:
            return ResonatorSpectrumProcessor(
                constant,
                pairs=pairs,
                window_type=self.spectrum.dsp_win.get_window_type(),
                free_q=self.spectrum.free_q.get_transformed() > 0.5,
            )
        return SpectrumProcessor(constant, pairs=pairs)

    def make_oscilloscope_processor(self, *, pixels: int = 1024, pairs: int = 1):
        from signalizer_tpu_torch.views.oscilloscope import OscilloscopeProcessor

        proc = OscilloscopeProcessor.create(
            pairs=pairs, pixels=pixels, device=self.device,
            **self.oscilloscope.make_processor_kwargs(
                self.config.sample_rate, bpm=self.config.bpm
            ),
        )
        # Beats windows follow the live playhead bpm
        # (ref: cs.bpm -> effectiveWindowSize, Oscilloscope.cpp:295-297)
        proc.bpm_source = lambda: self.config.bpm
        return proc

    def make_vectorscope_processor(self, *, pairs: int = 1):
        from signalizer_tpu_torch.views.vectorscope import VectorscopeProcessor

        return VectorscopeProcessor(
            pairs=pairs, device=self.device,
            **self.vectorscope.make_processor_kwargs(self.config.sample_rate),
        )

    def make_spectrogram_processor(self, *, axis_points: int = 256, pairs: int = 1,
                                   image_width: int = 512, overlap: float = 0.0):
        from signalizer_tpu_torch.views.spectrogram import SpectrogramProcessor

        # decay poles are designed per FRAME; spectrogram frames arrive at
        # the blob cadence, not the render rate (ref: CHANGELOG 0.4.0
        # "Decay rate in the spectrogram that was incorrectly affected by
        # the frame rate")
        blob_ms = self.spectrum.blob_size.get_transformed()
        column_rate = 1000.0 / max(blob_ms * (1.0 - overlap), 1e-3)
        constant = self.spectrum.make_constant(
            axis_points=axis_points, sample_rate=self.config.sample_rate,
            frames_per_second=column_rate, device=self.device,
        )
        colours, ratios = self.spectrum.make_gradient()
        proc = SpectrogramProcessor(
            constant,
            pairs=pairs,
            blob_ms=blob_ms,
            overlap=overlap,
            image_width=image_width,
            stretch=self.spectrum.spectrum_stretching.get_transformed(),
            colours=colours,
            ratios=ratios,
        )
        # render pacing follows the FrameSmoothing knob
        # (ref: frameUpdateSmoothing, SpectrumParameters.h:47-50)
        from signalizer_tpu_torch.views.spectrogram import ColumnPacer

        proc.pacer = ColumnPacer(
            smoothing=self.spectrum.frame_update_smoothing.get_transformed()
        )
        return proc

    # --- session state (ref: serialize/deserialize, PluginProcessor.cpp) ---
    def serialize(self, archive: Archive) -> None:
        archive.version = self.VERSION
        params = archive.child("Parameters")
        for content in (self.vectorscope, self.oscilloscope, self.spectrum):
            content.serialize(params.child(content.NAME))
        engine = archive.child("Engine")
        engine["historyCapacity"] = self.config.history_capacity
        engine["sampleRate"] = self.config.sample_rate
        self.editor_settings.serialize(archive.child("Editor"))
        self.host_graph.serialize(archive.child("host-graph"))

    def deserialize(self, archive: Archive) -> None:
        params = archive.find_child("Parameters")
        if params is not None:
            for content in (self.vectorscope, self.oscilloscope, self.spectrum):
                child = params.find_child(content.NAME)
                if child is not None:
                    content.deserialize(child)
        engine = archive.find_child("Engine")
        if engine is not None:
            cap = int(engine.get("historyCapacity", self.config.history_capacity))
            if cap != self.config.history_capacity:
                # apply to the live streams, not just the config snapshot
                # (ref: setAudioHistoryCapacity on restore,
                # PluginProcessor.cpp:224-406) — listeners get the
                # properties-changed callback and transformatters rescale
                self._apply_history_capacity(cap)
        ed = archive.find_child("Editor")
        if ed is not None:
            self.editor_settings.deserialize(ed)
            self._apply_editor_behaviour()
        hg = archive.find_child("host-graph")
        if hg is not None:
            self.host_graph.deserialize(hg)

    def _apply_editor_behaviour(self) -> None:
        """Mirror editor toggles into the shared behaviour flags
        (ref: SharedBehaviour.h consumers)."""
        s = self.editor_settings
        self.behaviour.hide_widgets_on_mouse_exit = s.hide_widgets_on_mouse_exit
        self.behaviour.stop_processing_on_suspend = s.stop_processing_on_suspend

    def save_preset(self, name: str) -> None:
        # a factory-only manager (no preset_dir) raises its own
        # "no writable directory" error on save
        ar = Archive()
        self.serialize(ar)
        self.presets.save(name, ar)

    def load_preset(self, name: str) -> bool:
        ar = self.presets.try_load(name)
        if ar is None:
            return False
        self.deserialize(ar)
        return True

    def load_reference_preset(self, path) -> list:
        """Import one of the reference's binary ``.sgn`` presets
        (ref corpus: Make/Skeleton/presets/*.sgn, loaded by
        PluginProcessor.cpp:83-101 / CPresetWidget). Returns the list of
        views the preset applied to. A ``main`` preset also applies its
        engine history capacity to the live stream."""
        from signalizer_tpu_torch.state.sgn_import import apply_preset, load_sgn

        preset = load_sgn(path)
        applied = apply_preset(
            preset,
            vectorscope=self.vectorscope,
            oscilloscope=self.oscilloscope,
            spectrum=self.spectrum,
        )
        cap = preset.history_capacity()
        if cap and cap != self.config.history_capacity:
            # clamp a corrupt/hostile u64 before it sizes a ring
            # allocation (a raw 2^40 here would OOM/abort the process).
            # 2^24 samples ~ 350 s @ 48 kHz, far beyond the reference's
            # history range.
            self._apply_history_capacity(int(min(max(cap, 1), 1 << 24)))
        if preset.name == "main":
            from signalizer_tpu_torch.views.editor_settings import EditorSettings

            self.editor_settings = EditorSettings.from_reference_main(preset)
            self._apply_editor_behaviour()
        return applied

    def make_legend(self, view: str = "oscilloscope", pairs: int = 1):
        """Channel legend with the *propagated* source names and the
        per-pair rotated colours (ref: legend option showing "the source
        name and colour used to draw it", CHANGELOG 0.4.0; names flow from
        the graph via enqueueChannelName, MixGraphListener.cpp:210,236)."""
        from signalizer_tpu_torch.utils.colour import Legend

        info = self.presentation_output._stream.info
        names = list(info.channel_names)
        want = max(2 * pairs, info.channels)
        while len(names) < want:
            names.append(f"channel {len(names)}")
        base = {
            "oscilloscope": self.oscilloscope.primary_colour,
            "vectorscope": self.vectorscope.waveform_colour,
            "spectrum": self.spectrum.lines[0][1],
        }[view].get_rgb()
        # the oscilloscope colours right channels with the secondary
        # colour (ref: Oscilloscope.cpp:322/326)
        second = (
            tuple(float(c) for c in self.oscilloscope.secondary_colour.get_rgb())
            if view == "oscilloscope"
            else None
        )
        return Legend.for_pairs(
            names[:want], tuple(float(c) for c in base), pairs,
            secondary_colour=second,
        )

    def perf_snapshot(self) -> Dict[str, float]:
        """BASELINE observability metrics."""
        mix = self.mix_graph.perf
        stream = self.realtime_output.get_perf_measures()
        return {
            **self.diagnostics.snapshot(),
            "mix_latency_samples": mix.latency_samples,
            "mix_synchronized": float(mix.synchronized),
            "mix_discontinuities": mix.discontinuities,
            "stream_dropped_frames": stream.dropped_frames,
            "stream_in_flight": stream.in_flight_packets,
            # the diagnostics-HUD percentages (ref: producer/consumer
            # usage + overhead, SpectrumRendering.cpp:163-184)
            "stream_producer_usage": stream.producer_usage,
            "stream_producer_overhead": stream.producer_overhead,
            "stream_consumer_usage": stream.consumer_usage,
            "stream_consumer_overhead": stream.consumer_overhead,
        }

    def close(self) -> None:
        # idempotent: AnalysisSession.close() closes its engine, and
        # embedders commonly also close in their own finally block
        if getattr(self, "_closed", False):
            return
        self._closed = True
        self.mix_graph.close()
        self.host_graph.close()
        self.realtime_output._stream.close()
