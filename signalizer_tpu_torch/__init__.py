"""signalizer_tpu_torch — the PyTorch / CUDA port of signalizer_tpu.

A second package beside the JAX one: the Spectrum view (FFT path and
resonator bank), the Oscilloscope, Vectorscope and Spectrogram views, on
tensors on one explicit device, carried by CUDA
kernels written for Hopper (``csrc/``) with plain PyTorch versions beside
them, the live ingest path that feeds them from an audio stream, the
engine and session a user drives (``SignalizerEngine``, ``AnalysisSession``),
the multi-device pipeline and the front ends (CLI, editor, renderers, api). It
imports no jax and nothing of the JAX package: the enums, windows,
decay-pole design, parameter layer, colour and axis helpers, tracker,
presets and host stream layer it shares with that package are its own
copies (``core.config``, ``core.windows``, ``core.scaling``, ``params``,
``utils.colour``, ``utils.axis``, ``utils.diagnostics``,
``utils.exception_log``, ``kernels.tracker``, ``state``,
``views.line_graph``, ``views.controllers``, ``views.editor_settings``,
``native_bindings``, ``stream``). Entry points run on
the GPU unless the caller passes ``device="cpu"``.

Layout mirrors :mod:`signalizer_tpu`:

* :mod:`signalizer_tpu_torch.core.config`      — channel / interpolation / scaling enums
* :mod:`signalizer_tpu_torch.core.windows`     — window generation
* :mod:`signalizer_tpu_torch.core.constant`    — SpectrumConstant, remap-plan functions
* :mod:`signalizer_tpu_torch.kernels.spectrum` — analyze_frames and its stages
* :mod:`signalizer_tpu_torch.kernels.window_fft_mag` — kernel A wrapper (both forms)
* :mod:`signalizer_tpu_torch.kernels.display_map`    — kernel B wrapper
* :mod:`signalizer_tpu_torch.kernels.peak_decay`     — the decay loop
* :mod:`signalizer_tpu_torch.kernels.phase_values`   — the PHASE values kernel's wrapper (mid, cancellation)
* :mod:`signalizer_tpu_torch.views.spectrum`   — SpectrumProcessor, ResonatorSpectrumProcessor
* :mod:`signalizer_tpu_torch.kernels.resonator` — the resonator bank (RSNT)
* :mod:`signalizer_tpu_torch.kernels.filters`  — biquads, crossover, one-pole smoothers
* :mod:`signalizer_tpu_torch.kernels.oscilloscope`    — triggers, spectral fundamental, resamples
* :mod:`signalizer_tpu_torch.kernels.banded_resample` — kernel C wrapper
* :mod:`signalizer_tpu_torch.kernels.peak_hold`       — kernel D wrapper (the envelope-hold scan)
* :mod:`signalizer_tpu_torch.views.oscilloscope` — OscilloscopeProcessor
* :mod:`signalizer_tpu_torch.kernels.vectorscope` — Lissajous/polar transforms, meters, autogain
* :mod:`signalizer_tpu_torch.views.vectorscope`   — VectorscopeProcessor
* :mod:`signalizer_tpu_torch.kernels.colormap`    — gradient map, pair blend, RGBA8 columns
* :mod:`signalizer_tpu_torch.stream`              — host ring buffer, frame batcher, device-resident ring
* :mod:`signalizer_tpu_torch.stream.audio_stream` — AudioStream (threaded on the native packet queue)
* :mod:`signalizer_tpu_torch.stream.host_graph`   — HostGraph: instance identities and topology
* :mod:`signalizer_tpu_torch.stream.mix_graph`    — MixGraph: instances mixed into one presentation stream
* :mod:`signalizer_tpu_torch.stream.device_history` — DevicePresentationHistory: the presentation history on the device
* :mod:`signalizer_tpu_torch.stream.frame_pipeline` — FramePipeline: steps in flight, harvested by CUDA events
* :mod:`signalizer_tpu_torch.native_bindings`     — the native host runtime (ring, packet queue), built with g++
* :mod:`signalizer_tpu_torch.views.spectrogram`   — SpectrogramProcessor, SpectrogramImage, ColumnPacer
* :mod:`signalizer_tpu_torch.params`              — parameters, ranges, formatters, bundles, transformatters
* :mod:`signalizer_tpu_torch.state`               — archives, presets (the factory corpus in ``presets/``), .sgn import
* :mod:`signalizer_tpu_torch.views.content`       — the three views' parameter contents, the bridge to the processors
* :mod:`signalizer_tpu_torch.views.line_graph`    — LineGraphRenderFeed; ``views.controllers``, ``views.editor_settings``
* :mod:`signalizer_tpu_torch.kernels.tracker`     — the cursor frequency tracker (numpy)
* :mod:`signalizer_tpu_torch.utils.axis`          — grid lines; ``utils.colour`` — hue rotation, legends
* :mod:`signalizer_tpu_torch.engine`              — SignalizerEngine: one instance, its parameters, presets and archives
* :mod:`signalizer_tpu_torch.session`             — AnalysisSession: one UI tick of every view, fed from the engine
* :mod:`signalizer_tpu_torch.views.fused_tick`    — run_fused_tick: spectrum, oscilloscope and vectorscope with one readback
* :mod:`signalizer_tpu_torch.parallel`            — the mesh (a list of devices), sharded steps, ShardedAnalysisPipeline
* :mod:`signalizer_tpu_torch.views.render`        — the offline matplotlib renderers; ``utils.png``, ``utils.readback``
* :mod:`signalizer_tpu_torch.editor`              — EditorShell, the browser editor
* :mod:`signalizer_tpu_torch.api`                 — the public facade; ``python -m signalizer_tpu_torch`` the CLI

Importing builds nothing: the kernels compile with ``nvcc`` on first launch,
the host runtime with ``g++`` on first use.
"""

from signalizer_tpu_torch.core.config import (  # noqa: F401
    BinInterpolation,
    DisplayMode,
    OscChannels,
    SpectrumChannels,
    TransformAlgorithm,
    ViewScaling,
)
from signalizer_tpu_torch.params.transformatters import TimeMode  # noqa: F401
from signalizer_tpu_torch.views.oscilloscope import (  # noqa: F401
    AutoGain,
    OscilloscopeProcessor,
    SubSampleInterpolation,
    TriggerMode,
)
from signalizer_tpu_torch.views.spectrogram import (  # noqa: F401
    ColumnPacer,
    SpectrogramImage,
    SpectrogramProcessor,
)
from signalizer_tpu_torch.views.spectrum import (  # noqa: F401
    ResonatorSpectrumProcessor,
    SpectrumProcessor,
)
from signalizer_tpu_torch.views.vectorscope import AutoGain as VectorscopeAutoGain  # noqa: F401
from signalizer_tpu_torch.views.vectorscope import (  # noqa: F401
    OperationalMode,
    VectorscopeProcessor,
)
