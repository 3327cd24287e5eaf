"""Public API facade.

Counterpart of :mod:`signalizer_tpu.api`: every name of the JAX package's
facade, re-exported from the port.

One import surface mirroring the reference's processor interfaces
(SURVEY.md §7 architecture sketch: the ``api/`` layer exposes the view
processors' inputs/outputs so reference-derived frames can validate
fidelity). Everything here is re-exported from the implementing modules.
"""

from signalizer_tpu_torch.engine import ConcurrentConfig, SignalizerEngine  # noqa: F401
from signalizer_tpu_torch.core.config import (  # noqa: F401
    BinInterpolation,
    DisplayMode,
    OscChannels,
    SpectrumChannels,
    TransformAlgorithm,
    ViewScaling,
)
from signalizer_tpu_torch.core.constant import SpectrumConstant, make_spectrum_constant  # noqa: F401
from signalizer_tpu_torch.core.windows import WindowType, generate_window  # noqa: F401
from signalizer_tpu_torch.views.spectrum import (  # noqa: F401
    ResonatorSpectrumProcessor,
    SpectrumProcessor,
)
from signalizer_tpu_torch.views.oscilloscope import (  # noqa: F401
    OscilloscopeFrame,
    OscilloscopeProcessor,
    SubSampleInterpolation,
    TriggerMode,
)
from signalizer_tpu_torch.views.vectorscope import (  # noqa: F401
    AutoGain,
    OperationalMode,
    VectorscopeFrame,
    VectorscopeProcessor,
)
from signalizer_tpu_torch.views.spectrogram import SpectrogramImage, SpectrogramProcessor  # noqa: F401
from signalizer_tpu_torch.views.content import (  # noqa: F401
    OscilloscopeContent,
    SpectrumContent,
    VectorScopeContent,
)
from signalizer_tpu_torch.stream.audio_stream import AudioStream, AudioStreamInfo, Playhead  # noqa: F401
from signalizer_tpu_torch.stream.host_graph import HostGraph, PortPair  # noqa: F401
from signalizer_tpu_torch.stream.mix_graph import MixGraph  # noqa: F401
from signalizer_tpu_torch.state.presets import PresetManager  # noqa: F401
from signalizer_tpu_torch.state.serialize import Archive  # noqa: F401
from signalizer_tpu_torch.session import AnalysisSession, SessionFrame  # noqa: F401
from signalizer_tpu_torch.views.line_graph import LineGraphFrame, LineGraphRenderFeed  # noqa: F401
from signalizer_tpu_torch.kernels.tracker import FrequencyTracker  # noqa: F401
from signalizer_tpu_torch.utils.exception_log import log_exception, protected_call  # noqa: F401
from signalizer_tpu_torch.views.controllers import layout_for, Page, Section, Control  # noqa: F401
from signalizer_tpu_torch.parallel.pipeline import PipelineOutput, ShardedAnalysisPipeline  # noqa: F401
from signalizer_tpu_torch.stream.frame_pipeline import FramePipeline  # noqa: F401
from signalizer_tpu_torch.state.sgn_import import (  # noqa: F401
    SgnPreset,
    apply_preset,
    load_sgn,
    save_sgn,
)
from signalizer_tpu_torch.views.editor_settings import EditorSettings  # noqa: F401
from signalizer_tpu_torch.editor import EditorShell  # noqa: F401
