"""Host-side streaming of the PyTorch port: ring buffer, frame batcher,
device-resident rings, the audio stream, the host and mix graphs and the
frame pipeline."""

from signalizer_tpu_torch.stream.ring_buffer import RingBuffer  # noqa: F401
from signalizer_tpu_torch.stream.batcher import FrameBatcher  # noqa: F401
from signalizer_tpu_torch.stream.frame_pipeline import FramePipeline  # noqa: F401
from signalizer_tpu_torch.stream.audio_stream import (  # noqa: F401
    AudioStream,
    AudioStreamInfo,
    Playhead,
    StreamListener,
)
