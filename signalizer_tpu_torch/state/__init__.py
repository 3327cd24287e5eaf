"""Versioned keyed-tree serialization and presets (copies of
:mod:`signalizer_tpu.state`)."""

from signalizer_tpu_torch.state.serialize import Archive, SerializableObject  # noqa: F401
from signalizer_tpu_torch.state.presets import PresetManager  # noqa: F401
