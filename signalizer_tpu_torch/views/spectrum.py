"""SpectrumProcessor — the stateful public face of the spectrum view.

Counterpart of :mod:`signalizer_tpu.views.spectrum` (the FFT path,
``views/spectrum.py:35-106``; ref: Source/Spectrum/Spectrum.h,
SpectrumDSP.cpp:61-227): owns the constant, carries the per-pair
line-graph filter states across calls on one device, and exposes the
batched step. Rendering is out of scope — outputs are render-ready tensors.

* ``pairs``: channel pairs analyzed in parallel (the reference's
  ``parallel_for`` over pairs, SpectrumDSP.cpp:83) — the batch axis.
* ``process(frames)`` with frames ``[pairs, T, 2, window]`` treats T as
  time-sequential (decay state threads through) and pairs as parallel.
"""

from __future__ import annotations

import numpy as np
import torch

from signalizer_tpu_torch.core.constant import (
    SpectrumConstant,
    resolve_device,
    make_spectrum_constant,
)
from signalizer_tpu_torch.kernels.spectrum import (
    LineGraphState,
    analyze_frames,
    init_line_graph_state,
    stitch_preliminary,
)


class SpectrumProcessor:
    """Stateful wrapper: constant + carried decay state on one device."""

    def __init__(self, constant: SpectrumConstant, pairs: int = 1):
        self.constant = constant
        self.pairs = pairs
        self._state = init_line_graph_state(constant, (pairs,))

    @classmethod
    def create(cls, *, pairs: int = 1, device=None, **constant_kwargs) -> "SpectrumProcessor":
        """Build the constant on ``device`` and a processor for ``pairs``
        channel pairs. ``device=None`` is the GPU; it raises when no GPU is
        available, and the CPU is used only for ``device="cpu"``."""
        device = resolve_device(device)
        return cls(make_spectrum_constant(device=device, **constant_kwargs), pairs=pairs)

    @property
    def device(self) -> torch.device:
        return self.constant.device

    @property
    def state(self) -> LineGraphState:
        """Current decay state. ``process`` updates these tensors in place
        (the JAX step donated them): clone before processing again to keep
        a snapshot."""
        return self._state

    def reset(self) -> None:
        """Clear filter states (ref: resetState semantics)."""
        self._state = init_line_graph_state(self.constant, (self.pairs,))

    def reconfigure(self, constant: SpectrumConstant) -> None:
        """Swap the constant (ref: handleFlagUpdates rebuild,
        Spectrum.cpp:351-616). Resets state when shapes or the device
        changed."""
        same_shape = (
            constant.axis_points == self.constant.axis_points
            and constant.state_channels == self.constant.state_channels
            and constant.num_line_graphs == self.constant.num_line_graphs
            and constant.device == self.constant.device
        )
        self.constant = constant
        if not same_shape:
            self.reset()

    def _frames(self, frames) -> torch.Tensor:
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(np.ascontiguousarray(frames, dtype=np.float32))
        return torch.as_tensor(frames, dtype=torch.float32).to(self.device).contiguous()

    def process(self, frames) -> torch.Tensor:
        """frames [pairs, T, 2, window] (or [pairs, 2, window] for one step),
        numpy or tensor -> display results [pairs, T, K, rows, P] on the
        processor's device; decay state carries across calls."""
        frames = self._frames(frames)
        if frames.ndim == 3:  # [pairs, C, W] -> single time step
            frames = frames[:, None]
        return analyze_frames(self.constant, self._state, frames).results

    def process_to_host(self, frames) -> np.ndarray:
        return self.process(frames).cpu().numpy()

    def process_with_preliminary(self, history, preliminary, num_samples: int = None) -> torch.Tensor:
        """Analyze one frame stitched from retained history plus the raw
        in-flight block of the current audio callback (the reference's
        preliminary-audio path, TransformDSP.inl:233-484). ``history``
        [pairs, 2, H] newest-last, ``preliminary`` [pairs, 2, S]; returns
        display results [pairs, 1, K, rows, P]."""
        frame = stitch_preliminary(
            self.constant, self._frames(history), self._frames(preliminary), num_samples
        )
        return self.process(frame[:, None])
