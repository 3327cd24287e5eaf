"""ShardedAnalysisPipeline — end-to-end multi-device analysis.

Counterpart of :mod:`signalizer_tpu.parallel.pipeline`, over
:mod:`signalizer_tpu_torch.parallel.mesh`: host ingest feeds fixed-size
batches, sharded over the mesh's devices by channel pair (the reference's
pairs ``parallel_for``, SpectrumDSP.cpp:83), through the selected view's
sharded step. Filter states stay on their devices across ticks; the only
traffic between devices is each step's reduction (and the spectrogram's
pair blend).

One parameterization covers every view:

* ``view="fused"`` (default): spectrum + waveform resample + min-max
  envelopes + stereo meters in one step (bench cfg5 shape);
* ``view="spectrum"``: the plain spectrum step;
* ``view="spectrogram"``: colour columns with the cross-device pair blend;
* ``view="oscilloscope"``: trigger + resample over a rolling history;
* ``view="vectorscope"``: vertices + meters over a rolling history.

Framed views (fused/spectrum/spectrogram) ingest through a hopper and tick
when ``frames_per_tick`` frames are ready (a short batch is zero-padded and
masked); scope views ingest into a rolling ring and analyze the latest
window every tick. Each tick's audio crosses to the devices once, from a
pinned host buffer; the scalars a tick passes are host numbers.

Usage::

    mesh = make_analysis_mesh()           # every CUDA device
    pipe = ShardedAnalysisPipeline(constant, pairs=64, mesh=mesh)
    pipe.push(block_64_pairs)             # [128, n] interleaved pairs
    out = pipe.tick()                     # None until a batch is ready
    out.results / out.waveform / out.global_peak

Outputs are in the mesh's sharded form: tensors on a one-device mesh, a
list of per-device tensors on several (:mod:`~signalizer_tpu_torch.parallel.mesh`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from signalizer_tpu_torch.core.constant import SpectrumConstant
from signalizer_tpu_torch.kernels.oscilloscope import sinc_resample_matrix
from signalizer_tpu_torch.kernels.vectorscope import init_meter_state
from signalizer_tpu_torch.parallel.mesh import (
    _on,
    init_sharded_state,
    make_analysis_mesh,
    mesh_devices,
    shard_batch,
    sharded_fused_step,
    sharded_oscilloscope_step,
    sharded_spectrogram_step,
    sharded_spectrum_step,
    sharded_vectorscope_step,
)
from signalizer_tpu_torch.stream.batcher import FrameBatcher
from signalizer_tpu_torch.stream.ring_buffer import make_ring_buffer

FRAMED_VIEWS = ("fused", "spectrum", "spectrogram")
SCOPE_VIEWS = ("oscilloscope", "vectorscope")


class PipelineOutput(NamedTuple):
    """One fused tick's outputs (sharded over pairs except the scalar
    diagnostic)."""

    results: object  # [pairs, T, K, rows, P] spectrum display values
    waveform: object  # [pairs, T, pixels] resampled first-channel wave
    envelope_min: object  # [pairs, T, pixels]
    envelope_max: object
    correlation: object  # [pairs, T, W] per-sample stereo correlation
    global_peak: torch.Tensor  # [] the cross-device max


class SpectrumOutput(NamedTuple):
    results: object  # [pairs, T, K, rows, P]
    global_peak: torch.Tensor


class SpectrogramOutput(NamedTuple):
    columns: torch.Tensor  # [T, P, 4] RGBA8, pairs blended, on the first device


class OscilloscopeOutput(NamedTuple):
    frame: object  # OscilloscopeFrame (fields sharded over pairs)
    global_level: torch.Tensor


class VectorscopeOutput(NamedTuple):
    frame: object  # VectorscopeFrame (fields sharded over pairs)
    global_level: torch.Tensor


def _f32(v: float) -> float:
    return float(np.float32(v))


class ShardedAnalysisPipeline:
    """Multi-device analysis over many channel pairs, any view."""

    def __init__(
        self,
        constant: Optional[SpectrumConstant] = None,
        *,
        pairs: int,
        mesh=None,
        view: str = "fused",
        pixels: int = 1024,
        frames_per_tick: int = 4,
        overlap: float = 0.0,
        # spectrogram
        colours: Optional[np.ndarray] = None,
        ratios: Optional[np.ndarray] = None,
        # oscilloscope
        osc_constant=None,
        window_samples: float = 1024.0,
        history_samples: int = 16384,
        # vectorscope
        envelope_pole: float = 0.999,
        stereo_pole: float = 0.99,
        user_gain: float = 1.0,
        peak_coeff: float = 0.99,
        vs_mode=None,
        vs_autogain=None,
        rotation: float = 0.0,
        scale_to_fill: bool = False,
    ):
        if view not in FRAMED_VIEWS + SCOPE_VIEWS:
            raise ValueError(f"unknown view {view!r}")
        self.mesh = mesh_devices(mesh if mesh is not None else make_analysis_mesh())
        n_dev = len(self.mesh)
        if pairs % n_dev != 0:
            raise ValueError(f"pairs ({pairs}) must divide over {n_dev} devices")
        self.view = view
        self.pairs = pairs
        self.pixels = pixels
        self.frames_per_tick = int(frames_per_tick)
        self.ticks = 0
        self._last_clock = 0
        dev0 = self.mesh[0]
        # the pinned host buffer each tick's audio is staged in on a GPU mesh,
        # and the events of its last upload (see _stage)
        self._staging = None
        self._uploaded = None

        if view in FRAMED_VIEWS:
            if constant is None:
                raise ValueError(f"view {view!r} needs a SpectrumConstant")
            self.constant = _on(constant, dev0)
            w = constant.window_size
            hop = max(1.0, w * (1.0 - overlap))
            self.batcher = FrameBatcher(
                pairs * 2, w, hop, capacity=max(w * 4, int(hop * (frames_per_tick + 2)))
            )
            self._state = init_sharded_state(self.constant, pairs, self.mesh)
            if view == "fused":
                resample_m = sinc_resample_matrix(w, 0.0, w / pixels, pixels, device=dev0)
                self._step = sharded_fused_step(self.constant, resample_m, self.mesh, pixels=pixels)
                self._vstate = shard_batch(init_meter_state((pairs,), device=dev0), self.mesh)
            elif view == "spectrum":
                self._step = sharded_spectrum_step(self.constant, self.mesh)
            else:  # spectrogram
                from signalizer_tpu_torch.kernels.colormap import normalize_ratios
                from signalizer_tpu_torch.views.spectrogram import (
                    DEFAULT_GRADIENT,
                    DEFAULT_RATIOS,
                    SpectrogramProcessor,
                )

                base = np.asarray(colours if colours is not None else DEFAULT_GRADIENT, np.float32)
                if base.ndim == 2:
                    # one table -> per-pair hue rotation, as the
                    # single-device SpectrogramProcessor rotates it (ref:
                    # generateSpectrogramColourRotation)
                    base = np.stack([SpectrogramProcessor._rotate(base, p, pairs) for p in range(pairs)])
                self._colours = shard_batch(np.ascontiguousarray(base, np.float32), self.mesh)
                self._ratios = torch.as_tensor(
                    normalize_ratios(ratios if ratios is not None else DEFAULT_RATIOS),
                    dtype=torch.float32,
                ).to(dev0)
                self._step = sharded_spectrogram_step(self.constant, self.mesh)
        elif view == "oscilloscope":
            from signalizer_tpu_torch.views.oscilloscope import (
                init_oscilloscope_state,
                make_oscilloscope_constant,
            )

            self.osc_constant = _on(
                osc_constant if osc_constant is not None else make_oscilloscope_constant(device=dev0),
                dev0,
            )
            self.window_samples = float(window_samples)
            self.history_samples = int(history_samples)
            self.ring = make_ring_buffer(pairs * 2, self.history_samples)
            self._state = shard_batch(init_oscilloscope_state(self.osc_constant, pairs), self.mesh)
            self._step = sharded_oscilloscope_step(
                self.osc_constant, self.mesh, pairs=pairs if pairs > 1 else None
            )
        else:  # vectorscope
            from signalizer_tpu_torch.views.vectorscope import AutoGain, OperationalMode

            self.history_samples = int(history_samples)
            self.ring = make_ring_buffer(pairs * 2, self.history_samples)
            self._state = shard_batch(init_meter_state((pairs,), device=dev0), self.mesh)
            self._peak_env = shard_batch(torch.zeros((pairs, 2), dtype=torch.float32, device=dev0), self.mesh)
            self._vs_scalars = tuple(_f32(v) for v in (envelope_pole, stereo_pole, user_gain, peak_coeff))
            self._step = sharded_vectorscope_step(
                self.mesh,
                mode=vs_mode if vs_mode is not None else OperationalMode.LISSAJOUS,
                autogain=vs_autogain if vs_autogain is not None else AutoGain.PEAK_DECAY,
                rotation=rotation,
                scale_to_fill=scale_to_fill,
            )

    # --- ingest -------------------------------------------------------------
    def push(self, block: np.ndarray) -> None:
        """Feed interleaved pair audio [pairs*2, n]."""
        if self.view in FRAMED_VIEWS:
            self.batcher.push(block)
        else:
            self.ring.write(np.asarray(block, np.float32))

    def ready(self) -> bool:
        if self.view in FRAMED_VIEWS:
            return self.batcher.frames_ready() >= self.frames_per_tick
        return self.ring.valid_samples > 0

    # --- tick ---------------------------------------------------------------
    def tick(self, transport_position: float = 0.0):
        """Run one sharded step; None until the ingest has enough audio.

        ``transport_position`` (oscilloscope view): the playhead position
        in samples — TriggerMode.WINDOW scrolls the display against it."""
        if not self.ready():
            return None
        if self.view in FRAMED_VIEWS:
            frames_dev, valid = self._pull_framed()
            if self.view == "fused":
                (results, wave, mins, maxs, corr,
                 self._state, self._vstate, peak) = self._step(self._state, self._vstate, frames_dev, valid)
                out = PipelineOutput(results, wave, mins, maxs, corr, peak)
            elif self.view == "spectrum":
                results, self._state, peak = self._step(self._state, frames_dev, valid)
                out = SpectrumOutput(results, peak)
            else:
                cols, self._state = self._step(self._state, frames_dev, self._colours, self._ratios, valid)
                out = SpectrogramOutput(cols)
        else:
            clock = self.ring.sample_clock
            new = _f32(min(max(0, clock - self._last_clock), self.history_samples))
            self._last_clock = clock
            staged = self._stage((self.pairs * 2, self.history_samples), torch.float32)
            self.ring.latest(self.history_samples, out=staged.numpy())
            hist_dev = self._upload(staged.view(self.pairs, 2, self.history_samples))
            if self.view == "oscilloscope":
                frame, self._state, level = self._step(
                    self._state, hist_dev, _f32(self.window_samples), _f32(transport_position), new
                )
                out = OscilloscopeOutput(frame, level)
            else:
                ep, sp, ug, pc = self._vs_scalars
                # meters see each sample once across overlapping
                # rolling-window reads (audio-callback cadence)
                frame, self._state, self._peak_env, level = self._step(
                    self._state, self._peak_env, hist_dev, ep, sp, ug, pc, new
                )
                out = VectorscopeOutput(frame, level)
        self.ticks += 1
        return out

    def _stage(self, shape, dtype) -> torch.Tensor:
        """The host buffer a tick's audio is staged in: on a GPU mesh one
        pinned buffer, handed out again once the last upload from it has
        finished; on a CPU mesh a fresh tensor a tick (the shards are views
        of it)."""
        if self.mesh[0].type != "cuda":
            return torch.empty(shape, dtype=dtype)
        for event in self._uploaded or ():
            event.synchronize()
        self._uploaded = None
        if self._staging is None or tuple(self._staging.shape) != shape:
            self._staging = torch.empty(shape, dtype=dtype, pin_memory=True)
        return self._staging

    def _upload(self, host: torch.Tensor):
        """One copy of a staged batch to the mesh, its leading axis sharded,
        queued without waiting on a GPU (the buffer is pinned)."""
        parts = torch.chunk(host, len(self.mesh), dim=0)
        moved = [p.to(d, non_blocking=True) for p, d in zip(parts, self.mesh)]
        if self.mesh[0].type == "cuda":
            self._uploaded = []
            for d in self.mesh:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(d))
                self._uploaded.append(event)
        return moved[0] if len(self.mesh) == 1 else moved

    def _pull_framed(self):
        t = self.frames_per_tick
        frames = self.batcher.pull(t)  # [T, pairs*2, W]
        real = frames.shape[0]
        w = self.constant.window_size
        staged = self._stage((self.pairs, t, 2, w), torch.float32)
        view = staged.numpy()
        # [T, pairs*2, W] -> [pairs, T, 2, W]; frames that scrolled out of
        # the ring under backpressure are zero-padded to keep the batch
        # shape (the batcher counts the drops) and masked out of the states
        view[:, :real] = frames.reshape(real, self.pairs, 2, w).transpose(1, 0, 2, 3)
        valid = None
        if real < t:
            view[:, real:] = 0.0
            valid = torch.as_tensor(np.arange(t) < real)
            if self.mesh[0].type == "cuda":
                valid = valid.pin_memory().to(self.mesh[0], non_blocking=True)
        return self._upload(staged), valid

    @property
    def meter_state(self):
        """The vectorscope meter state on the mesh (fused and vectorscope
        views)."""
        v = getattr(self, "_vstate", None)
        if v is not None:
            return v
        return self._state if self.view == "vectorscope" else None
