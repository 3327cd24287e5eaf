"""VectorscopeProcessor — stateful public face of the vectorscope view.

Counterpart of :mod:`signalizer_tpu.views.vectorscope` (ref:
Source/Vectorscope/Vectorscope.cpp:268-377, VectorscopeRendering.cpp). Owns
the meter filter states and auto-gain on one device, emits render-ready
vertex tensors ([N, 3] point clouds) and meter readouts. The processor
hands :func:`vs_step` its poles and user gain as float32 scalars kept on
the device (made once with its settings) and the tick's new-samples count
through a pinned buffer, so a step copies nothing from pageable memory; the
peak decay and the rotation stay host floats.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

from signalizer_tpu_torch.core.constant import resolve_device
from signalizer_tpu_torch.stream.pinned import PinnedUpload
from signalizer_tpu_torch.kernels.vectorscope import (
    VectorscopeMeterState,
    filter_coefficient,
    init_meter_state,
    lissajous_vertices,
    meter_readout,
    peak_autogain_update,
    polar_vertices,
    rms_autogain,
    update_meters,
)


class OperationalMode(enum.IntEnum):
    """ref: VectorscopeParameters.h operationalMode."""

    LISSAJOUS = 0
    POLAR = 1


class AutoGain(enum.IntEnum):
    """ref: VectorscopeParameters.h autoGain {None, RMS, PeakDecay}."""

    NONE = 0
    RMS = 1
    PEAK_DECAY = 2


class VectorscopeFrame(NamedTuple):
    vertices: torch.Tensor  # [..., W, 3] point cloud (x, y, age-fade z)
    balance: torch.Tensor  # [..., 2] quick/slow balance bars in [0, 1]
    correlation_bars: torch.Tensor  # [..., 2] quick/slow correlation bars in [0, 1]
    gain: torch.Tensor  # [...] applied gain


def vs_step(
    state: VectorscopeMeterState,
    peak_env: torch.Tensor,
    frames: torch.Tensor,
    envelope_pole,
    stereo_pole,
    user_gain,
    peak_coeff: float,
    rotation: float = 0.0,
    new_samples=None,
    meter_frames: torch.Tensor = None,
    *,
    mode: OperationalMode,
    autogain: AutoGain,
    scale_to_fill: bool,
):
    """One vectorscope step: ``(VectorscopeFrame, new_state, new_peak_env)``.

    ``new_samples``: trailing-samples meter mask for overlapping-window
    callers (see :func:`~signalizer_tpu_torch.kernels.vectorscope.update_meters`);
    the vertex/display path always renders the full window.
    ``meter_frames``: optionally a SHORTER trailing slice covering (at
    least) the new samples — the meters integrate only those, and the
    masked full-window form spends window/new_samples times the
    transcendental work (pow/atan/cos per sample). None = integrate over
    ``frames`` (non-overlapping feeds). The scalars are float32 values:
    host floats, or (the poles, the user gain and ``new_samples``) float32
    scalars on the frames' device."""
    f32 = dict(dtype=frames.dtype, device=frames.device)
    new_state = update_meters(
        state, frames if meter_frames is None else meter_frames,
        envelope_pole=envelope_pole, stereo_pole=stereo_pole,
        new_samples=new_samples,
    )
    # degenerate autogain readings HOLD the carried last-normal gain
    # instead of popping to unity (the reference's isnormal() guard,
    # Vectorscope.cpp:362-366 / VectorscopeRendering.cpp:884-888)
    if autogain == AutoGain.RMS:
        g = rms_autogain(new_state, fallback=state.gain)
        new_state = new_state._replace(gain=g)
        gain = g * user_gain
        new_peak_env = peak_env
    elif autogain == AutoGain.PEAK_DECAY:
        new_peak_env, g = peak_autogain_update(peak_env, frames, peak_coeff, fallback=state.gain)
        new_state = new_state._replace(gain=g)
        gain = g * user_gain
    else:
        gain = torch.as_tensor(user_gain, **f32).expand(frames.shape[:-2])
        new_peak_env = peak_env
    gain_b = gain[..., None]  # broadcast over the sample axis
    if mode == OperationalMode.POLAR:
        verts = polar_vertices(frames, gain=gain_b, scale_to_fill=scale_to_fill)
    else:
        verts = lissajous_vertices(frames, rotation=rotation, gain=gain_b)
    bars = meter_readout(new_state)
    return VectorscopeFrame(verts, bars["balance"], bars["correlation"], gain), new_state, new_peak_env


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a host float."""
    return float(np.float32(v))


class VectorscopeProcessor:
    """Stateful wrapper over the vectorscope functions.

    ``process(frames)`` with frames [pairs, 2, W] returns a
    :class:`VectorscopeFrame`; filter states carry across calls.
    ``device=None`` is the GPU and raises without one; the CPU is used only
    for ``device="cpu"``.
    """

    def __init__(
        self,
        *,
        pairs: int = 1,
        device=None,
        sample_rate: float = 48_000.0,
        mode: OperationalMode = OperationalMode.LISSAJOUS,
        autogain: AutoGain = AutoGain.NONE,
        envelope_window: float = 0.1,  # normalized (ref: envelopeWindow param)
        stereo_window: float = 0.02,
        rotation: float = 0.0,  # turns (ref: waveZRotation)
        user_gain: float = 1.0,
        frame_rate: float = 60.0,
        scale_to_fill: bool = False,
    ):
        self.device = resolve_device(device)
        self.pairs = pairs
        self.sample_rate = sample_rate
        self.mode = OperationalMode(mode)
        self.autogain = AutoGain(autogain)
        self.rotation = float(rotation)
        self.user_gain = float(user_gain)
        self.scale_to_fill = bool(scale_to_fill)
        self.frame_rate = frame_rate
        self.envelope_pole = filter_coefficient(envelope_window, sample_rate)
        self.stereo_pole = filter_coefficient(stereo_window, sample_rate)
        # (envelope pole, stereo pole, user gain) as f32 values and as a
        # [3] tensor on the device, remade when a value changes
        self._scalars_key = None
        self._scalars = None
        self._uploads = PinnedUpload(self.device)
        self.reset()

    @property
    def state(self) -> VectorscopeMeterState:
        return self._state

    @property
    def peak_envelope(self) -> torch.Tensor:
        """The peak autogain's envelope [pairs, 2]."""
        return self._peak_env

    def load_state(self, state: VectorscopeMeterState, peak_env=None) -> None:
        """Continue from a carried state (and peak envelope), e.g. one made
        by :func:`~signalizer_tpu_torch.kernels.vectorscope.meter_state_from_arrays`."""
        self._state = VectorscopeMeterState(*(t.to(self.device) for t in state))
        if peak_env is not None:
            self._peak_env = torch.as_tensor(peak_env, dtype=torch.float32).to(self.device)

    def reset(self) -> None:
        self._state = init_meter_state((self.pairs,), self.device)
        self._peak_env = torch.zeros((self.pairs, 2), dtype=torch.float32, device=self.device)

    def _frames(self, frames) -> torch.Tensor:
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(np.ascontiguousarray(frames, dtype=np.float32))
        return torch.as_tensor(frames, dtype=torch.float32).to(self.device)

    def process(self, frames, new_samples=None, meter_frames=None) -> VectorscopeFrame:
        """``new_samples``: when re-reading an overlapping history window
        per tick, the count of samples that are NEW since the last call —
        the meter filters consume each sample exactly once (the
        reference's audio-callback cadence, Vectorscope.cpp:319-342);
        None keeps the whole-window semantics for non-overlapping feeds.
        ``meter_frames``: optional shorter trailing slice for the meter
        update (see :func:`vs_step`)."""
        frames = self._frames(frames)
        if meter_frames is not None:
            meter_frames = self._frames(meter_frames)
        meter_w = frames.shape[-1] if meter_frames is None else meter_frames.shape[-1]
        scalars, new_samples = self._prep_step(frames.shape[-1], new_samples, meter_w=meter_w)
        frame, self._state, self._peak_env = vs_step(
            self._state,
            self._peak_env,
            frames,
            *scalars,
            new_samples,
            meter_frames,
            mode=self.mode,
            autogain=self.autogain,
            scale_to_fill=self.scale_to_fill,
        )
        return frame

    def _device_scalars(self) -> torch.Tensor:
        """The f32 envelope pole, stereo pole and user gain as a [3]
        tensor on the device: one copy when a value changes, none a step."""
        key = (_f32(self.envelope_pole), _f32(self.stereo_pole), _f32(self.user_gain))
        if key != self._scalars_key:
            self._scalars = torch.tensor(key, dtype=torch.float32, device=self.device)
            self._scalars_key = key
        return self._scalars

    def _prep_step(self, w: int, new_samples, meter_w: int = None):
        """Scalar prep for one step over a ``w``-sample window (one
        source of truth for every caller of :func:`vs_step`): ``(envelope_pole,
        stereo_pole, user_gain, peak_coeff, rotation)`` and the clamped
        new-samples count, each its float32 value: the first three as
        scalars kept on the device, the count (None or) a scalar uploaded
        through a pinned buffer, the peak decay and rotation host floats.
        ``meter_w``: width of the meter slice the count must clamp to
        (defaults to the display window width)."""
        env, stereo, gain = self._device_scalars()
        # peak autogain decay scaled per visible buffer per frame
        # (ref: VectorscopeRendering.cpp:839-842)
        scalars = (env, stereo, gain, _f32(self.envelope_pole ** (w / self.frame_rate)), _f32(self.rotation))
        if new_samples is not None:
            new_samples = _f32(min(float(new_samples), float(w if meter_w is None else meter_w)))
            new_samples = self._uploads.upload(new_samples)
        return scalars, new_samples
