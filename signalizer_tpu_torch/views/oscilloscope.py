"""OscilloscopeProcessor — the stateful public face of the oscilloscope.

Counterpart of :mod:`signalizer_tpu.views.oscilloscope` (ref:
Source/Oscilloscope/Oscilloscope.cpp, OscilloscopeDSP.inl,
OscilloscopeRendering.cpp:560-891), with the same shapes and semantics, on
tensors on one explicit device. Rendering is out of scope; outputs are
render-ready pixel-space tensors.

* The processor reads windows out of a continuous history tensor and
  centers the display window on the latest detected trigger (the JAX
  package's design; its module docstring has the reasons).
* :class:`OscilloscopeConstant` holds Python scalars and tensors on one
  device. :func:`osc_step` returns a new :class:`OscilloscopeState`, as the
  JAX step does.
* The per-call scalars (window, transport position, new-sample count) stay
  on the host as float32 numbers: the JAX step computes with them as f32
  device scalars, and numpy's float32 arithmetic rounds the same, so the
  step uploads nothing per call. In the Cycles time mode the processor
  reads the detected cycle length back once per call (one device sync) to
  form the next window.
* The resamples (wave, envelope pick, colour track) run on kernel C
  (:mod:`signalizer_tpu_torch.kernels.banded_resample`); the colour track
  itself (the crossover, the smoothed band energies and the colour mix) is
  one launch of kernel E (:mod:`signalizer_tpu_torch.kernels.colour_track`),
  whose channel-major colours kernel C picks from without a copy.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from signalizer_tpu_torch.core.config import OscChannels
from signalizer_tpu_torch.params.transformatters import TimeMode
from signalizer_tpu_torch.utils.colour import pair_key_table
from signalizer_tpu_torch.core.constant import resolve_device
from signalizer_tpu_torch.kernels.colour_track import colour_track
from signalizer_tpu_torch.kernels.filters import CrossoverState, init_crossover_state
from signalizer_tpu_torch.kernels.oscilloscope import (
    INTERPOLATION_KERNEL_SIZE,
    MEDIAN_FILTER_SIZE,
    BinRecord,
    linear_resample,
    nearest_resample,
    sinc_resample,
    sinc_resample_with_nearest,
    trigger_phase_offset,
    zero_crossing_triggers,
)
from signalizer_tpu_torch.kernels.peak_hold import (
    FIRE_AGE_NONE as _FIRE_AGE_NONE,
    PEAK_QUEUE_SIZE,
    envelope_hold_trigger,
    window_start as _window_start,
)
from signalizer_tpu_torch.kernels.spectral_walk import spectral_walk_filtered_spectrum

F32 = np.float32


class TriggerMode(enum.IntEnum):
    """ref: OscilloscopeParameters.h:50-58."""

    NONE = 0
    SPECTRAL = 1
    WINDOW = 2
    ENVELOPE_HOLD = 3
    ZERO_CROSSING = 4


class SubSampleInterpolation(enum.IntEnum):
    """ref: OscilloscopeParameters.h sampleInterpolation."""

    NONE = 0
    RECTANGULAR = 1
    LINEAR = 2
    LANCZOS = 3


class AutoGain(enum.IntEnum):
    """ref: OscilloscopeParameters.h:424 autoGain {None, RMS, Peak decay}."""

    NONE = 0
    RMS = 1
    PEAK_DECAY = 2


@dataclasses.dataclass(frozen=True)
class OscilloscopeConstant:
    """Immutable oscilloscope configuration (ref: the flag-guarded members
    of Oscilloscope::StreamState, Oscilloscope.cpp:236-308): Python scalars
    that choose the work, and 0-d or small tensors on one device."""

    channel_mode: OscChannels
    trigger_mode: TriggerMode
    interpolation: SubSampleInterpolation
    pixels: int
    lookahead: int
    sample_rate: float
    autogain: AutoGain
    colour_enabled: bool
    custom_trigger: bool  # ref: OscilloscopeDSP.inl:69-78
    trigger_channel: int

    threshold: torch.Tensor  # scalar f32
    hysteresis: torch.Tensor  # scalar f32
    phase_degrees: torch.Tensor  # scalar f32
    envelope_ln_pole: torch.Tensor  # scalar f32: ln c, c = exp(-1/(win_s*fs))
    colour_pole: torch.Tensor  # scalar f32
    band_colours: torch.Tensor  # [3, 3] low/mid/high rgb
    key_colours: torch.Tensor  # [2, 3] primary/secondary rgb per row
    colour_blend: torch.Tensor  # scalar f32
    manual_gain: torch.Tensor  # scalar f32
    custom_trigger_frequency: torch.Tensor  # scalar f32 Hz

    # the key colours on the host, for the per-pair table (no readback)
    host_key_colours: np.ndarray = dataclasses.field(default=None, compare=False)
    # colour_pole's value on the host, for kernel E's tables (no readback)
    host_colour_pole: float = dataclasses.field(default=None, compare=False)

    @property
    def rows(self) -> int:
        return 2 if self.channel_mode in (OscChannels.SEPARATE, OscChannels.MIDSIDE) else 1

    @property
    def device(self) -> torch.device:
        return self.threshold.device


def make_oscilloscope_constant(
    *,
    device=None,
    sample_rate: float = 48_000.0,
    channel_mode: OscChannels = OscChannels.SEPARATE,
    trigger_mode: TriggerMode = TriggerMode.NONE,
    interpolation: SubSampleInterpolation = SubSampleInterpolation.LANCZOS,
    pixels: int = 1024,
    lookahead: int = 8192,
    trigger_threshold: float = 0.0,
    trigger_hysteresis: float = 0.0,
    trigger_phase_degrees: float = 0.0,
    autogain: Union[AutoGain, bool, int] = AutoGain.NONE,
    envelope_window_ms: float = 1000.0,
    colour_enabled: bool = False,
    colour_smooth_ms: float = 10.0,
    band_colours=((1.0, 0.1, 0.1), (0.1, 1.0, 0.1), (0.1, 0.1, 1.0)),
    key_colour=(1.0, 1.0, 1.0),
    secondary_colour=None,
    colour_blend: float = 1.0,
    manual_gain: float = 1.0,
    trigger_channel: int = 0,
    custom_trigger: bool = False,
    custom_trigger_frequency: float = 440.0,
) -> OscilloscopeConstant:
    device = resolve_device(device)  # None: the GPU, raising without one
    if isinstance(autogain, bool):
        autogain = AutoGain.PEAK_DECAY if autogain else AutoGain.NONE
    # ref: SmoothedParameterState-designed pole over colour_smooth_ms
    n = max(colour_smooth_ms * 1e-3 * sample_rate, 1.0)
    colour_pole = float(np.exp(-1.0 / n))
    # envelope one-pole (ref: OscilloscopeDSP.inl:448/:747 envelopeCoeff)
    env_n = max(envelope_window_ms * 1e-3 * sample_rate, 1.0)
    key = np.asarray(key_colour, np.float32)
    second = np.asarray(
        secondary_colour if secondary_colour is not None else key_colour, np.float32
    )

    def t(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    return OscilloscopeConstant(
        channel_mode=OscChannels(channel_mode),
        trigger_mode=TriggerMode(trigger_mode),
        interpolation=SubSampleInterpolation(interpolation),
        pixels=int(pixels),
        lookahead=int(lookahead),
        sample_rate=float(sample_rate),
        autogain=AutoGain(autogain),
        colour_enabled=bool(colour_enabled),
        custom_trigger=bool(custom_trigger),
        trigger_channel=int(trigger_channel),
        threshold=t(trigger_threshold),
        hysteresis=t(trigger_hysteresis),
        phase_degrees=t(trigger_phase_degrees),
        envelope_ln_pole=t(-1.0 / env_n),
        colour_pole=t(colour_pole),
        band_colours=t(band_colours),
        key_colours=t(np.stack([key, second])),
        colour_blend=t(colour_blend),
        manual_gain=t(manual_gain),
        custom_trigger_frequency=t(custom_trigger_frequency),
        host_key_colours=np.stack([key[:3], second[:3]]).astype(np.float64),
        host_colour_pole=float(np.float32(colour_pole)),
    )


class OscilloscopeState(NamedTuple):
    """Carried device state."""

    peak_env: torch.Tensor  # [pairs, rows] autogain envelope (peak^2 or RMS)
    peak_hold_state: torch.Tensor  # [pairs] envelope-hold tracker
    peak_holding: torch.Tensor  # [pairs] bool
    median_history: torch.Tensor  # [pairs, 8] past fundamental omegas
    crossover: CrossoverState  # [pairs, rows, ...] colour network states
    colour_smooth: torch.Tensor  # [pairs, rows, 3] band smoothing states
    peak_fire_ages: torch.Tensor  # [pairs, PEAK_QUEUE_SIZE] samples since the
    # most recent envelope-hold fires (ascending; _FIRE_AGE_NONE = empty)


def init_oscilloscope_state(constant: OscilloscopeConstant, pairs: int) -> OscilloscopeState:
    rows = constant.rows
    dev = constant.device
    f32 = torch.float32
    return OscilloscopeState(
        peak_env=torch.zeros((pairs, rows), dtype=f32, device=dev),
        peak_hold_state=torch.square(constant.threshold).expand(pairs).clone(),
        peak_holding=torch.zeros((pairs,), dtype=torch.bool, device=dev),
        median_history=torch.full((pairs, MEDIAN_FILTER_SIZE), -1.0, dtype=f32, device=dev),
        crossover=init_crossover_state((pairs, rows), f32, dev),
        colour_smooth=torch.zeros((pairs, rows, 3), dtype=f32, device=dev),
        peak_fire_ages=torch.full((pairs, PEAK_QUEUE_SIZE), _FIRE_AGE_NONE, dtype=f32, device=dev),
    )


def oscilloscope_state_from_arrays(arrays, device=None) -> OscilloscopeState:
    """An :class:`OscilloscopeState` from carried state given as arrays: a
    mapping or a named tuple with the state's field names (e.g. a JAX
    ``OscilloscopeState`` read leaf by leaf with ``np.asarray``), whose
    ``crossover`` is the crossover's ``z`` array or an object holding it as
    ``.z``. Copied to ``device`` (``None``: the GPU)."""
    device = resolve_device(device)
    fields = arrays._asdict() if hasattr(arrays, "_asdict") else dict(arrays)
    xover = fields["crossover"]
    xover = getattr(xover, "z", xover)

    def t(v, dtype=torch.float32):
        return torch.tensor(np.asarray(v), device=device).to(dtype)

    return OscilloscopeState(
        peak_env=t(fields["peak_env"]),
        peak_hold_state=t(fields["peak_hold_state"]),
        peak_holding=t(fields["peak_holding"], torch.bool),
        median_history=t(fields["median_history"]),
        crossover=CrossoverState(z=t(xover)),
        colour_smooth=t(fields["colour_smooth"]),
        peak_fire_ages=t(fields["peak_fire_ages"]),
    )


class OscilloscopeFrame(NamedTuple):
    """Render-ready outputs."""

    waveform: torch.Tensor  # [pairs, rows, pixels] resampled values (gain applied)
    envelope_min: torch.Tensor  # [pairs, rows, pixels] min-max decimation
    envelope_max: torch.Tensor
    colours: torch.Tensor  # [pairs, rows, pixels, 3]
    gain: torch.Tensor  # [pairs]
    fundamental: torch.Tensor  # [pairs] (spectral mode; else 0)
    trigger_found: torch.Tensor  # [pairs] bool


def _pack_rows(frames: torch.Tensor, mode: OscChannels) -> torch.Tensor:
    """history [pairs, 2, H] -> display rows [pairs, rows, H]
    (ref: SampleColourEvaluators.h channel-mode evaluators)."""
    left = frames[..., 0, :]
    right = frames[..., 1, :]
    if mode == OscChannels.LEFT:
        return left[..., None, :]
    if mode == OscChannels.RIGHT:
        return right[..., None, :]
    if mode == OscChannels.MERGE:
        return ((left + right) * 0.5)[..., None, :]
    if mode == OscChannels.SIDE:
        return ((left - right) * 0.5)[..., None, :]
    if mode == OscChannels.SEPARATE:
        return frames
    if mode == OscChannels.MIDSIDE:
        return torch.stack([(left + right) * 0.5, (left - right) * 0.5], dim=-2)
    raise ValueError(mode)


def make_pair_key_colours(constant: OscilloscopeConstant, pairs: int) -> Optional[torch.Tensor]:
    """Hue-rotated key-colour table [pairs, 2, 3] for multi-pair draws, or
    None for a single pair (ref: CHANGELOG 0.4.0 / ColourRotation), from the
    JAX package's ``pair_key_table``."""
    if pairs <= 1:
        return None
    kc = constant.host_key_colours
    return torch.from_numpy(pair_key_table(kc[0], kc[1], pairs)).to(constant.device)


def _autogain_update(
    constant: OscilloscopeConstant,
    env: torch.Tensor,
    rows: torch.Tensor,
    new_samples: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance the autogain envelope and derive the display gain.

    Peak decay (ref: runPeakFilter, OscilloscopeDSP.inl:712-886):
    ``env' = max(env * c^n, peak^2)``, gain ``1/sqrt(max_c env')``.

    RMS (ref: OscilloscopeDSP.inl:505-698): the per-sample one-pole over
    the n new samples, in closed form, ``env' = c^n env + (1-c) sum_k
    c^(n-1-k) x_k^2``, as an elementwise product and a sum (no TF32).
    """
    pairs = rows.shape[0]
    ln_c = constant.envelope_ln_pole
    ns = float(F32(new_samples))
    if constant.autogain == AutoGain.PEAK_DECAY:
        peaks = torch.amax(torch.abs(rows), dim=-1)  # [pairs, rows]
        pole = torch.exp(ln_c * ns)
        new_env = torch.maximum(env * pole, peaks * peaks)
    elif constant.autogain == AutoGain.RMS:
        sq = rows * rows
        if constant.channel_mode == OscChannels.MIDSIDE:
            sq = sq * 2.0  # ref smooths 0.5(l±r)^2; rows are 0.5(l±r)
        h = rows.shape[-1]
        k = torch.arange(h, dtype=torch.float32, device=rows.device)
        age = (h - 1.0) - k
        # (1-c) c^age, zeroed for samples older than the new block
        w = torch.exp(ln_c * age) * -torch.expm1(ln_c)
        w = torch.where(k >= float(F32(h) - F32(ns)), w, 0.0)
        contrib = torch.sum(sq * w, dim=-1)
        new_env = torch.exp(ln_c * ns) * env + contrib
    else:
        g = torch.ones((pairs,), dtype=torch.float32, device=rows.device) * constant.manual_gain
        return env, g
    g = 1.0 / torch.sqrt(torch.amax(new_env, dim=-1))
    gain = torch.where(torch.isfinite(g) & (g > 0), g, 1.0) * constant.manual_gain
    return new_env, gain


def osc_step(
    constant: OscilloscopeConstant,
    state: OscilloscopeState,
    history: torch.Tensor,
    window: float,
    transport_position: float,
    new_samples: float,
    pair_keys: Optional[torch.Tensor] = None,
    *,
    trigger_chunk: Optional[int] = None,
    env_os: Optional[int] = None,
) -> Tuple[OscilloscopeFrame, OscilloscopeState]:
    """One oscilloscope step (counterpart of ``osc_step_impl``,
    ``signalizer_tpu/views/oscilloscope.py:568-835``).

    ``history`` [pairs, 2, H] f32 on the constant's device. ``window``,
    ``transport_position`` and ``new_samples`` are host numbers, used as
    float32 (the JAX step's f32 device scalars). ``pair_keys`` [pairs, 2,
    3]: per-pair hue-rotated key colours, or None. ``trigger_chunk``:
    envelope-hold only, scan just the trailing ``trigger_chunk`` samples
    (None = the full lookahead region, valid-masked to the new tail).
    ``env_os``: per-pixel oversampling of the min-max envelope, which must
    be >= (window - 1) / (pixels - 1); None = the conservative
    ``ceil((h - 1) / (pixels - 1))``. Returns the frame and a new state.
    """
    pairs, _, h = history.shape
    dev = history.device
    pixels = constant.pixels
    sample_rate = constant.sample_rate
    rows = _pack_rows(history, constant.channel_mode)  # [pairs, rows, H]
    # trigger channel selection (ref: calculateTriggerIndices,
    # OscilloscopeParameters.h:491-505)
    trig_src = rows[:, constant.trigger_channel % rows.shape[1], :]
    hf = F32(h)
    window = min(F32(window), hf)
    transport = F32(transport_position)
    new_samples = F32(new_samples)

    fundamental = torch.zeros((pairs,), dtype=torch.float32, device=dev)
    found = torch.ones((pairs,), dtype=torch.bool, device=dev)
    new_median = state.median_history
    new_ph_state = state.peak_hold_state
    new_holding = state.peak_holding
    new_fire_ages = state.peak_fire_ages

    trigger_mode = constant.trigger_mode
    threshold = constant.threshold
    # --- trigger: fractional sample offset from the end of history --------
    if trigger_mode == TriggerMode.ZERO_CROSSING:
        la = min(constant.lookahead, h)
        region = trig_src[..., h - la :]
        fires = zero_crossing_triggers(region, threshold)
        # the most recent trigger with a full half-window of samples after
        # it (ref: the buffer swap waits for that half, StreamPreprocessing.h:78)
        fidx = torch.arange(la, dtype=torch.float32, device=dev)
        pos_ok = (h - la) + fidx <= float(hf - window * F32(0.5))
        last = torch.amax(torch.where(fires & pos_ok, fidx, -1.0), dim=-1)
        found = last >= 0
        trigger_pos = (h - la) + torch.clamp(last, min=0.0)
        start = _window_start(found, trigger_pos, hf, window)
    elif trigger_mode == TriggerMode.ENVELOPE_HOLD:
        # each sample is consumed once, as it arrives (ref:
        # StreamPreprocessing.h:270-312): scan only the new tail, keep
        # earlier fires as ages in a small queue, and show the newest fire
        # whose half window is complete
        la = min(constant.lookahead, h)
        chunk = la if trigger_chunk is None else max(1, min(trigger_chunk, la))
        region = trig_src[..., h - chunk :]
        ns = min(max(new_samples, F32(0.0)), F32(chunk))
        # the consumed samples are the suffix i >= chunk - ns (in float32):
        # kernel D takes its first index as a host int (no mask to upload)
        # and runs the scan, the fire-age queue and the window start in one
        # launch (kernels/peak_hold.py)
        new_ph_state, new_holding, new_fire_ages, found, start = envelope_hold_trigger(
            region,
            threshold,
            constant.hysteresis,
            state.peak_hold_state,
            state.peak_holding,
            state.peak_fire_ages,
            first=int(np.ceil(F32(chunk) - ns)),
            new_samples=new_samples,
            window=window,
            hf=hf,
        )
    elif trigger_mode == TriggerMode.SPECTRAL:
        la = min(constant.lookahead, h)
        region = trig_src[..., h - la :]
        if constant.custom_trigger:
            # user frequency short-circuits the fundamental search
            # (ref: OscilloscopeDSP.inl:69-78 — BinRecord{0, 1, f/fs * N})
            # f / fs * N with the division as the jitted JAX step does it,
            # a product with the f32 reciprocal of the constant fs
            omega = constant.custom_trigger_frequency * float(F32(1.0 / sample_rate)) * la
            record = BinRecord(
                index=torch.zeros((pairs,), dtype=torch.int32, device=dev),
                value=torch.ones((pairs,), dtype=torch.float32, device=dev),
                offset=omega.expand(pairs).to(torch.float32),
            )
            fundamental = constant.custom_trigger_frequency.expand(pairs).to(torch.float32)
            cycles = sample_rate / fundamental
        else:
            # the candidate walk and the median filter on the rfft: kernel F
            # in one launch (kernels/spectral_walk.py), which forms the
            # magnitudes and offsets itself; no host sync
            new_median, record, _ = spectral_walk_filtered_spectrum(
                torch.fft.rfft(region, dim=-1), la, state.median_history, threshold, constant.hysteresis
            )
            fundamental = sample_rate * torch.clamp(record.omega(), min=5.0 * la / sample_rate) / la
            cycles = sample_rate / fundamental
        sample_offset = trigger_phase_offset(
            region,
            record.omega(),
            cycles,
            float(window),
            sample_rate,
            fundamental,
            record.offset,
            constant.phase_degrees,
        )
        # anchor one cycle before the window end, then advance by the
        # phase-derived offset (ref: OscilloscopeRendering.cpp:604-613)
        start = float(hf - window) - cycles + sample_offset
        start = torch.clamp(start, 0.0, float(hf - window))
    elif trigger_mode == TriggerMode.WINDOW:
        # window-synced scroll (ref: OscilloscopeRendering.cpp:587-592);
        # np.mod on float32 is a floor-mod, as jnp.mod
        real_offset = np.mod(transport, window)
        hi = hf - window
        start = torch.full((pairs,), float(min(max(hi - real_offset, F32(0.0)), hi)), dtype=torch.float32, device=dev)
    else:
        start = torch.full((pairs,), float(hf - window), dtype=torch.float32, device=dev)

    # (window - 1) / (pixels - 1) as the jitted JAX step computes it: XLA
    # rewrites the division by a constant into a product with its f32
    # reciprocal (the pixel positions then round once, see affine_positions
    # in kernels/banded_resample.py)
    step = float((window - F32(1.0)) * F32(1.0 / max(pixels - 1, 1)))

    # --- resample rows to pixel space --------------------------------------
    start_r = start[:, None]
    os_ = env_os if env_os is not None else max(1, -(-(h - 1) // max(pixels - 1, 1)))
    env_pick = None
    if constant.interpolation == SubSampleInterpolation.LANCZOS:
        if os_ == 1:
            wave, env_pick = sinc_resample_with_nearest(
                rows, start_r, step, pixels, INTERPOLATION_KERNEL_SIZE
            )
        else:
            wave = sinc_resample(rows, start_r, step, pixels, INTERPOLATION_KERNEL_SIZE)
    elif constant.interpolation == SubSampleInterpolation.LINEAR:
        wave = linear_resample(rows, start_r, step, pixels)
    else:  # NONE / RECTANGULAR: nearest sample
        wave = nearest_resample(rows, start_r, step, pixels)

    # min-max envelope over the displayed window: nearest picks at os_
    # points per pixel, reduced per pixel (the JAX step's formulation)
    if env_pick is not None:
        dense = env_pick
    else:
        dense = nearest_resample(rows, start_r, float(F32(step) / F32(os_)), pixels * os_)
    dense = dense.reshape(dense.shape[:-1] + (pixels, os_))
    env_min = torch.amin(dense, dim=-1)
    env_max = torch.amax(dense, dim=-1)

    # --- autogain (ref: analyseAndSetupState, OscilloscopeDSP.inl:44-59) ---
    new_peak_env, gain = _autogain_update(constant, state.peak_env, rows, new_samples)
    wave = wave * gain[:, None, None]

    # per-row key colours, hue-rotated per pair when pair_keys is given
    if pair_keys is None:
        key = constant.key_colours[: rows.shape[1]]  # [rows, 3]
    else:
        key = pair_keys[:, : rows.shape[1], :]  # [pairs, rows, 3]

    # --- colouring ----------------------------------------------------------
    if constant.colour_enabled:
        colours, new_xover, new_smooth = colour_track(
            rows,
            sample_rate,
            state.crossover,
            constant.host_colour_pole,
            constant.band_colours,
            key,
            constant.colour_blend,
            state.colour_smooth,
        )  # [pairs, rows, 3, H], channel-major
        # nearest pick of the colour track through kernel C, the rgb
        # channels folded into its row axis: [pairs, rows*3, H] (a view of
        # the kernel's output)
        nrows = colours.shape[1]
        cflat = colours.reshape(pairs, nrows * 3, h)
        pix = nearest_resample(cflat, start_r, step, pixels)
        pix_colours = torch.movedim(pix.reshape(pairs, nrows, 3, pixels), 2, 3)
    else:
        new_xover = state.crossover
        new_smooth = state.colour_smooth
        flat_key = key[None, :, None, :] if key.ndim == 2 else key[:, :, None, :]
        pix_colours = flat_key.expand(pairs, rows.shape[1], pixels, 3)

    frame = OscilloscopeFrame(
        waveform=wave,
        envelope_min=env_min * gain[:, None, None],
        envelope_max=env_max * gain[:, None, None],
        colours=pix_colours,
        gain=gain,
        fundamental=fundamental,
        trigger_found=found,
    )
    new_state = OscilloscopeState(
        peak_env=new_peak_env,
        peak_hold_state=new_ph_state,
        peak_holding=new_holding,
        median_history=new_median,
        crossover=new_xover,
        colour_smooth=new_smooth,
        peak_fire_ages=new_fire_ages,
    )
    return frame, new_state


def _cycle_feedback(fundamental: torch.Tensor, window_value: float, sample_rate: float):
    """Next Cycles-mode window from the detected fundamental
    (ref: Oscilloscope.cpp:299-303): cycleSamples = fs / f0 in f32, window =
    value * cycleSamples + 1 floored at 128, rounded once from float64 as
    the fused multiply-add of the jitted JAX function rounds it. Returns
    (window, cycle_samples) tensors. fs / f0 is one f32 division, as JAX
    divides (a host number over a tensor would be its reciprocal times fs
    in torch, an ulp off at times)."""
    f0 = fundamental[0]
    cycles = torch.full_like(f0, float(F32(sample_rate))) / torch.clamp(f0, min=1e-9)
    span = float(F32(window_value)) * torch.clamp(cycles, min=1.0).to(torch.float64) + 1.0
    window = torch.clamp(span.to(torch.float32), min=128.0)
    return window, cycles


class OscilloscopeProcessor:
    """Stateful oscilloscope engine over batched channel pairs on one
    device. ``process(history)`` takes a [pairs, 2, H] history (newest
    sample last) and returns an :class:`OscilloscopeFrame`."""

    def __init__(
        self,
        constant: OscilloscopeConstant,
        *,
        pairs: int = 1,
        window_samples: float = 1024.0,  # effectiveWindowSize
        time_mode: TimeMode = None,
        window_value: Optional[float] = None,
        bpm: float = 120.0,
        bpm_source=None,
    ):
        self.constant = constant
        self.pairs = pairs
        self.window_samples = float(window_samples)
        # live time modes (ref: Oscilloscope.cpp:293-308): Beats derives the
        # window from the playhead bpm each call; Cycles feeds the detected
        # cycleSamples of the previous spectral analysis back in
        self.time_mode = TimeMode.TIME if time_mode is None else TimeMode(time_mode)
        self.window_value = None if window_value is None else float(window_value)
        self.bpm = float(bpm)
        self.bpm_source = bpm_source  # callable returning the live bpm
        self._last_cycle_samples = 0.0
        self._cycle_window = None  # f32 window from the last Cycles feedback
        self._pair_keys = make_pair_key_colours(constant, pairs)
        self._state = init_oscilloscope_state(constant, pairs)

    @classmethod
    def create(
        cls,
        *,
        pairs: int = 1,
        device=None,
        window_samples: float = 1024.0,
        time_mode: TimeMode = None,
        window_value: Optional[float] = None,
        bpm: float = 120.0,
        bpm_source=None,
        **constant_kwargs,
    ) -> "OscilloscopeProcessor":
        """Build the constant on ``device`` (``None``: the GPU, raising
        when none is available) and a processor for ``pairs`` channel pairs;
        ``constant_kwargs`` are :func:`make_oscilloscope_constant`'s."""
        constant = make_oscilloscope_constant(device=device, **constant_kwargs)
        return cls(
            constant, pairs=pairs, window_samples=window_samples, time_mode=time_mode,
            window_value=window_value, bpm=bpm, bpm_source=bpm_source,
        )

    @property
    def device(self) -> torch.device:
        return self.constant.device

    @property
    def sample_rate(self) -> float:
        return self.constant.sample_rate

    @property
    def pixels(self) -> int:
        return self.constant.pixels

    @property
    def channel_mode(self) -> OscChannels:
        return self.constant.channel_mode

    @property
    def trigger_mode(self) -> TriggerMode:
        return self.constant.trigger_mode

    @property
    def rows(self) -> int:
        return self.constant.rows

    @property
    def state(self) -> OscilloscopeState:
        return self._state

    @state.setter
    def state(self, state: OscilloscopeState) -> None:
        self._state = state

    def reset(self) -> None:
        self._state = init_oscilloscope_state(self.constant, self.pairs)

    def reconfigure(self, constant: OscilloscopeConstant) -> None:
        """Swap configuration; resets state when the rows or the device
        change (ref: handleFlagUpdates' deferred resets, Oscilloscope.cpp:236-308)."""
        old = self.constant
        self.constant = constant
        self._pair_keys = make_pair_key_colours(constant, self.pairs)
        if constant.rows != old.rows or constant.device != old.device:
            self.reset()

    def _history(self, history) -> torch.Tensor:
        if isinstance(history, np.ndarray):
            history = torch.from_numpy(np.ascontiguousarray(history, dtype=np.float32))
        return torch.as_tensor(history, dtype=torch.float32).to(self.device).contiguous()

    def process(
        self,
        history,
        transport_position: float = 0.0,
        new_samples: Optional[int] = None,
    ) -> OscilloscopeFrame:
        """Analyze one history snapshot [pairs, 2, H] (numpy or tensor).

        ``new_samples``: how many trailing samples arrived since the last
        call — drives the autogain envelope and the envelope-hold trigger.
        Defaults to the full history.
        """
        history = self._history(history)
        h = history.shape[-1]
        if new_samples is None:
            new_samples = h
        window, chunk, env_os, cycles_live = self._prep_step(h, new_samples)
        frame, self._state = osc_step(
            self.constant, self._state, history, window,
            float(transport_position), float(int(new_samples)), self._pair_keys,
            trigger_chunk=chunk, env_os=env_os,
        )
        if cycles_live:
            self._post_cycle_feedback(frame)
        return frame

    def _prep_step(self, h: int, new_samples: int):
        """Host-side choices of the step, as the JAX ``_prep_step`` makes
        them: the f32 window, the ENVELOPE_HOLD ``trigger_chunk`` bucket and
        the ``env_os`` pow2 bucket (both choose the work and so shape the
        outputs)."""
        cycles_live = (
            self.time_mode == TimeMode.CYCLES
            and self.constant.trigger_mode == TriggerMode.SPECTRAL
        )
        px = max(self.constant.pixels - 1, 1)
        if cycles_live and self._cycle_window is not None:
            window = self._cycle_window
            # the JAX processor keeps this window on its device and so
            # keeps the conservative envelope oversampling bound
            env_os = None
        else:
            window = (
                self.window_samples
                if self.time_mode == TimeMode.TIME
                else self.effective_window_samples()
            )
            # pow2 bucket of the actual per-pixel step, never above the
            # conservative fence-post bound ceil((h-1)/(pixels-1))
            step_bound = max(1.0, (min(float(window), h) - 1.0) / px)
            bucket = 1 << (int(np.ceil(step_bound)) - 1).bit_length()
            env_os = min(bucket, max(1, -(-(h - 1) // px)))
        if self.constant.trigger_mode == TriggerMode.ENVELOPE_HOLD:
            # pow2-bucketed trigger scan over the new tail only
            la = min(self.constant.lookahead, h)
            n = max(1, min(int(new_samples), la))
            chunk = min(1 << (n - 1).bit_length(), la)
        else:
            chunk = None
        return float(F32(window)), chunk, env_os, cycles_live

    def _post_cycle_feedback(self, frame: OscilloscopeFrame) -> None:
        """Feed the detected fundamental back into the next window
        (ref: triggerState.cycleSamples -> effectiveWindowSize,
        Oscilloscope.cpp:299-303): one readback per call."""
        v = self.window_value if self.window_value is not None else self.window_samples
        window, cycles = _cycle_feedback(frame.fundamental, v, self.constant.sample_rate)
        self._cycle_window, self._last_cycle_samples = torch.stack([window, cycles]).tolist()

    def effective_window_samples(self) -> float:
        """The window displayed this frame, per time mode
        (ref: Oscilloscope.cpp:293-308); Cycles mode uses the cycle length
        read back after the last call."""
        if self.time_mode == TimeMode.TIME:
            return self.window_samples
        v = self.window_value if self.window_value is not None else self.window_samples
        if self.time_mode == TimeMode.CYCLES:
            return max(128.0, v * max(self._last_cycle_samples, 1.0) + 1.0)
        bpm = self.bpm_source() if self.bpm_source is not None else self.bpm
        return max(128.0, self.constant.sample_rate * 60.0 / (max(10.0, bpm) * max(v, 1e-9)))
