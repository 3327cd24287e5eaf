"""SpectrogramProcessor — streaming colour-spectrum pipeline.

Counterpart of :mod:`signalizer_tpu.views.spectrogram`: the reference's
ColourSpectrum display mode (ref: Source/Spectrum/TransformDSP.inl:1163-1211
blobSize chunker + SpectrumDSP.cpp:110-206 colour blending +
SpectrumRendering.cpp:671-749 column texture updates). A host-side hopper
batches blob frames, the device runs window->FFT->remap->decay->dB->gradient
for ALL pending frames of a unit (the FFT and the display tail each one
kernel launch on a GPU), and a host-side scrolling image receives RGBA8
columns.

The JAX package pads every batch of frames to a power of two with masked
frames so that few shapes compile. Nothing compiles per shape here, so the
processor analyzes exactly the frames that are ready: a masked frame is an
identity step of the decay, so the columns and the carried state are the
same. :func:`spectrogram_step` still takes the ``valid`` mask for callers
that batch to a fixed shape.
"""

from __future__ import annotations

import colorsys
from typing import Optional

import numpy as np
import torch

from signalizer_tpu_torch.core.config import DisplayMode
from signalizer_tpu_torch.core.constant import (
    SpectrumConstant,
    make_spectrum_constant,
    resolve_device,
)
from signalizer_tpu_torch.kernels.colormap import (
    gradient_bounds,
    normalize_ratios,
    spectrogram_columns,
)
from signalizer_tpu_torch.kernels.spectrum import (
    LineGraphState,
    analyze_frames,
    init_line_graph_state,
)
from signalizer_tpu_torch.stream.batcher import FrameBatcher
from signalizer_tpu_torch.stream.device_ring import (
    DeviceFrameSource,
    extract_frames,
    ring_update,
)
from signalizer_tpu_torch.stream.pinned import PinnedUpload
from signalizer_tpu_torch.utils.diagnostics import span

# default 5-stop gradient + background (ref: SpectrumParameters.h
# specColours defaults; exact defaults are preset-defined, these are the
# classic dark->blue->green->yellow->red heat map)
DEFAULT_GRADIENT = np.asarray(
    [
        [0.0, 0.0, 0.0],  # background
        [0.0, 0.0, 0.5],
        [0.0, 0.5, 1.0],
        [0.0, 1.0, 0.0],
        [1.0, 1.0, 0.0],
        [1.0, 0.0, 0.0],
    ],
    np.float32,
)
DEFAULT_RATIOS = np.asarray([0.0, 0.2, 0.2, 0.2, 0.2, 0.2], np.float32)


def spectrogram_step(
    constant: SpectrumConstant,
    state: LineGraphState,
    frames: torch.Tensor,
    colours: torch.Tensor,
    ratios: torch.Tensor,
    valid=None,
    bounds: torch.Tensor = None,
):
    """frames [pairs, T, C, W] -> (columns [T, P, 4] uint8, state).

    ``valid`` [T] bool: False frames are padding (a batch of fixed shape);
    they leave the decay state untouched and the caller drops their
    columns. ``state`` is updated in place. ``bounds``: the ratios'
    :func:`~signalizer_tpu_torch.kernels.colormap.gradient_bounds`, for a
    caller that keeps them."""
    result = analyze_frames(constant, state, frames, valid=valid)
    # spectrogram uses the main line graph's decayed dB row
    # (ref: addAudioFrame uses LineMain, TransformDSP.inl:1144-1147)
    intensity = result.results[:, :, 0, 0, :]  # [pairs, T, P]
    return spectrogram_columns(intensity, colours, ratios, bounds), result.state


def spectrogram_ring_step(
    constant: SpectrumConstant,
    ring: torch.Tensor,
    state: LineGraphState,
    new: torch.Tensor,
    n_valid: int,
    t_valid: int,
    colours: torch.Tensor,
    ratios: torch.Tensor,
    *,
    hop: int,
    bounds: torch.Tensor = None,
):
    """Hop-only tick: shift the first ``n_valid`` of the NEW samples
    [pairs, 2, n] into the device-resident history ring, take the last
    ``t_valid`` overlapped analysis windows off the ring, analyze, colour:
    upload cost O(new samples) instead of O(T * window) (ref:
    prepareTransform reads windows in place from the stream ring,
    TransformDSP.inl:38-231; the host never re-copies history,
    SpectrumRendering.cpp:620-635). Returns (columns [t_valid, P, 4], ring,
    state). The windows are copied once into contiguous frames, which the
    FFT kernel's wrapper takes."""
    with span("spectrogram.step"):
        ring = ring_update(ring, new, n_valid)
        with span("ring.frames"):
            frames = extract_frames(ring, constant.window_size, hop, t_valid, frame_axis=-3).contiguous()
        cols, state = spectrogram_step(constant, state, frames, colours, ratios, bounds=bounds)
        return cols, ring, state


class SpectrogramProcessor:
    """Streaming spectrogram over batched channel pairs.

    ``push(block)`` feeds interleaved pair audio [pairs*2, n]; ``pull()``
    returns all newly completed RGBA8 columns [T, P, 4] (pairs blended) as
    a numpy array: the image is host-side, so every unit's columns are read
    back (``readbacks`` counts them). ``device=None`` is the GPU and raises
    without one; the CPU is used only for ``device="cpu"``.
    """

    def __init__(
        self,
        constant: Optional[SpectrumConstant] = None,
        *,
        pairs: int = 1,
        device=None,
        blob_ms: float = 10.0,  # ref: blobSize, 0.5-1000 ms
        overlap: float = 0.0,  # 0 = contiguous blobs, 0.5 = 50% overlap
        colours: Optional[np.ndarray] = None,
        ratios: Optional[np.ndarray] = None,
        image_width: int = 512,
        stretch: float = 1.0,  # ref: spectrumStretching
        device_ingest="auto",
        **constant_kwargs,
    ):
        if constant is None:
            constant_kwargs.setdefault("axis_points", 256)
            constant_kwargs.setdefault("window_size", 4096)
            constant_kwargs.setdefault("display_mode", DisplayMode.COLOUR_SPECTRUM)
            constant = make_spectrum_constant(device=resolve_device(device), **constant_kwargs)
        elif device is not None and torch.device(device).type != constant.device.type:
            raise ValueError(f"constant lives on {constant.device}, not on {device}")
        self.constant = constant
        self.device = constant.device
        self.pairs = pairs
        # host frames (or, ingesting on the device, new samples) go up
        # through pinned buffers: no copy from pageable memory a pull
        self._uploads = PinnedUpload(self.device)
        hop = max(1.0, blob_ms * 1e-3 * constant.sample_rate * (1.0 - overlap))
        if device_ingest == "auto":
            # hop-only ingest needs an integer hop (the shift ring's fixed
            # frame grid); sub-sample blob sizes keep the host batcher.
            # Both routes give the same columns byte for byte.
            device_ingest = float(hop).is_integer()
        self.device_ingest = bool(device_ingest)
        if self.device_ingest:
            # hop-only upload path: history lives on device; the hop is
            # quantized to integer samples (the fixed frame grid of the
            # shift ring — a deliberate deviation; sub-sample blob sizes
            # stay on the host batcher)
            self._source = DeviceFrameSource(
                (pairs, 2),
                constant.window_size,
                int(round(hop)),
                t_cap=32,
                max_pending_frames=max(64, int(constant.window_size * 4 / hop)),
            )
            self._ring = self._source.init_ring(self.device)
            self.batcher = self._source  # duck-typed: frames_ready/dropped
        else:
            self.batcher = FrameBatcher(
                pairs * 2,
                constant.window_size,
                hop,
                capacity=max(constant.window_size * 4, int(hop * 64)),
            )
        self._state = init_line_graph_state(constant, (pairs,))
        base = colours if colours is not None else DEFAULT_GRADIENT
        base = np.asarray(base, np.float32)
        # per-pair colour rotation (ref: generateSpectrogramColourRotation);
        # background stop shared, others hue-shifted per pair
        tables = np.stack([self._rotate(base, p, pairs) for p in range(pairs)])
        self._colours = torch.from_numpy(tables).to(self.device)
        self._ratios = torch.from_numpy(
            normalize_ratios(ratios if ratios is not None else DEFAULT_RATIOS).astype(np.float32)
        ).to(self.device)
        self._bounds = gradient_bounds(self._ratios)
        self.image = SpectrogramImage(image_width, constant.axis_points, stretch=stretch)
        # render pacing (FrameSmoothing knob): when set, un-capped pull()s
        # consume columns through the pacer's EMA instead of all at once
        self.pacer: Optional["ColumnPacer"] = None
        # device->host column readbacks (one synchronization each)
        self.readbacks = 0

    @staticmethod
    def _rotate(colours: np.ndarray, pair: int, pairs: int) -> np.ndarray:
        """Hue-rotate gradient stops per pair (ref: ColourRotation,
        CommonSignalizer.h:921-954 — base.withRotatedHue(index/size))."""
        if pair == 0 or pairs <= 1:
            return colours
        out = colours.copy()
        shift = pair / pairs
        for i in range(1, len(colours)):
            h, l, s = colorsys.rgb_to_hls(*colours[i])
            out[i] = colorsys.hls_to_rgb((h + shift) % 1.0, l, s)
        return out

    @property
    def state(self) -> LineGraphState:
        """The carried decay state (updated in place by ``pull``)."""
        return self._state

    @property
    def ring(self) -> Optional[torch.Tensor]:
        """The device-resident history ring [pairs, 2, H] (device ingest
        only)."""
        return self._ring if self.device_ingest else None

    def load_state(self, state: LineGraphState, ring=None) -> None:
        """Continue from a carried decay state (e.g. from
        :func:`~signalizer_tpu_torch.kernels.spectrum.line_graph_state_from_arrays`)
        and, for device ingest, a history ring given as an array."""
        self._state = LineGraphState(*(t.to(self.device) for t in state))
        if ring is not None:
            self._ring = torch.as_tensor(np.asarray(ring), dtype=torch.float32).to(self.device)

    def push(self, block: np.ndarray) -> None:
        """Feed [pairs*2, n] audio."""
        if self.device_ingest:
            block = np.asarray(block, np.float32)
            self._source.push(block.reshape(self.pairs, 2, block.shape[-1]))
        else:
            self.batcher.push(block)

    def freshness_lag(self) -> Optional[float]:
        """Stream-clock samples between "now" and the end of the newest
        frame already emitted (None before the first frame).

        Parity evidence for the reference's preliminary-audio stitch
        (TransformDSP.inl:233-484): the reference forms a spectrogram
        frame the moment its final sample arrives by stitching history
        with the in-flight block; here each pushed block is committed to
        the hopper before framing, so the same-push availability holds and
        the post-pull lag stays strictly below one hop."""
        b = self.batcher
        nf = b._next_frame
        if nf <= 0:
            return None
        if self.device_ingest:
            clock = float(b.sample_clock)
            end = float((nf - 1) * b.hop + b.window)
        else:
            clock = float(b.ring.sample_clock)
            end = float(int((nf - 1) * b.hop + 0.5) + b.window)
        return clock - end

    def _to_host(self, cols: torch.Tensor) -> np.ndarray:
        self.readbacks += 1
        return cols.cpu().numpy()

    def pull(self, max_frames: Optional[int] = None) -> np.ndarray:
        """Process pending blobs -> RGBA8 columns [T, P, 4].

        With a ``pacer`` attached (engine wiring of the FrameSmoothing
        knob) and no explicit ``max_frames``, each call is one render tick:
        the pacer's EMA decides how many pending columns to consume so the
        scroll speed doesn't jitter with audio block boundaries.
        """
        if max_frames is None and self.pacer is not None:
            max_frames = self.pacer.columns_for_tick(self.batcher.frames_ready())
        if self.device_ingest:
            return self._pull_device(max_frames)
        frames = self.batcher.pull(max_frames)
        t = frames.shape[0]
        if t == 0:
            return np.zeros((0, self.constant.axis_points, 4), np.uint8)
        # [T, pairs*2, W] -> [pairs, T, 2, W], one upload and one step per tick
        stacked = frames.reshape(t, self.pairs, 2, self.constant.window_size).transpose(1, 0, 2, 3)
        cols, self._state = spectrogram_step(
            self.constant,
            self._state,
            self._uploads.upload(stacked),
            self._colours,
            self._ratios,
            bounds=self._bounds,
        )
        cols = self._to_host(cols)
        self.image.push_columns(cols)
        return cols

    def _pull_device(self, max_frames: Optional[int]) -> np.ndarray:
        """Hop-only tick: each upload unit moves only NEW samples to the
        device; windows come off the resident ring."""
        out = []
        for unit in self._source.pull_uploads(max_frames):
            # the unit's padding beyond n_valid stays on the host
            new = self._uploads.upload(unit.samples[..., : unit.n_valid])
            cols, self._ring, self._state = spectrogram_ring_step(
                self.constant,
                self._ring,
                self._state,
                new,
                unit.n_valid,
                unit.t_valid,
                self._colours,
                self._ratios,
                hop=self._source.hop,
                bounds=self._bounds,
            )
            out.append(self._to_host(cols))
        if not out:
            return np.zeros((0, self.constant.axis_points, 4), np.uint8)
        cols = np.concatenate(out, axis=0)
        self.image.push_columns(cols)
        return cols

    def reset(self) -> None:
        self._state = init_line_graph_state(self.constant, (self.pairs,))
        if self.device_ingest:
            self._ring = self._source.init_ring(self.device)


class SpectrogramImage:
    """Host-side circularly-scrolled column image (ref: cpl COpenGLImage
    scroll + updateSingleColumn usage, SpectrumRendering.cpp:671-749).

    ``stretch`` emulates the SpectrumStretch knob (ref: Spectrum.cpp:509 —
    the GL image is resized to viewWidth / stretch, so each DSP column
    covers ``stretch`` display pixels): the backing store holds
    ``width / stretch`` columns and :meth:`snapshot` repeats each one
    ``stretch`` times back to the display width.
    """

    def __init__(self, width: int, height: int, stretch: float = 1.0):
        self.display_width = width
        self.stretch = max(1, int(round(stretch)))
        self.width = max(1, int(round(width / self.stretch)))
        self.height = height
        self._img = np.zeros((self.width, height, 4), np.uint8)
        self._img[..., 3] = 255
        self._cursor = 0

    def push_columns(self, cols: np.ndarray) -> None:
        """cols [T, height, 4]."""
        t = cols.shape[0]
        if t >= self.width:
            self._img[:] = cols[-self.width :]
            self._cursor = 0
            return
        first = min(t, self.width - self._cursor)
        self._img[self._cursor : self._cursor + first] = cols[:first]
        rest = t - first
        if rest:
            self._img[:rest] = cols[first:]
        self._cursor = (self._cursor + t) % self.width

    def push_debug_checkerboard(self, columns: int = 8) -> None:
        """Inject a checkerboard test pattern into the column upload path
        (ref: SIGNALIZER_VISUALDEBUGTEST, SpectrumRendering.cpp:705-719 —
        verifies column ordering/scroll/stretch visually)."""
        t = np.arange(columns)[:, None]
        f = np.arange(self.height)[None, :]
        checker = (((t // 2) + (f // 8)) % 2).astype(np.uint8) * 255
        cols = np.zeros((columns, self.height, 4), np.uint8)
        cols[..., 0] = checker
        cols[..., 1] = checker
        cols[..., 2] = checker
        cols[..., 3] = 255
        self.push_columns(cols)

    def snapshot(self) -> np.ndarray:
        """Time-ordered image [display_width, height, 4], oldest column
        first; each stored column repeated ``stretch`` times."""
        img = np.roll(self._img, -self._cursor, axis=0)
        if self.stretch > 1:
            img = np.repeat(img, self.stretch, axis=0)[: self.display_width]
        return img


class ColumnPacer:
    """Render-rate smoothing for spectrogram columns
    (ref: framesPerUpdate EMA in renderColourSpectrum,
    SpectrumRendering.cpp:671-749): smooths how many DSP columns each
    render tick consumes so the scroll speed doesn't jitter with audio
    block boundaries."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = float(smoothing)
        self._per_update = 0.0
        self._debt = 0.0

    def columns_for_tick(self, available: int) -> int:
        """How many of ``available`` pending columns to consume this tick."""
        self._per_update = (
            self.smoothing * self._per_update + (1.0 - self.smoothing) * available
        )
        want = self._per_update + self._debt
        take = int(want)
        take = max(0, min(take, available))
        self._debt = want - take
        # never fall behind more than one tick's worth
        if available - take > self._per_update * 2:
            take = available
            self._debt = 0.0
        return take
