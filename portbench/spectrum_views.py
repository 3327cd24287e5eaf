"""Sessions of the Spectrum family: what a cell of a Spectrum configuration
calls in its window, what it reads back, and how its outputs are judged.

A session owns the seeded audio on the device, the program's processor
(or, for the control and the fault tests, a stand-in with the same face),
and the plain arithmetic of each stage's least work. The harness drives it
through :meth:`inputs`, :meth:`step` and :meth:`readback_source`, and after
the window calls :meth:`check` with the outputs it kept.

* :class:`SpectrumBatch`: ``SpectrumProcessor.process`` on
  ``[pairs, T, 2, W]`` frames cut as a strided view from resident audio
  (the program makes them contiguous itself); the newest display row of
  each pair is read back.
* :class:`SpectrogramRedraw`: ``spectrogram_ring_step`` appends new hops to
  the device ring and redraws the newest T columns; the image is read back.

The reference (:mod:`portbench.reference`) follows the carried decay state
from zero over the ``horizon_frames`` frames before each checked call: the
state forgets by ``pole ** frames`` (about 1e-17 for the slowest line graph
after 1024 frames), so that replay gives the state the program carried to
far below float32 rounding. Calls within the horizon of the first are
replayed from the first call itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.generator import stereo_stream
from portbench.reference.plan import design
from portbench.reference.spectrum import SpectrumReference, colour_columns, db_map

F32 = 4  # bytes a float32 value


def constant_kwargs(view: dict) -> dict:
    """The program's constant keywords for a configuration's ``view``."""
    from signalizer_tpu_torch.core.config import (
        BinInterpolation,
        DisplayMode,
        SpectrumChannels,
        ViewScaling,
    )
    from signalizer_tpu_torch.core.windows import WindowType

    return dict(
        axis_points=int(view["axis_points"]),
        window_size=int(view["window_size"]),
        sample_rate=float(view["sample_rate"]),
        configuration=SpectrumChannels[view["channels"]],
        bin_interpolation=BinInterpolation[view["interpolation"]],
        view_scaling=ViewScaling[view["axis"]],
        display_mode=DisplayMode[view.get("display_mode", "LINE_GRAPH")],
        window_type=WindowType[view.get("window", "HANN")],
        decay_seconds=tuple(view.get("decay_seconds", (0.1, 1.0))),
        frames_per_second=float(view.get("frames_per_second", 60.0)),
        num_line_graphs=int(view.get("line_graphs", 2)),
        low_dbs=float(view.get("low_dbs", -96.0)),
        high_dbs=float(view.get("high_dbs", 0.0)),
    )


# ---------------------------------------------------------------------------
# least work of each stage, from shapes alone
# ---------------------------------------------------------------------------


def channels_read(view: dict) -> int:
    """Audio channels the view's packing reads (LEFT and RIGHT one)."""
    return 1 if view["channels"] in ("LEFT", "RIGHT") else 2


def rows_of(view: dict) -> int:
    return 1 if view["channels"] in ("LEFT", "RIGHT", "MERGE", "SIDE") else 2


def transform_size(view: dict) -> int:
    w = int(view["window_size"])
    return max(32, 1 << (w - 1).bit_length())


def taps_of(view: dict) -> int:
    return {"NONE": 1, "LINEAR": 2, "LANCZOS": 10}[view["interpolation"]]


def window_fft_mag_work(view: dict, frames: int) -> dict:
    """Kernel A's least work for ``frames`` frames: each frame's channels
    read once with the window and the twiddle table, each row's magnitudes
    written once; a packed real row is an N/2-point complex transform (5 L
    log2 L operations), a split of ten a bin and the window's two a
    sample."""
    w, n, rows = int(view["window_size"]), transform_size(view), rows_of(view)
    bins = n // 2 + 1
    length = n // 2
    flops = frames * rows * (5.0 * length * math.log2(length) + 10.0 * bins + 2.0 * w)
    moved = F32 * (frames * channels_read(view) * w + w + 2 * n + frames * rows * bins)
    return {"bytes": float(moved), "flops": flops}


def display_map_work(view: dict, pairs: int, frames: int) -> dict:
    """Kernel B's least work: the magnitudes, the plan tables (taps'
    indices and weights, two masks, the single bin, each chunk's start and
    length, the slope) and the state read once, the display values and the
    state written once; ~30 operations a display value (decay, the dB map
    with its log) and two a magnitude."""
    p, k, rows = int(view["axis_points"]), int(view.get("line_graphs", 2)), rows_of(view)
    bins = transform_size(view) // 2 + 1
    mags = frames * rows * bins
    out = frames * k * rows * p
    tables = p * (8 * taps_of(view) + 2 + 4 * 4)
    state = pairs * k * rows * p * F32
    return {"bytes": float(F32 * (mags + out) + tables + 2 * state), "flops": 30.0 * out + 2.0 * mags}


# ---------------------------------------------------------------------------
# judging
# ---------------------------------------------------------------------------


def widest_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in float64; a NaN on either side counts as inf."""
    gap = (got.double() - want.double()).abs()
    return float(torch.where(torch.isnan(gap), math.inf, gap).max()) if gap.numel() else 0.0


class _Session:
    """What the two sessions share: the view's design and the reference's
    replay."""

    def __init__(self, cfg: dict, traffic: dict, device, frames_per_call_of_pair: int):
        self.view = cfg["view"]
        self.pairs = int(cfg["pairs"])
        self.device = torch.device(device)
        self.frames_per_call_of_pair = int(frames_per_call_of_pair)
        self.window_size = int(self.view["window_size"])
        self.sample_rate = float(self.view["sample_rate"])
        self.design = design(self.view)
        self.horizon_calls = max(1, -(-int(traffic["horizon_frames"]) // self.frames_per_call_of_pair))

    def reference_at(self, k: int):
        """``(output, reference)`` of call ``k`` by the float64 reference,
        replayed from zero over the calls of the horizon that end at it."""
        ref = SpectrumReference(self.design, self.pairs, torch.float64, self.device)
        for j in range(max(0, k - self.horizon_calls + 1), k + 1):
            out = ref.process(self.frames(j))
        return out, ref


# ---------------------------------------------------------------------------
# SpectrumProcessor on resident audio
# ---------------------------------------------------------------------------


class PortSpectrum:
    """The program: ``SpectrumProcessor.process``; its state carries."""

    def __init__(self, processor):
        self.processor = processor

    def process(self, frames):
        return self.processor.process(frames)

    def state_magnitude(self) -> torch.Tensor:
        return self.processor.state.magnitude


class ReferenceSpectrum:
    """The reference in ``dtype`` in the program's place (the control)."""

    def __init__(self, view: dict, pairs: int, dtype, device):
        self.ref = SpectrumReference(design(view), pairs, dtype, device)

    def process(self, frames):
        return self.ref.process(frames.contiguous()).float()

    def state_magnitude(self) -> torch.Tensor:
        return self.ref.state.float()


class SpectrumBatch(_Session):
    """``pairs`` x ``frames_per_call`` frames a call at hop ``hop``, cut from
    ``spans`` consecutive spans of resident audio in turn."""

    def __init__(self, cfg: dict, traffic: dict, device, seed: int, program=None, build=None):
        super().__init__(cfg, traffic, device, traffic["frames_per_call"])
        t, hop = self.frames_per_call_of_pair, int(traffic["hop"])
        self.hop = hop
        self.spans = int(traffic["spans"])
        self.span_len = (t - 1) * hop + self.window_size
        length = (self.spans - 1) * t * hop + self.span_len
        self.audio = stereo_stream(traffic["audio"], self.pairs, length, self.sample_rate, hop, seed, self.device)
        if program == "control":
            program = ReferenceSpectrum(self.view, self.pairs, torch.bfloat16, self.device)
        self.program = program if program is not None else PortSpectrum(build(self.view, self.pairs, self.device))
        if traffic["readback"] != "newest_row":
            raise ValueError(f"SpectrumBatch reads back the newest row, not {traffic['readback']!r}")
        from signalizer_tpu_torch.stream.device_ring import extract_frames

        # each span's frames as the program's strided view of the audio, made once
        self._views = [extract_frames(self._span(j), self.window_size, hop, t, frame_axis=-3)
                       for j in range(self.spans)]

    @property
    def frames_per_call(self) -> int:
        return self.pairs * self.frames_per_call_of_pair

    def _span(self, k: int) -> torch.Tensor:
        off = (k % self.spans) * self.frames_per_call_of_pair * self.hop
        return self.audio[..., off:off + self.span_len]

    def inputs(self, k: int) -> torch.Tensor:
        return self._views[k % self.spans]

    def step(self, frames):
        return self.program.process(frames)

    def readback_source(self, out: torch.Tensor) -> torch.Tensor:
        return out[:, -1]

    def final_state(self) -> dict:
        return {"magnitude": self.program.state_magnitude().clone()}

    def frames(self, k: int) -> torch.Tensor:
        """Call ``k``'s frames [pairs, T, 2, W], cut by the reference's side."""
        return self._span(k).unfold(-1, self.window_size, self.hop).movedim(-2, -3)

    def work(self) -> dict:
        """Each stage's least work a call; ``step`` the whole call: the
        audio span read once, the display values written once, the state
        read and written once, the newest rows across the host link."""
        v, frames = self.view, self.frames_per_call
        a, b = window_fft_mag_work(v, frames), display_map_work(v, self.pairs, frames)
        k, rows, p = int(v.get("line_graphs", 2)), rows_of(v), int(v["axis_points"])
        audio = self.pairs * channels_read(v) * self.span_len * F32
        out = frames * k * rows * p * F32
        state = self.pairs * k * rows * p * F32
        step = {"bytes": float(audio + out + 2 * state), "flops": a["flops"] + b["flops"],
                "pcie_bytes": float(self.pairs * k * rows * p * F32)}
        return {"window_fft_mag": a, "display_map": b, "step": step}

    def check(self, kept: dict, host: dict, final: dict, calls: int) -> dict:
        """The numbers compared: the widest gap of any display value of a
        kept call, of the carried state (both in display units) and of a
        read-back row against the device's."""
        display = readback = 0.0
        refs = {}
        for k in sorted(kept):
            want, refs[k] = self.reference_at(k)
            display = max(display, widest_gap(kept[k], want))
            if k in host:
                readback = max(readback, widest_gap(torch.from_numpy(host[k]), kept[k][:, -1].cpu()))
        ref = refs[calls - 1] if calls - 1 in refs else self.reference_at(calls - 1)[1]
        t = ref.tables
        state = widest_gap(db_map(t, final["magnitude"].double()), db_map(t, ref.state))
        return {"display_gap": display, "state_gap": state, "readback_gap": readback}


# ---------------------------------------------------------------------------
# the spectrogram's redraw on the device ring
# ---------------------------------------------------------------------------


class PortSpectrogram:
    """The program: ``spectrogram_ring_step`` with its ring and state."""

    def __init__(self, constant, ring, colours, ratios, hop: int, n_valid: int, t_valid: int):
        from signalizer_tpu_torch.kernels.colormap import gradient_bounds
        from signalizer_tpu_torch.kernels.spectrum import init_line_graph_state
        from signalizer_tpu_torch.views.spectrogram import spectrogram_ring_step

        self._ring_step = spectrogram_ring_step
        self.constant, self.ring = constant, ring
        self.state = init_line_graph_state(constant, (ring.shape[0],))
        self.colours, self.ratios = colours, ratios
        self.bounds = gradient_bounds(ratios)
        self.hop, self.n_valid, self.t_valid = hop, n_valid, t_valid

    def step(self, new):
        cols, self.ring, self.state = self._ring_step(
            self.constant, self.ring, self.state, new, self.n_valid, self.t_valid,
            self.colours, self.ratios, hop=self.hop, bounds=self.bounds,
        )
        return cols

    def state_magnitude(self) -> torch.Tensor:
        return self.state.magnitude


class ReferenceSpectrogram:
    """The reference in ``dtype`` in the program's place (the control): a
    shift ring by ``cat``, frames by ``unfold``, the colours in ``dtype``."""

    def __init__(self, view, pairs, ring, colours, ratios, hop, n_valid, t_valid, dtype):
        self.ref = SpectrumReference(design(view), pairs, dtype, ring.device)
        self.ring, self.colours, self.ratios = ring, colours, ratios
        self.window, self.hop, self.n_valid, self.t_valid = int(view["window_size"]), hop, n_valid, t_valid

    def step(self, new):
        h = self.ring.shape[-1]
        self.ring = torch.cat([self.ring, new[..., : self.n_valid]], dim=-1)[..., self.n_valid:]
        start = h - self.window - (self.t_valid - 1) * self.hop
        frames = self.ring[..., start:].unfold(-1, self.window, self.hop).movedim(-2, -3)
        out = self.ref.process(frames)
        return colour_columns(out[:, :, 0, 0, :], self.colours, self.ratios)

    def state_magnitude(self) -> torch.Tensor:
        return self.ref.state.float()


class SpectrogramRedraw(_Session):
    """Each call appends ``append_hops`` hops of the stream to the device
    ring of ``(T - 1) * hop + W`` samples and redraws the newest T columns,
    T the configuration's ``image_width``: the whole image. The stream is
    ``stream_hops`` hops of seeded audio, read in turn."""

    def __init__(self, cfg: dict, traffic: dict, device, seed: int, program=None, build=None):
        if "frames_per_call" in traffic:
            raise ValueError("a redraw draws the configuration's image_width columns; the traffic sets none")
        super().__init__(cfg, traffic, device, cfg["image_width"])
        t = self.frames_per_call_of_pair
        self.hop = int(round(self.window_size * (1.0 - float(self.view["overlap"]))))
        self.append = int(traffic["append_hops"])
        self.stream_hops = int(traffic["stream_hops"])
        self.ring_len = (t - 1) * self.hop + self.window_size
        if self.ring_len % self.hop or self.stream_hops * self.hop <= self.ring_len or self.stream_hops % self.append:
            raise ValueError("the ring must be whole hops, shorter than the stream, which whole appends fill")
        self.stream = stereo_stream(traffic["audio"], self.pairs, self.stream_hops * self.hop, self.sample_rate,
                                    self.hop, seed, self.device)
        gradient = torch.tensor(np.asarray(cfg["gradient"], np.float32), device=self.device)
        self.ref_colours = gradient[None].expand(self.pairs, -1, -1).double()
        raw = np.asarray(cfg["ratios"], np.float64)
        self.ref_ratios = torch.tensor(raw / raw[1:].sum(), device=self.device)
        self.ref_ratios[0] = 0.0
        ring = self.stream[..., : self.ring_len].clone()
        n_valid = self.append * self.hop
        if program == "control":
            program = ReferenceSpectrogram(self.view, self.pairs, ring, self.ref_colours, self.ref_ratios,
                                           self.hop, n_valid, t, torch.bfloat16)
        if program is None:
            from signalizer_tpu_torch.kernels.colormap import normalize_ratios

            ratios = torch.from_numpy(normalize_ratios(cfg["ratios"]).astype(np.float32)).to(self.device)
            colours = gradient[None].expand(self.pairs, -1, -1).contiguous()
            program = PortSpectrogram(build(self.view, self.device), ring, colours, ratios, self.hop, n_valid, t)
        self.program = program
        if traffic["readback"] != "image":
            raise ValueError(f"SpectrogramRedraw reads back the image, not {traffic['readback']!r}")

    @property
    def frames_per_call(self) -> int:
        return self.frames_per_call_of_pair

    def _x(self, start: int, n: int) -> torch.Tensor:
        """Samples ``[start, start + n)`` of the endless stream that repeats
        the generated one."""
        period = self.stream.shape[-1]
        idx = (start + torch.arange(n, device=self.device)) % period
        return self.stream[..., idx]

    def inputs(self, k: int) -> torch.Tensor:
        n = self.append * self.hop
        start = (self.ring_len + k * n) % self.stream.shape[-1]
        return self.stream[..., start:start + n]

    def step(self, new):
        return self.program.step(new)

    def readback_source(self, out: torch.Tensor) -> torch.Tensor:
        return out

    def final_state(self) -> dict:
        return {"magnitude": self.program.state_magnitude().clone(), "ring": self.program.ring.clone()}

    def frames(self, k: int) -> torch.Tensor:
        """Call ``k``'s frames [pairs, T, 2, W]: the ring after call ``k``
        holds stream samples ``[(k + 1) * append * hop, ... + ring_len)``."""
        ring = self._x((k + 1) * self.append * self.hop, self.ring_len)
        return ring.unfold(-1, self.window_size, self.hop).movedim(-2, -3)

    def work(self) -> dict:
        """Each stage's least work a call; ``step``: the new samples written
        into the history once, the span the frames cover read once in the
        channels the view reads, the columns written once, the state read
        and written once, the image across the host link."""
        v, t = self.view, self.frames_per_call
        a, b = window_fft_mag_work(v, t), display_map_work(v, self.pairs, t)
        k, rows, p = int(v.get("line_graphs", 2)), rows_of(v), int(v["axis_points"])
        new = self.pairs * 2 * self.append * self.hop * F32
        span = self.pairs * channels_read(v) * self.ring_len * F32
        image = t * p * 4
        state = self.pairs * k * rows * p * F32
        step = {"bytes": float(new + span + image + 2 * state), "flops": a["flops"] + b["flops"],
                "pcie_bytes": float(image)}
        return {"window_fft_mag": a, "display_map": b, "step": step}

    def _columns(self, out: torch.Tensor) -> torch.Tensor:
        return colour_columns(out[:, :, 0, 0, :], self.ref_colours, self.ref_ratios)

    def check(self, kept: dict, host: dict, final: dict, calls: int) -> dict:
        """The numbers compared: the widest byte gap of a kept image and the
        share of its bytes that differ, the carried state's widest gap in
        display units, the ring's and the read-back image's widest gaps."""
        byte_gap, off, total, readback = 0.0, 0, 0, 0.0
        refs = {}
        for k in sorted(kept):
            out, refs[k] = self.reference_at(k)
            want = self._columns(out)
            got = kept[k]
            byte_gap = max(byte_gap, widest_gap(got, want))
            off += int((got != want).sum())
            total += got.numel()
            if k in host:
                readback = max(readback, widest_gap(torch.from_numpy(host[k]), got.cpu()))
        ref = refs[calls - 1] if calls - 1 in refs else self.reference_at(calls - 1)[1]
        t = ref.tables
        state = widest_gap(db_map(t, final["magnitude"].double()), db_map(t, ref.state))
        ring = widest_gap(final["ring"], self._x(calls * self.append * self.hop, self.ring_len))
        return {"byte_gap": byte_gap, "bytes_off": off / max(total, 1), "state_gap": state,
                "ring_gap": ring, "readback_gap": readback}
