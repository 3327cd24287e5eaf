"""AnalysisSession — the per-tick analysis loop over all views.

Library equivalent of the reference's editor-driven render loop
(ref: MainEditor's vsync/timer tick driving each view's onGraphicsRendering
→ the views pull the presentation stream and recompute their display
state; MainEditor.cpp tab/view ownership, CView::setApproximateRefreshRate).
One session owns an engine's view processors, keeps them in sync with the
parameter contents (the handleFlagUpdates analogue), and produces one
render-ready :class:`SessionFrame` per ``tick()``.

Typical embedding::

    eng = SignalizerEngine("my-daw-track")
    session = AnalysisSession(eng)
    while running:
        session.feed(next_audio_block, playhead)   # audio thread cadence
        frame = session.tick()                     # UI cadence (e.g. 60 Hz)
        draw(frame.line_graph, frame.oscilloscope, ...)

Every view step is wrapped in :func:`protected_call` — a fault in one
view logs and yields ``None`` for that field instead of killing the host
(ref: Protected.h-wrapped render callbacks).

The port's counterpart of :mod:`signalizer_tpu.session`, on the engine's
device. What differs from the JAX session:

* every contained fault is counted in ``engine.diagnostics``: a failed view
  as ``session.failures`` (and ``session.failure.<view>``), a device-history
  sync or fused tick that failed and fell back for the tick as
  ``session.fallbacks`` (and ``session.fallback.<what>``); fused ticks as
  ``session.fused_ticks``, ticks as ``session.ticks``;
* the tracker's Transform source runs kernel A (``window_fft_mag``; for
  PHASE the magnitudes of its complex half spectra), in the modes the JAX
  helper takes (COMPLEX fails there and here);
* the RSNT branch passes exactly the pending chunks (no power-of-two bucket
  and mask: nothing compiles per shape);
* the spectrum comes back to the host once a tick; the oscilloscope and
  vectorscope frames stay tensors on the device.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from signalizer_tpu_torch.engine import SignalizerEngine
from signalizer_tpu_torch.stream.audio_stream import Playhead
from signalizer_tpu_torch.utils.diagnostics import span
from signalizer_tpu_torch.utils.exception_log import protected_call

# the protected calls' fallback: a failure, told apart from a None result
_FAILED = object()


def _pad_stereo(hist: np.ndarray) -> np.ndarray:
    """Zero-pad a mono presentation history to 2 rows (the mono
    surrogate the engine and _SgFeed apply; the RSNT/tracker paths
    crashed on 1-channel streams without it)."""
    if hist.shape[0] >= 2:
        return hist
    pad = np.zeros((2 - hist.shape[0], hist.shape[1]), np.float32)
    return np.concatenate([hist, pad], axis=0)


def _tracker_mags(constant, frames):
    """``|half spectrum|`` of the packed, windowed frames [..., C, W]:
    kernel A's function (:func:`~signalizer_tpu_torch.kernels.window_fft_mag.window_fft_mag`),
    for PHASE the magnitudes of its complex half spectra. COMPLEX has no
    real half spectrum and raises, as the JAX helper does."""
    from signalizer_tpu_torch.core.config import SpectrumChannels
    from signalizer_tpu_torch.kernels.window_fft_mag import window_fft_mag

    if constant.configuration == SpectrumChannels.COMPLEX:
        raise ValueError("the Transform tracker takes no COMPLEX spectrum (only real valued inputs)")
    mags = window_fft_mag(constant, frames)
    return mags.abs() if mags.is_complex() else mags

ALL_VIEWS = ("spectrum", "oscilloscope", "vectorscope", "spectrogram")


class SessionFrame(NamedTuple):
    """One render tick's outputs (fields None for inactive/failed views)."""

    spectrum: Optional[np.ndarray]  # [K, rows, P] display values
    line_graph: Optional[object]  # LineGraphFrame (vertex feed)
    oscilloscope: Optional[object]  # OscilloscopeFrame
    vectorscope: Optional[object]  # VectorscopeFrame
    spectrogram_columns: Optional[np.ndarray]  # [T, P, 4] new RGBA8 columns
    tracker: Optional[dict]  # cursor frequency readout (when enabled)
    diagnostics: dict


class AnalysisSession:
    """Owns the per-view processors of one engine and ticks them."""

    def __init__(
        self,
        engine: SignalizerEngine,
        *,
        views: Sequence[str] = ALL_VIEWS,
        axis_points: int = 1024,
        pixels: int = 1024,
        frame_rate: Optional[float] = None,
        build_line_graph: bool = True,
        cursor_fraction: Optional[float] = None,
        device_history: object = "auto",
        fused_tick: bool = True,
    ):
        self.engine = engine
        self.views = tuple(views)
        # device-resident presentation history: per tick only the NEW
        # samples cross the host->device link, and every view reads its
        # window as a static slice of the shared ring (the reference reads
        # history in place per render frame, SpectrumRendering.cpp:620-635;
        # host-path fallback kept for RSNT's continuous consumption and as
        # the device_history=False escape hatch)
        self._device_history = None
        # "auto" resolves per reconfigure() against the RESOLVED processors
        # (an RSNT spectrum consumes the continuous stream, never the ring —
        # keeping the ring alive for it would sync a dispatch per tick that
        # nothing reads); True forces the ring on, False off
        self._device_history_opt = device_history
        self.axis_points = axis_points
        self.pixels = pixels
        if frame_rate is None:
            # follow the engine's editor refresh setting (ref: the UI pump
            # timer cadence, MainEditor.cpp:393-400)
            frame_rate = 1000.0 / max(engine.editor_settings.refresh_rate_ms, 1.0)
        self.frame_rate = frame_rate
        self.build_line_graph = build_line_graph
        self.cursor_fraction = cursor_fraction
        self._last_clock = 0
        self._processors: dict = {}
        self._feeds: dict = {}
        self._sg_listener = None
        self.freeze = False  # ref: MainEditor kfreeze (hold the display)
        self._frozen_frame: Optional[SessionFrame] = None
        # one-dispatch all-views step when spectrum+oscilloscope+vectorscope
        # are all active over the device ring (views/fused_tick.py); False
        # forces the per-view path (the parity test's reference arm)
        self.fused_tick = bool(fused_tick)
        # resonator-path stream cursor + last readout (the RSNT processor
        # consumes a continuous stream, not re-read windows)
        self._res_consumed = 0
        self._res_spectrum: Optional[np.ndarray] = None
        # the contained-fault counters start at zero, so that a reader sees
        # them whether or not anything failed
        for name in ("ticks", "fused_ticks", "fallbacks", "failures"):
            engine.diagnostics.bump(f"session.{name}", 0.0)
        self.reconfigure()

    def _protected(self, fn, context: str, *, fallback: bool = False):
        """:func:`protected_call` that counts: a contained failure bumps
        ``session.failures`` and ``session.failure.<context>`` (with
        ``fallback``, where the tick goes on by another path:
        ``session.fallbacks`` and ``session.fallback.<context>``) in the
        engine's diagnostics, and gives None."""
        out = protected_call(fn, fallback=_FAILED, context=context)
        if out is _FAILED:
            kind = "fallback" if fallback else "failure"
            self.engine.diagnostics.bump(f"session.{kind}s")
            self.engine.diagnostics.bump(f"session.{kind}.{context}")
            return None
        return out

    # --- flag updates (ref: handleFlagUpdates rebuilds) ---------------------
    def reconfigure(self, only: Optional[str] = None) -> None:
        """(Re)build processors from the current parameter contents. Call
        after knob changes that alter shapes/modes (the engine's analogue
        of the reference's deferred flag handling)."""
        eng = self.engine
        if "spectrum" in self.views and only in (None, "spectrum"):
            proc = eng.make_spectrum_processor(
                axis_points=self.axis_points, frames_per_second=self.frame_rate
            )
            self._processors["spectrum"] = proc
            self._res_spectrum = None  # stale shape after an algo/axis change
            self._build_spectrum_feeds(proc)
        if "oscilloscope" in self.views and only in (None, "oscilloscope"):
            self._processors["oscilloscope"] = eng.make_oscilloscope_processor(
                pixels=self.pixels
            )
        if "vectorscope" in self.views and only in (None, "vectorscope"):
            self._processors["vectorscope"] = eng.make_vectorscope_processor()
        if "spectrogram" in self.views and only in (None, "spectrogram"):
            self._processors["spectrogram"] = eng.make_spectrogram_processor(
                axis_points=min(self.axis_points, 512)
            )
            # the spectrogram hopper consumes the *presentation* stream —
            # the same mixed/aligned audio every other view reads — so
            # sidechained sources appear in it too (ref: the spectrum's
            # audioEntryPoint listens on the presentation stream,
            # SpectrumDSP.cpp:210)
            if self._sg_listener is not None:
                eng.presentation_output.remove_listener(self._sg_listener)
            session = self

            class _SgFeed:
                def on_stream_audio(self, ctx, block):
                    sg = session._processors.get("spectrogram")
                    if sg is None:
                        return
                    b = np.asarray(block, np.float32)
                    if b.shape[0] < 2:  # mono surrogate like the engine
                        b = np.concatenate(
                            [b, np.zeros((2 - b.shape[0], b.shape[1]), np.float32)]
                        )
                    sg.push(b[:2])

                def on_stream_properties_changed(self, ctx, before):
                    pass

                def on_stream_died(self, ctx):
                    pass

            self._sg_listener = _SgFeed()
            eng.presentation_output.add_listener(self._sg_listener)
        self._update_device_history()

    def _ring_consumers_active(self) -> bool:
        """Does any resolved processor actually read the shared device ring?
        (oscilloscope/vectorscope always; spectrum unless the Algorithm knob
        resolved to the resonator, whose tick path consumes the continuous
        stream instead — see tick()'s RSNT branch.)"""
        if any(v in self.views for v in ("oscilloscope", "vectorscope")):
            return True
        if "spectrum" in self.views:
            from signalizer_tpu_torch.views.spectrum import ResonatorSpectrumProcessor

            proc = self._processors.get("spectrum")
            if not isinstance(proc, ResonatorSpectrumProcessor):
                return True
            # the cursor tracker reads the ring even under RSNT display
            return self._feeds.get("tracker") is not None
        return False

    def _update_device_history(self) -> None:
        opt = self._device_history_opt
        want = self._ring_consumers_active() if opt == "auto" else bool(opt)
        if want and self._device_history is None:
            from signalizer_tpu_torch.stream.device_history import (
                DevicePresentationHistory,
            )

            self._device_history = DevicePresentationHistory(
                self.engine.presentation_output, device=self.engine.device
            )
        elif not want and self._device_history is not None:
            self._device_history.close()
            self._device_history = None

    def refresh_feeds(self) -> None:
        """Rebuild render feeds/trackers from the current contents WITHOUT
        touching any processor — no DSP state loss. The editor's light
        path for feed-tier knob edits (line colours, tracker source,
        legend toggles); the reference likewise re-reads these per frame
        rather than through handleFlagUpdates."""
        self._build_spectrum_feeds(self._processors.get("spectrum"))

    def _build_spectrum_feeds(self, proc) -> None:
        """Shared feed/tracker wiring for reconfigure() and
        refresh_feeds() — one place, so the rebuild path and the light
        feed path cannot diverge."""
        eng = self.engine
        if self.build_line_graph and proc is not None and hasattr(proc, "constant"):
            self._feeds["line_graph"] = eng.spectrum.make_render_feed(proc.constant)
            # tracker is None when FTracker = none
            self._feeds["tracker"] = (
                eng.spectrum.make_tracker(
                    eng.config.sample_rate, frame_rate=self.frame_rate
                )
                if self.cursor_fraction is not None
                else None
            )

    def processor(self, view: str):
        """The live processor behind a view ("spectrum", "oscilloscope",
        "vectorscope", "spectrogram"), or None when inactive — the public
        accessor for embedders (e.g. the spectrogram's scrolled image)."""
        return self._processors.get(view)

    def _vs_window(self) -> int:
        """Vectorscope display window, quantized to a pow2 x quarter-step
        ladder, as the JAX session quantizes it (there the frame length is
        a jit compile key; <= 12.5% window error is invisible on a
        lissajous trail). Shared by the per-view path and the fused tick."""
        win = int(round(self.engine.vectorscope.window_size.get_transformed()))
        win = max(win, 64)
        qstep = max(1, (1 << (win.bit_length() - 1)) // 4)
        win = -(-win // qstep) * qstep
        # the ladder rounds UP: at the knob's top the quantized window can
        # exceed the history capacity (49152 > 48000) and the view died
        # every tick (pre-existing; exposed by the fused-parity tests)
        cap = int(self.engine.presentation_output.info.audio_history_capacity)
        return min(win, cap) if cap > 0 else win

    def _vs_meter_window(self, new_samples: int, vs_w: int) -> int:
        """pow2 bucket of the tick's new samples, clamped to the display
        window — the trailing slice the vectorscope meters integrate
        (each sample exactly once). Shared by the per-view path and the
        fused tick so both stay bit-equal."""
        n = max(int(new_samples), 1)
        return min(1 << (n - 1).bit_length(), vs_w)

    # --- audio cadence ------------------------------------------------------
    def feed(self, block: np.ndarray, playhead: Optional[Playhead] = None) -> None:
        """Real-time audio entry: engine ingest (the spectrogram hopper is
        fed by its presentation-stream listener)."""
        self.engine.process_block(block, playhead)

    # --- UI cadence -----------------------------------------------------------
    def tick(self) -> SessionFrame:
        """One render tick: run every active view on the freshest history.

        While :attr:`freeze` is set the last frame is returned unchanged
        and the history cursor does not advance — the editor's freeze mode
        (ref: MainEditor kfreeze; a frozen view holds its display and
        resumes from live audio when unfrozen). A live tick records its
        latency, from its start to its read-back data on the host, in the
        engine's diagnostics (the HUD's ``p50_ms`` and ``p99_ms``)."""
        with span("session.tick"):
            return self._tick(time.perf_counter())

    def _tick(self, t_start: float) -> SessionFrame:
        eng = self.engine
        if self.freeze and self._frozen_frame is not None:
            # hold the display, but do NOT re-deliver the incremental
            # spectrogram delta — an embedder appending
            # ``spectrogram_columns`` each tick would duplicate columns
            f = self._frozen_frame
            if f.spectrogram_columns is not None and len(f.spectrogram_columns):
                f = f._replace(
                    spectrogram_columns=f.spectrogram_columns[:0]
                )
                self._frozen_frame = f
            return f
        clock = eng.presentation_output.sample_clock
        new_samples = max(0, clock - self._last_clock)
        self._last_clock = clock
        eng.diagnostics.tick_frame()
        eng.diagnostics.bump("session.ticks")

        spectrum = line_graph = osc = vs = cols = tracker = None
        dh = self._device_history
        # sync lazily before the first audio, but ALWAYS once the ring holds
        # data: a stream reset (clock back to 0, ring rebuilt) must re-prime
        # the mirror rather than leave views reading the pre-reset window
        if dh is not None and (clock > 0 or dh._ring is not None):
            # one upload of the new samples per tick, shared by every view
            # below; a failure falls back to host-path reads for this tick
            if self._protected(dh.sync, "device-history", fallback=True) is None:
                dh = None

        # WINDOW-mode oscilloscope sync rides the transport (playhead
        # position), not the free-running stream clock
        transport = float(eng._playhead.position_samples)

        if self.fused_tick and dh is not None and clock > 0:
            # spectrum+oscilloscope+vectorscope back to back off the shared
            # ring with one readback; None (ineligible, or a failure, then
            # counted) falls back to the per-view steps below for this tick
            from signalizer_tpu_torch.views.fused_tick import run_fused_tick

            fused = self._protected(
                lambda: run_fused_tick(self, dh, new_samples, transport),
                "fused-tick", fallback=True,
            )
            if fused is not None:
                spectrum, osc, vs = fused
                eng.diagnostics.bump("session.fused_ticks")

        proc = self._processors.get("spectrum")
        if proc is not None and clock > 0:
            def run_spectrum():
                from signalizer_tpu_torch.views.spectrum import ResonatorSpectrumProcessor

                if isinstance(proc, ResonatorSpectrumProcessor):
                    # RSNT consumes a *continuous* stream (each sample
                    # exactly once — re-reading history would double-drive
                    # the stateful bank). One tick = one call over every
                    # pending fixed-size chunk (exactly those: nothing
                    # compiles per shape, so no bucket padding); a sub-chunk
                    # remainder waits for the next tick.
                    chunk = 1024
                    cap = eng.presentation_output.info.audio_history_capacity
                    pending = clock - self._res_consumed
                    if pending > cap:  # overrun: the ring already lost it
                        self._res_consumed = clock - cap
                        pending = cap
                    n_chunks = pending // chunk
                    if n_chunks > 0:
                        hist = _pad_stereo(eng.get_presentation_history(pending))
                        blocks = hist[:2, : n_chunks * chunk].reshape(1, 2, n_chunks, chunk)
                        out = proc.process_chunks(blocks)
                        self._res_consumed += n_chunks * chunk
                        self._res_spectrum = out[0, -1].cpu().numpy()
                    return self._res_spectrum  # [K, rows, P] (None pre-audio)
                w = proc.constant.window_size
                if dh is not None:
                    frames = dh.window(w, lead=2, pad_to=2)
                else:
                    frames = _pad_stereo(eng.get_presentation_history(w))[None, None]
                return proc.process(frames)[0, -1].cpu().numpy()  # [K, rows, P]

            if spectrum is None:
                spectrum = self._protected(run_spectrum, "spectrum")
            feed = self._feeds.get("line_graph")
            if spectrum is not None and feed is not None:
                line_graph = self._protected(lambda: feed.build(spectrum[None]), "line-graph")
            trk = self._feeds.get("tracker")
            if spectrum is not None and trk is not None:
                def run_tracker():
                    from signalizer_tpu_torch.core.constant import host_view

                    if trk.source.startswith("graph"):
                        # FTracker = Main/Aux graph: peak-search the
                        # selected graph's display row
                        k = min(int(trk.source[5:]), spectrum.shape[0] - 1)
                        return trk.update_display(
                            spectrum[k, 0],
                            host_view(proc.constant, "mapped_frequencies"),
                            self.cursor_fraction,
                            low_dbs=host_view(proc.constant, "low_dbs"),
                            high_dbs=host_view(proc.constant, "high_dbs"),
                        )
                    # FTracker = Transform: raw FFT bins of the newest
                    # window, kernel A on a GPU, read back once
                    w = proc.constant.window_size
                    if dh is not None:
                        frames = dh.window(w, lead=1, pad_to=2).contiguous()
                    else:
                        frames = torch.from_numpy(
                            np.ascontiguousarray(_pad_stereo(eng.get_presentation_history(w))[None])
                        ).to(proc.device)
                    mags = _tracker_mags(proc.constant, frames)[0, 0].cpu().numpy()
                    return trk.update(
                        mags,
                        self.cursor_fraction,
                        inv_size=float(host_view(proc.constant, "inv_size")),
                    )

                tracker = self._protected(run_tracker, "tracker")

        oproc = self._processors.get("oscilloscope")
        if oproc is not None and clock > 0 and osc is None:

            def run_osc():
                # history must cover the live window (plus trigger search
                # slack), bucketed to powers of two as the JAX session does.
                # The window is the one of the last call (Cycles mode reads
                # its feedback back once a call, in the processor)
                win = float(oproc.effective_window_samples())
                cap = eng.presentation_output.info.audio_history_capacity
                need = max(16384, 1 << int(np.ceil(np.log2(max(2.0 * win, 1.0)))))
                n = min(need, cap)
                history = (
                    dh.window(n, lead=1)
                    if dh is not None
                    else eng.get_presentation_history(n)[None]
                )
                return oproc.process(
                    history,
                    transport_position=transport,
                    new_samples=min(new_samples, n),
                )

            osc = self._protected(run_osc, "oscilloscope")

        vproc = self._processors.get("vectorscope")
        if vproc is not None and clock > 0 and vs is None:
            win = self._vs_window()

            def run_vs():
                if dh is not None and win <= dh.history:
                    # meters consume each sample once (audio-callback
                    # cadence): integrate only the new-samples bucket —
                    # same slice the fused tick takes (parity)
                    mw = self._vs_meter_window(new_samples, win)
                    return vproc.process(
                        dh.window(win, lead=1),
                        new_samples=new_samples,
                        meter_frames=dh.window(mw, lead=1),
                    )
                return vproc.process(
                    eng.get_presentation_history(win)[None],
                    new_samples=new_samples,
                )

            vs = self._protected(run_vs, "vectorscope")

        sg = self._processors.get("spectrogram")
        if sg is not None:
            cols = self._protected(lambda: sg.pull(), "spectrogram")

        eng.diagnostics.record_latency(time.perf_counter() - t_start)
        frame = SessionFrame(
            spectrum=spectrum,
            line_graph=line_graph,
            oscilloscope=osc,
            vectorscope=vs,
            spectrogram_columns=cols,
            tracker=tracker,
            diagnostics=eng.diagnostics.snapshot(),
        )
        self._frozen_frame = frame
        return frame

    def close(self) -> None:
        if self._sg_listener is not None:
            self.engine.presentation_output.remove_listener(self._sg_listener)
            self._sg_listener = None
        if self._device_history is not None:
            self._device_history.close()
            self._device_history = None
        self.engine.close()
