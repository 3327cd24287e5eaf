"""Optional lightweight offline viewer (matplotlib).

A copy of :mod:`signalizer_tpu.views.render`, except that the port's
frames hold tensors on their device: each renderer reads its frame back to
the host once, at its entry (:func:`~signalizer_tpu_torch.utils.readback.to_host`).

The reference renders with OpenGL inside a plugin window; this framework
emits render-ready arrays (SURVEY.md §2.8 "rebuild exposes arrays +
optional lightweight viewer"). This module is that viewer: static renders
of each view's output for notebooks, debugging and golden-image tests.
matplotlib is imported lazily so the core framework has no hard
dependency on it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from signalizer_tpu_torch.utils.readback import to_host


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_spectrum(
    results: np.ndarray,
    mapped_frequencies: np.ndarray,
    *,
    low_dbs: float = -96.0,
    high_dbs: float = 0.0,
    path: Optional[str] = None,
    labels: Optional[Sequence[str]] = None,
):
    """Line-graph spectrum: results [rows, P] normalized display values."""
    plt = _plt()
    results, mapped_frequencies = to_host((results, mapped_frequencies))
    results = np.atleast_2d(np.asarray(results))
    f = np.asarray(mapped_frequencies)
    fig, ax = plt.subplots(figsize=(10, 4), dpi=100)
    for i, row in enumerate(results):
        dbs = low_dbs + np.clip(row, 0, 1) * (high_dbs - low_dbs)
        ax.plot(f, dbs, lw=0.8, label=labels[i] if labels else None)
    ax.set_xscale("log" if f[0] > 0 and f[-1] / max(f[0], 1e-3) > 50 else "linear")
    ax.set_xlabel("Hz")
    ax.set_ylabel("dB")
    ax.set_ylim(low_dbs, high_dbs)
    ax.grid(True, alpha=0.3)
    if labels:
        ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    if path:
        fig.savefig(path)
        plt.close(fig)
        return path
    return fig


def render_line_graph_frame(
    frame,
    *,
    tracker: Optional[dict] = None,
    hints: Optional[dict] = None,
    path: Optional[str] = None,
):
    """Render a :class:`signalizer_tpu_torch.views.line_graph.LineGraphFrame`
    purely from its vertex/colour arrays — the viewer-side counterpart of
    the reference's GL draw calls (SpectrumRendering.cpp:793-897). Nothing
    here reaches back into the DSP: floods are GL_LINES pairs, strips are
    GL_LINE_STRIPs, grids/legend come from the frame.

    ``tracker``: the session's frequency-tracker readout dict; drawn as
    the cursor/peak annotation in the hints' widget colour (ref: the
    tracker text overlay, SpectrumRendering.cpp:430-447).
    ``hints``: SpectrumContent.make_render_hints().
    """
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 4), dpi=100)
    ax.set_facecolor(tuple(np.clip(frame.background_colour[:3], 0, 1)))
    # grids
    gc = tuple(np.clip(frame.grid_colour[:3], 0, 1))
    for line in frame.grid:
        ax.axvline(line.position, color=gc, alpha=0.3, lw=0.5)
    for line in frame.db_grid:
        ax.axhline(line.position, color=gc, alpha=0.3, lw=0.5)
    # flood fills: GL_LINES vertex pairs (x, y_top) -> (x, y_end)
    for flood in frame.floods:
        v = flood.vertices
        x = v[0::2, 0] / max(v[-2, 0], 1.0)
        ax.fill_between(
            x, v[1::2, 1], v[0::2, 1],
            color=tuple(np.clip(flood.colour[:3], 0, 1)),
            alpha=float(flood.colour[3]),
            linewidth=0,
        )
    # line strips
    for strip in frame.strips:
        v = strip.vertices
        x = v[:, 0] / max(v[-1, 0], 1.0)
        ax.plot(
            x, v[:, 1],
            color=tuple(np.clip(strip.colour[:3], 0, 1)),
            alpha=float(strip.colour[3]),
            lw=max(frame.primitive_size, 0.3),
            label=strip.label,
        )
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_xticks([l.position for l in frame.grid])
    ax.set_xticklabels([l.label for l in frame.grid], fontsize=7)
    ax.set_yticks([l.position for l in frame.db_grid])
    ax.set_yticklabels([l.label for l in frame.db_grid], fontsize=7)
    if frame.legend is not None:
        ax.legend(loc="upper right", fontsize=7)
    if tracker is not None and tracker.get("frequency"):
        wc = (1.0, 1.0, 1.0, 1.0)
        if hints and hints.get("widget_colour") is not None:
            wc = hints["widget_colour"]
        # locate the tracked frequency on the frame's own x axis (grid
        # positions are normalized display space)
        freqs = [l.position for l in frame.grid]
        labels_hz = []
        for l in frame.grid:
            text = str(l.label).strip()
            # proper suffix parse (rstrip("kHz") strips a character SET,
            # mangling e.g. trailing "...k" digits-free text); 0 Hz is a
            # legitimate anchor on linear axes
            scale = 1.0
            if text.endswith("kHz"):
                text, scale = text[:-3], 1000.0
            elif text.endswith("Hz"):
                text = text[:-2]
            elif text.endswith("k"):
                text, scale = text[:-1], 1000.0
            try:
                labels_hz.append(float(text) * scale)
            except ValueError:
                labels_hz.append(None)
        known = [(p, h) for p, h in zip(freqs, labels_hz) if h is not None]
        if len(known) >= 2:
            import numpy as _np

            ps, hs = zip(*known)
            x = float(_np.interp(tracker["frequency"], hs, ps))
            ax.axvline(x, color=tuple(_np.clip(wc[:3], 0, 1)), lw=0.8, alpha=0.9)
            note = tracker.get("note", "")
            ax.text(
                x, 0.97,
                f" {tracker['frequency']:.1f} Hz {tracker['dbs']:.1f} dB {note}",
                color=tuple(_np.clip(wc[:3], 0, 1)),
                fontsize=7, va="top",
            )
    fig.tight_layout()
    if path:
        fig.savefig(path)
        plt.close(fig)
        return path
    return fig


def render_oscilloscope(frame, *, hints: Optional[dict] = None, path: Optional[str] = None,
                        legend=None):
    """OscilloscopeFrame -> waveform plot with min/max envelope.

    ``hints``: OscilloscopeContent.make_render_hints() — the view-shell
    knobs the reference's GL renderer consumes (colours, primitive size,
    dot sampling, channel overlay, view box). ``legend``: an optional
    :class:`signalizer_tpu_torch.utils.colour.Legend` (engine.make_legend) —
    labels rows with the propagated source channel names."""
    plt = _plt()
    h = hints or {}
    frame = to_host(frame)
    wave = np.asarray(frame.waveform)
    lo = np.asarray(frame.envelope_min)
    hi = np.asarray(frame.envelope_max)
    pairs, rows, p = wave.shape
    overlay = bool(h.get("overlay_channels", False))
    n_axes = 1 if overlay else rows
    fig, axes = plt.subplots(n_axes, 1, figsize=(10, 2.2 * n_axes), dpi=100, squeeze=False)
    x = np.arange(p, dtype=np.float64)
    # view box (ViewLeft/Top/Right/Bottom) crops the displayed region
    vl, vt, vr, vb = h.get("view_box", (0.0, 0.0, 1.0, 1.0))
    colours = np.asarray(frame.colours)
    lw = max(float(h.get("primitive_size", 0.8)), 0.3)
    marker = "." if h.get("dot_samples") else None
    bg = h.get("background_colour")
    gc = h.get("graph_colour")
    # every pair draws, with its hue-rotated colours (ref: the per-pair
    # drawWavePlot loop, OscilloscopeRendering.cpp:328-365)
    for r in range(rows):
        ax = axes[0 if overlay else r, 0]
        if bg is not None:
            ax.set_facecolor(tuple(np.clip(np.asarray(bg)[:3], 0, 1)))
        for pair in range(pairs):
            ax.fill_between(x, lo[pair, r], hi[pair, r], alpha=0.15, color="C0")
            idx = pair * rows + r
            name = (legend.entries[idx].name
                    if legend and idx < len(legend.entries)
                    else ("left", "right")[r % 2] + (f" p{pair}" if pairs > 1 else ""))
            ax.plot(
                x, wave[pair, r], lw=lw, marker=marker, markersize=lw * 2,
                color=tuple(np.clip(colours[pair, r, p // 2], 0, 1)),
                label=name if h.get("show_legend") else None,
            )
        ax.set_xlim(vl * (p - 1), vr * (p - 1))
        # vertical view box: vt crops from the top, vb from the bottom
        # (ViewTop/ViewBottom, already un-reversed by the content layer)
        ax.set_ylim(1.1 - 2.2 * max(vb, vt + 1e-3), 1.1 - 2.2 * vt)
        if gc is not None:
            ax.grid(True, alpha=0.3, color=tuple(np.clip(np.asarray(gc)[:3], 0, 1)))
        else:
            ax.grid(True, alpha=0.3)
    # the reference paints the legend in every overlay mode
    # (OscilloscopeRendering.cpp:152-155)
    if h.get("show_legend"):
        axes[0, 0].legend(loc="upper right", fontsize=7)
    fig.tight_layout()
    if path:
        fig.savefig(path)
        plt.close(fig)
        return path
    return fig


def render_vectorscope(frame, *, mode: str = "lissajous", hints: Optional[dict] = None,
                       path: Optional[str] = None, legend=None):
    """VectorscopeFrame -> point cloud + meter bars.

    ``hints``: VectorScopeContent.make_render_hints() — colours, primitive
    size, interconnect/fade toggles and the 3D transform. ``legend``: an
    optional Legend (engine.make_legend) titles the plot with the source
    names."""
    plt = _plt()
    h = hints or {}
    frame = to_host(frame)
    verts = np.asarray(frame.vertices)  # [pairs, W, 3]
    fig, ax = plt.subplots(figsize=(5.5, 5.5), dpi=100)
    bg = h.get("background_colour")
    if bg is not None:
        ax.set_facecolor(tuple(np.clip(np.asarray(bg)[:3], 0, 1)))
    size = max(float(h.get("primitive_size", 0.1)) * 10.0, 0.5)
    fade = h.get("fade_older_points", True)
    wf = h.get("waveform_colour")
    base = np.clip(np.asarray(wf)[:3], 0, 1) if wf is not None else np.asarray([0.12, 0.47, 0.71])
    # every pair draws, hue-rotated beyond the first (ref: the per-pair
    # loop + ColourRotation, VectorscopeRendering.cpp:169-180)
    from signalizer_tpu_torch.utils.colour import ColourRotation

    pair_colours = ColourRotation(base, max(verts.shape[0], 1)).as_array()
    for pair in range(verts.shape[0]):
        v = verts[pair]
        # age fade is a MODEL-space convention (z = -1 oldest .. 0
        # newest, ref fadeHistory) — read it BEFORE the view transform
        age = (v[:, 2] + 1.0).clip(0, 1) if fade else np.ones(len(v))
        if "transform" in h:
            matrix, translation = h["transform"]
            v = v @ np.asarray(matrix, v.dtype).T + np.asarray(translation, v.dtype)
        colour = np.clip(pair_colours[pair], 0, 1)
        if h.get("interconnect_samples", False):
            ax.plot(v[:, 0], v[:, 1], lw=size * 0.5, color=tuple(colour), alpha=0.7)
        else:
            # the reference draws in the waveform colour, faded toward
            # black by age (colour * fade), not through a colormap
            # (VectorscopeRendering.cpp:455-462)
            rgba = np.concatenate(
                [colour[None, :] * age[:, None], np.full((len(v), 1), 0.7)], axis=1
            )
            ax.scatter(v[:, 0], v[:, 1], s=size, c=rgba)
    ax.set_xlim(-1.1, 1.1)
    ax.set_ylim(-1.1, 1.1)
    ax.set_aspect("equal")
    axc = h.get("axis_colour")
    if axc is not None:
        ax.grid(True, alpha=0.3, color=tuple(np.clip(np.asarray(axc)[:3], 0, 1)))
    else:
        ax.grid(True, alpha=0.3)
    bal = float(np.asarray(frame.balance)[0, 0])
    corr = float(np.asarray(frame.correlation_bars)[0, 0])
    title = f"balance {bal:.2f}  correlation {corr:.2f}"
    if legend is not None and legend.entries and h.get("show_legend", True):
        names = " + ".join(e.name for e in legend.entries[:2])
        title = f"{names}\n{title}"
    ax.set_title(title, fontsize=9)
    fig.tight_layout()
    if path:
        fig.savefig(path)
        plt.close(fig)
        return path
    return fig


def render_spectrogram(image, *, path: Optional[str] = None):
    """SpectrogramImage (or [W, P, 4] array) -> image render."""
    plt = _plt()
    img = image.snapshot() if hasattr(image, "snapshot") else np.asarray(to_host(image))
    fig, ax = plt.subplots(figsize=(10, 4), dpi=100)
    # [time, freq, rgba] -> display freq on y, low at bottom
    ax.imshow(np.transpose(img, (1, 0, 2))[::-1], aspect="auto", interpolation="nearest")
    ax.set_xlabel("time (columns)")
    ax.set_ylabel("frequency (pixels)")
    fig.tight_layout()
    if path:
        fig.savefig(path)
        plt.close(fig)
        return path
    return fig
