"""Line-graph render feed: spectrum results -> vertex arrays + legend.

Host-side equivalent of the reference's line-graph vertex generation
(ref: Source/Spectrum/SpectrumRendering.cpp:793-897
renderTransformAsGraph): per line graph k, back to front, a flood-fill
GL_LINES array ((i, value) -> (i, endPoint) at ``flood_fill_alpha``) and a
GL_LINE_STRIP array ((i, value)), the second channel row drawn at z=-0.5
with the 'two' colour and the first at z=0 with the 'one' colour. Multiple
pairs hue-rotate both colours (ref: ColourRotation usage in
recalculateLegend, Spectrum.cpp graph-mix path).

A viewer (the JAX package's
``views.render.render_line_graph_frame``) renders purely from these arrays — nothing reaches back into the DSP.

The port's own copy of :mod:`signalizer_tpu.views.line_graph`, arithmetic and names unchanged;
tests/test_torch_params_state.py holds the two equal.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from signalizer_tpu_torch.utils.axis import AxisLine, db_meter_axis, frequency_axis
from signalizer_tpu_torch.utils.colour import ColourRotation, Legend, LegendEntry


class LineStrip(NamedTuple):
    """One GL_LINE_STRIP: vertices [P, 3] (x=pixel, y=display value, z),
    rgba colour, and the legend label."""

    vertices: np.ndarray
    colour: np.ndarray  # [4]
    label: str


class FloodFill(NamedTuple):
    """One GL_LINES array: vertices [2P, 3] alternating (i, value) and
    (i, end_point) — the translucent fill under a strip."""

    vertices: np.ndarray
    colour: np.ndarray  # [4] (alpha = flood_fill_alpha)


class LineGraphFrame(NamedTuple):
    """Render-ready line-graph frame, draw order back-to-front."""

    floods: List[FloodFill]
    strips: List[LineStrip]
    grid: List[AxisLine]  # frequency divisions, positions normalized [0, 1]
    db_grid: List[AxisLine]  # dB divisions, positions normalized [0, 1]
    legend: Optional[Legend]
    primitive_size: float
    grid_colour: np.ndarray  # [4]
    background_colour: np.ndarray  # [4]


class LineGraphRenderFeed:
    """Builds :class:`LineGraphFrame` from spectrum results.

    ``line_colours``: per line graph k a (one, two) rgba pair
    (ref: SpectrumContent lines[k].colourOne/colourTwo). ``pairs`` > 1
    hue-rotates both palettes per pair.
    """

    def __init__(
        self,
        *,
        mapped_frequencies: np.ndarray,
        line_colours: Sequence[Tuple[Sequence[float], Sequence[float]]],
        pairs: int = 1,
        flood_fill_alpha: float = 0.2,
        primitive_size: float = 1.0,
        show_legend: bool = True,
        grid_colour: Sequence[float] = (0.5, 0.5, 0.5, 1.0),
        background_colour: Sequence[float] = (0.0, 0.0, 0.0, 1.0),
        low_dbs: float = -96.0,
        high_dbs: float = 0.0,
        channel_names: Sequence[str] = ("left", "right"),
        divisions_pct: float = 0.5,
        configuration=None,
    ):
        self.configuration = configuration  # SpectrumChannels or None
        self.mapped_frequencies = np.asarray(mapped_frequencies, np.float64)
        self.pairs = int(pairs)
        self.flood_fill_alpha = float(flood_fill_alpha)
        self.primitive_size = float(primitive_size)
        self.show_legend = bool(show_legend)
        self.grid_colour = np.asarray(grid_colour, np.float32)
        self.background_colour = np.asarray(background_colour, np.float32)
        self.low_dbs = float(low_dbs)
        self.high_dbs = float(high_dbs)
        self.channel_names = tuple(channel_names)
        # grid density: a division every ~pct of the view
        # (ref: pctForDivision spacing in renderLineGrid)
        self.max_divisions = max(2, int(round(1.0 / max(float(divisions_pct), 0.02))))
        # per-pair rotated palettes (ref: ColourRotation of one/two)
        self._one = [
            ColourRotation(np.asarray(c[0], np.float32)[:3], max(pairs, 1)).as_array()
            for c in line_colours
        ]  # [K][pairs, 3]
        self._two = [
            ColourRotation(np.asarray(c[1], np.float32)[:3], max(pairs, 1)).as_array()
            for c in line_colours
        ]
        self._alphas = [
            (float(c[0][3]) if len(c[0]) > 3 else 1.0, float(c[1][3]) if len(c[1]) > 3 else 1.0)
            for c in line_colours
        ]
        # axis grids depend only on construction-time inputs — compute
        # once, not per render tick (single host core)
        self._grid = frequency_axis(
            self.mapped_frequencies, max_divisions=self.max_divisions
        )
        self._db_grid = db_meter_axis(
            self.low_dbs, self.high_dbs, max_divisions=self.max_divisions
        )
        # per-tick caches (single host core, 60 Hz): the x ramp, the
        # legend (layout/colours only — no per-tick data), and the strip
        # labels are all construction-time constants per result shape
        self._x_cache: dict = {}
        self._legend_cache: dict = {}

    def _rgba(self, rgb: np.ndarray, alpha: float) -> np.ndarray:
        return np.asarray([rgb[0], rgb[1], rgb[2], alpha], np.float32)

    def _row_layout(self, rows: int):
        """(result row, colour slot, legend name) per displayed row, in
        display order — the reference's per-configuration legend/colour
        conventions (Spectrum.cpp:660-706): Right and Side draw with the
        'two' colour slot; composite modes name their signal algebra."""
        l, r = (self.channel_names + ("left", "right"))[:2]
        cfg = getattr(self.configuration, "name", None)
        if rows > 1:
            names = {
                "MIDSIDE": (f"{l} + {r}", f"{l} - {r}"),
                "PHASE": (f"|{l}| + |{r}|", f"{l} / {r}"),
            }.get(cfg, (l, r))
            return [(0, 0, names[0]), (1, 1, names[1])]
        single = {
            "RIGHT": (0, 1, r),
            "SIDE": (0, 1, f"{l} - {r}"),
            "MERGE": (0, 0, f"{l} + {r}"),
            "COMPLEX": (0, 0, f"{l} + i*{r}"),
        }.get(cfg, (0, 0, l))
        return [single]

    def build(self, results: np.ndarray) -> LineGraphFrame:
        """results [pairs, K, rows, P] (one time step of the display values,
        e.g. ``SpectrumProcessor.process(...)[:, -1]``) -> frame."""
        results = np.asarray(results)
        if results.ndim == 3:  # [K, rows, P] single pair
            results = results[None]
        pairs, k_graphs, rows, p = results.shape
        x = self._x_cache.get(p)
        if x is None:
            x = self._x_cache[p] = np.arange(p, dtype=np.float32)
        # ref: endPoint = 0 when high > low else 1 (flood fills toward the
        # bottom of the display)
        end_point = 0.0 if self.high_dbs > self.low_dbs else 1.0

        floods: List[FloodFill] = []
        strips: List[LineStrip] = []
        legend_entries: List[LegendEntry] = []

        graph_names = ["main", "second"] + [f"line{k}" for k in range(2, k_graphs)]

        row_layout = self._row_layout(rows)
        # back to front: k descending; within each k the 'two'-slot row
        # first (z=-0.5), then the 'one' slot (z=0) — ref fall-through
        # order. (Deviation: the reference composites pair-major —
        # pair 1's whole graph over pair 0's — while this frame batches
        # floods before strips; with default alphas the visual difference
        # is the strip/flood interleave between pairs only.)
        for k in range(k_graphs - 1, -1, -1):
            for pair in range(pairs):
                for row, slot, name in reversed(row_layout):
                    table = self._two if slot == 1 else self._one
                    rgb = table[k][pair]
                    alpha = self._alphas[k][slot]
                    z = -0.5 if slot == 1 else 0.0
                    y = results[pair, k, row].astype(np.float32)
                    if self.flood_fill_alpha > 0.0:
                        fv = np.empty((2 * p, 3), np.float32)
                        fv[0::2, 0] = x
                        fv[0::2, 1] = y
                        fv[0::2, 2] = z
                        fv[1::2, 0] = x
                        fv[1::2, 1] = end_point
                        fv[1::2, 2] = z
                        floods.append(
                            FloodFill(fv, self._rgba(rgb, self.flood_fill_alpha))
                        )
                    sv = np.empty((p, 3), np.float32)
                    sv[:, 0] = x
                    sv[:, 1] = y
                    sv[:, 2] = z
                    label = f"pair{pair} {name} {graph_names[k]}" if pairs > 1 else f"{name} {graph_names[k]}"
                    strips.append(LineStrip(sv, self._rgba(rgb, alpha), label))
        # legend ascending (ref: recalculateLegend's ascending pair loop) —
        # pure function of (pairs, k_graphs, rows): cache per shape
        legend = None
        if self.show_legend:
            legend = self._legend_cache.get((pairs, k_graphs, rows))
            if legend is None:
                for pair in range(pairs):
                    for k in range(k_graphs):
                        for row, slot, name in row_layout:
                            table = self._two if slot == 1 else self._one
                            label = f"pair{pair} {name} {graph_names[k]}" if pairs > 1 else f"{name} {graph_names[k]}"
                            legend_entries.append(
                                LegendEntry(label, tuple(table[k][pair]))
                            )
                legend = Legend(legend_entries)
                self._legend_cache[(pairs, k_graphs, rows)] = legend
        return LineGraphFrame(
            floods=floods,
            strips=strips,
            grid=self._grid,
            db_grid=self._db_grid,
            legend=legend,
            primitive_size=self.primitive_size,
            grid_colour=self.grid_colour,
            background_colour=self.background_colour,
        )
