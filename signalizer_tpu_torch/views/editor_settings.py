"""Global editor-shell settings as a data model.

The reference's MainEditor owns a set of *global* (non-view) settings —
UI refresh rate (10–1000 ms, MainEditor.cpp:393-400), render engine,
MSAA antialiasing level, vsync + swap interval, tab/kiosk state, widget
behaviour toggles, legend choice, and a 10-colour UI scheme — serialized
in the session archive's "Editor" subtree (ref: MainEditor::serialize,
MainEditor.cpp:1046-1080). This module is their data-model equivalent for
embedders: no GUI, but the same knobs, persisted in our archives and
importable from the reference's binary ``main`` presets.

Reference-import notes (see state/sgn_import.py for the container
format): each colour control leaf stores its ARGB at a fixed offset
behind a recognizable widget suffix — decoded exactly. The editor's own
value stream is normalized float64 knobs in serialize order with that
same 10-byte suffix after text-entry widgets; offsets were validated
against the shipped ``default.main.sgn`` (the only main preset in the
corpus), so the scalar import is best-effort and documented as such.

The port's own copy of :mod:`signalizer_tpu.views.editor_settings`, arithmetic and names unchanged;
tests/test_torch_params_state.py holds the two equal.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from signalizer_tpu_torch.state.serialize import Archive

__all__ = ["EditorSettings", "DEFAULT_COLOUR_SCHEME"]

# ref: MainEditor's colourControls titles (cpl colour scheme ids), values
# from the shipped default.main preset
DEFAULT_COLOUR_SCHEME: Dict[str, Tuple[float, float, float, float]] = {
    "Activated": (0.196, 0.196, 0.196, 1.0),
    "Auxillary": (0.796, 0.796, 0.796, 1.0),
    "Auxillary Text": (0.502, 0.502, 0.502, 1.0),
    "Control Text": (0.847, 0.847, 0.706, 1.0),
    "Deactivated": (0.102, 0.102, 0.102, 1.0),
    "Error": (0.498, 0.0, 0.0, 1.0),
    "Normal": (0.157, 0.157, 0.157, 1.0),
    "Selected Text": (0.6, 0.6, 0.4, 1.0),
    "Separator": (0.294, 0.294, 0.294, 1.0),
    "Success": (0.0, 0.498, 0.0, 1.0),
}

# MSAA choices offered by the reference (MainEditor antialiasing combo)
ANTIALIAS_LEVELS = (1, 2, 4, 8, 16)

# the 10-byte widget-state suffix cpl text-entry/colour widgets append
_WIDGET_SUFFIX = bytes.fromhex("0100fa000000060000" + "00")


@dataclass
class EditorSettings:
    """MainEditor's global settings, minus the window itself."""

    refresh_rate_ms: float = 80.0          # 10..1000, exponential knob
    render_engine: int = 1                 # 0 = software, 1 = openGL
    antialias_level: int = 8               # MSAA samples
    vsync: bool = True
    swap_interval: int = 0
    selected_tab: int = 0                  # view index (registration order)
    kiosk: bool = False
    hide_tabs: bool = True
    hide_widgets_on_mouse_exit: bool = True
    stop_processing_on_suspend: bool = True
    legend_choice: int = 0
    colour_scheme: Dict[str, Tuple[float, float, float, float]] = field(
        default_factory=lambda: dict(DEFAULT_COLOUR_SCHEME)
    )

    # --- our archive format -------------------------------------------------
    VERSION = 1

    def serialize(self, archive: Archive) -> None:
        archive.version = self.VERSION
        archive["refreshRateMs"] = self.refresh_rate_ms
        archive["renderEngine"] = self.render_engine
        archive["antialiasLevel"] = self.antialias_level
        archive["vsync"] = self.vsync
        archive["swapInterval"] = self.swap_interval
        archive["selectedTab"] = self.selected_tab
        archive["kiosk"] = self.kiosk
        archive["hideTabs"] = self.hide_tabs
        archive["hideWidgets"] = self.hide_widgets_on_mouse_exit
        archive["stopOnSuspend"] = self.stop_processing_on_suspend
        archive["legendChoice"] = self.legend_choice
        colours = archive.child("Colours")
        for name, rgba in self.colour_scheme.items():
            colours[name] = list(rgba)

    def deserialize(self, archive: Archive) -> None:
        self.refresh_rate_ms = float(archive.get("refreshRateMs", self.refresh_rate_ms))
        self.render_engine = int(archive.get("renderEngine", self.render_engine))
        self.antialias_level = int(archive.get("antialiasLevel", self.antialias_level))
        self.vsync = bool(archive.get("vsync", self.vsync))
        self.swap_interval = int(archive.get("swapInterval", self.swap_interval))
        self.selected_tab = int(archive.get("selectedTab", self.selected_tab))
        self.kiosk = bool(archive.get("kiosk", self.kiosk))
        self.hide_tabs = bool(archive.get("hideTabs", self.hide_tabs))
        self.hide_widgets_on_mouse_exit = bool(
            archive.get("hideWidgets", self.hide_widgets_on_mouse_exit))
        self.stop_processing_on_suspend = bool(
            archive.get("stopOnSuspend", self.stop_processing_on_suspend))
        self.legend_choice = int(archive.get("legendChoice", self.legend_choice))
        colours = archive.find_child("Colours")
        if colours is not None:
            for name in list(self.colour_scheme):
                v = colours.get(name)
                if v is not None:
                    self.colour_scheme[name] = tuple(float(x) for x in v)

    # --- reference import -----------------------------------------------------
    @classmethod
    def from_reference_main(cls, preset) -> "EditorSettings":
        """Best-effort import from a parsed reference ``main`` preset
        (:class:`signalizer_tpu_torch.state.sgn_import.SgnPreset`)."""
        self = cls()
        editor = preset.tree.get("Editor")
        if not isinstance(editor, dict):
            return self
        colours = editor.get("Colours")
        if isinstance(colours, dict):
            for name, leaf in colours.items():
                blob = leaf.get("<data>") if isinstance(leaf, dict) else leaf
                rgba = _decode_colour_leaf(blob)
                if rgba is not None:
                    self.colour_scheme[name] = rgba
        blob = editor.get("<data>")
        if isinstance(blob, (bytes, bytearray)):
            self._decode_editor_stream(bytes(blob))
        return self

    def _decode_editor_stream(self, blob: bytes) -> None:
        """MainEditor's direct value stream (serialize order at
        MainEditor.cpp:1046-1080): refreshRate, renderEngine, help, freeze,
        idle, bounds(4xi32), isEditorVisible, selTab, kioskCoords,
        hasAnyTabBeenSelected, kiosk, antialias, vsync, swapInterval, then
        [children], hideTabs, hideWidgets, stopOnSuspend, legendChoice.
        Knob doubles are normalized; text-entry widgets append the
        10-byte widget suffix."""
        if len(blob) < 18:
            return
        # leading knob: refresh rate, exp 10..1000 ms; the renderEngine
        # choice follows its 10-byte text-widget suffix
        (n,) = struct.unpack_from("<d", blob, 0)
        self.refresh_rate_ms = 10.0 * (100.0 ** min(max(n, 0.0), 1.0))
        if len(blob) >= 26 and blob[8:17] == _WIDGET_SUFFIX[:9]:
            (engine_n,) = struct.unpack_from("<d", blob, 18)
            self.render_engine = int(round(engine_n))
        # anchored from the end: ... antialias, vsync, swapInterval(3x f64),
        # <widget suffix>, hideTabs, hideWidgets, stopOnSuspend,
        # legendChoice (4x f64). swapInterval scales by the reference's
        # kdefaultMaxSkippedFrames = 10 (MainEditor.cpp:61,542).
        if len(blob) >= 66 and blob[-42:-33] == _WIDGET_SUFFIX[:9]:
            aa_n, vsync_n, swap_n = struct.unpack_from("<3d", blob, len(blob) - 66)
            idx = int(round(aa_n * (len(ANTIALIAS_LEVELS) - 1)))
            self.antialias_level = ANTIALIAS_LEVELS[
                max(0, min(idx, len(ANTIALIAS_LEVELS) - 1))]
            self.vsync = vsync_n > 0.5
            self.swap_interval = int(round(min(max(swap_n, 0.0), 1.0) * 10))
            tabs_n, widg_n, stop_n, legend_n = struct.unpack_from(
                "<4d", blob, len(blob) - 32)
            self.hide_tabs = tabs_n > 0.5
            self.hide_widgets_on_mouse_exit = widg_n > 0.5
            self.stop_processing_on_suspend = stop_n > 0.5
            self.legend_choice = int(round(legend_n * 4))


def _decode_colour_leaf(blob) -> Optional[Tuple[float, float, float, float]]:
    """A cpl colour control leaf stores ARGB right after the widget
    suffix (offset 18 in every corpus leaf)."""
    if not isinstance(blob, (bytes, bytearray)) or len(blob) < 22:
        return None
    i = bytes(blob).find(_WIDGET_SUFFIX[:9])
    if i < 0 or i + 10 + 4 > len(blob):
        return None
    a, r, g, b = blob[i + 10 : i + 14]
    return (r / 255.0, g / 255.0, b / 255.0, a / 255.0)


