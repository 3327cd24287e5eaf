"""Importer for the reference's binary ``.sgn`` preset archives.

The reference ships 20 presets (``Make/Skeleton/presets/*.sgn``) written by
cpl's ``CSerializer`` (ref: PluginProcessor.cpp:345-406 writes them;
Make/Skeleton/presets is the corpus; the serializer itself lives in the cpl
submodule which is not checked out in the snapshot). This module lets a
reference user carry those presets straight into the engine.

Wire format (reverse-engineered from the shipped corpus — every structure
below was verified against all 20 files, see tests/test_sgn_import.py):

* The file is a sequence of *blocks*: ``{u64 header_size, u64 arg,
  u16 block_type, u8 rest[header_size-18]}`` followed by ``arg`` payload
  bytes for the payload-carrying types.
* Block types observed:
  - ``0x15`` file header (``arg`` = preset-name length incl. NUL; the
    header carries a 16-byte content digest; the name string follows)
  - ``0x10`` archive master (``arg`` = 0; rest = total size + version)
  - ``0x11`` key — payload is the key string for the next value block
  - ``0x12`` data leaf — payload is raw serialized bytes
  - ``0x13`` child archive — payload is a nested block sequence
  - ``0x16`` version info (no payload), ``0x14`` terminator
* A view preset's ``Parameters`` leaf is the view Content's ``serialize``
  output: one little-endian float64 **normalized value per scalar
  parameter**, in serialize order (ref: SpectrumParameters.h:242-289,
  OscilloscopeParameters.h:531-570, VectorscopeParameters.h:139-162).
  Colour bundles contribute 4 slots (RGBA), 3D transforms 9
  (position/rotation/scale xyz), the DSP window designer 4
  (type/symmetry/alpha/beta) and the power slope 3 (base/pivot/slope).
  The audio-history transformatter contributes one raw ``u64`` — the
  history capacity in samples (ref: CommonSignalizer.h:313-317).
* ``*.main.sgn`` presets nest per-view archives under ``Parameters/<View>``
  plus an ``Engine`` leaf (u64 history capacity) and GUI-only ``Editor``
  state (colour scheme, widget layout) which we ignore.

Fidelity notes / deliberate inferences:

* Values are applied as *normalized* knob positions, exactly like the
  reference's own deserialize (its header comments call out that changing
  a range is a breaking change for presets). Our transformers mirror the
  reference's ranges, so transformed values agree where ranges agree.
* ``ViewRight``/``ViewBottom`` knobs use a **reversed** unit range in the
  reference (ref: OscilloscopeParameters.h:369,421-422,
  SpectrumParameters.h:128); ours carry the same ReverseUnityRange, so
  the serialized normalized values apply verbatim (the "pr"/"offs-r"
  slot kinds remain for archives that need an explicit flip).
* cpl's window-type list has 18 entries (back-solved from the quantized
  choice values in the corpus: round(n*17) lands exactly on integers);
  ours has 16. :data:`REF_WINDOW_TABLE` maps them, substituting the
  nearest available design for the three windows we do not ship
  (Dolph-Chebyshev/Ultraspherical -> Kaiser-class, Sine -> Hann).
* cpl's window symmetry is a 3-way choice (Symmetric / Periodic /
  DFT-even); our designer keeps a boolean, so index 0 maps to symmetric
  and the two periodic variants to periodic.

The port's own copy of :mod:`signalizer_tpu.state.sgn_import`, arithmetic and names unchanged;
tests/test_torch_params_state.py holds the two equal.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from signalizer_tpu_torch.core.windows import WindowType

__all__ = [
    "SgnPreset",
    "parse_sgn",
    "load_sgn",
    "apply_view_parameters",
    "apply_preset",
    "reference_preset_dir",
    "build_view_parameters",
    "write_sgn",
    "save_sgn",
]

# block types
_T_ARCHIVE_MASTER = 0x10
_T_KEY = 0x11
_T_DATA = 0x12
_T_CHILD = 0x13
_T_END = 0x14
_T_FILE_HEADER = 0x15
_T_INFO = 0x16

Tree = Dict[str, Union[bytes, "Tree"]]

DATA_KEY = "<data>"  # leaf payload key inside a parsed archive dict


@dataclass
class SgnPreset:
    """A parsed ``.sgn`` archive."""

    name: str  # "main" / "spectrum" / "oscilloscope" / "vectorscope"
    tree: Tree = field(default_factory=dict)

    def parameters(self, view: Optional[str] = None) -> Optional[bytes]:
        """The normalized-f64 parameter blob for ``view`` (or the single
        view of a per-view preset)."""
        params = self.tree.get("Parameters")
        if params is None:
            return None
        if isinstance(params, bytes):
            return params
        if view is None:
            blob = params.get(DATA_KEY)
            return blob if isinstance(blob, bytes) else None
        sub = params.get(view)
        if isinstance(sub, dict):
            blob = sub.get(DATA_KEY)
            return blob if isinstance(blob, bytes) else None
        return sub if isinstance(sub, bytes) else None

    def history_capacity(self) -> Optional[int]:
        """The preset's audio-history capacity, if it carries one.

        Main presets store it as the u64 head of the ``Engine`` blob;
        per-view ``*.spectrum.sgn`` presets store it as the trailing u64
        slot of their ``Parameters`` blob (the slot layout is static, so
        it can be read without applying the preset)."""
        engine = self.tree.get("Engine")
        if isinstance(engine, dict):
            engine = engine.get(DATA_KEY)
        if isinstance(engine, bytes) and len(engine) >= 8:
            return struct.unpack_from("<Q", engine, 0)[0]
        if self.name == "spectrum":
            blob = self.parameters()
            if isinstance(blob, bytes):
                offset = 0
                for kind, _ in _SPECTRUM_SLOTS:
                    if kind == "u64":
                        if len(blob) >= (offset + 1) * 8:
                            return struct.unpack_from("<Q", blob, offset * 8)[0]
                        return None
                    offset += _slot_count(kind)
        return None


class SgnFormatError(ValueError):
    pass


def _walk_blocks(buf: bytes, depth: int = 0) -> Tree:
    """Parse one archive body (a block sequence) into a keyed tree."""
    if depth > 32:  # the corpus nests 3 deep; bound hostile inputs
        raise SgnFormatError("archive nesting too deep")
    tree: Tree = {}
    key: Optional[str] = None
    i, n = 0, len(buf)
    while i + 18 <= n:
        header_size, arg = struct.unpack_from("<QQ", buf, i)
        (block_type,) = struct.unpack_from("<H", buf, i + 16)
        if header_size < 18 or i + header_size > n:
            raise SgnFormatError(f"corrupt block header at {i}")
        i += header_size
        if block_type in (_T_KEY, _T_DATA, _T_CHILD) and i + arg > n:
            raise SgnFormatError(
                f"block payload of {arg} bytes exceeds the remaining {n - i}"
            )
        if block_type == _T_KEY:
            key = buf[i : i + arg].decode("latin1").rstrip("\0")
            i += arg
        elif block_type == _T_DATA:
            tree[key if key is not None else DATA_KEY] = buf[i : i + arg]
            key = None
            i += arg
        elif block_type == _T_CHILD:
            tree[key if key is not None else DATA_KEY] = _walk_blocks(
                buf[i : i + arg], depth + 1
            )
            key = None
            i += arg
        elif block_type in (_T_ARCHIVE_MASTER, _T_INFO, _T_END):
            # no payload beyond the header (master/info carry metadata in
            # the header tail; the terminator carries nothing)
            pass
        else:
            raise SgnFormatError(f"unknown block type 0x{block_type:x} at {i}")
    return tree


def parse_sgn(data: bytes) -> SgnPreset:
    """Parse a ``.sgn`` archive from bytes."""
    if len(data) < 40:
        raise SgnFormatError("too short for a .sgn file header")
    header_size, name_len = struct.unpack_from("<QQ", data, 0)
    (block_type,) = struct.unpack_from("<H", data, 16)
    if block_type != _T_FILE_HEADER or header_size < 18:
        raise SgnFormatError("missing .sgn file header block")
    if header_size + name_len > len(data):
        raise SgnFormatError(
            f"file header claims {header_size}+{name_len} bytes, file has {len(data)}"
        )
    name = data[header_size : header_size + name_len].rstrip(b"\0").decode("latin1")
    body = data[header_size + name_len :]
    return SgnPreset(name=name, tree=_walk_blocks(body))


def load_sgn(path) -> SgnPreset:
    return parse_sgn(Path(path).read_bytes())


def reference_preset_dir() -> Optional[Path]:
    """The reference checkout's preset corpus (``Make/Skeleton/presets``),
    named by the ``SIGNALIZER_REFERENCE_PRESETS`` environment variable, if
    that directory exists."""
    import os

    env = os.environ.get("SIGNALIZER_REFERENCE_PRESETS")
    p = Path(env) if env else None
    return p if p is not None and p.is_dir() else None


# --------------------------------------------------------------------------
# slot tables: reference serialize order -> our Content attributes
# --------------------------------------------------------------------------
# kinds: "p" scalar (1 slot), "pr" reversed-unit scalar (1 slot, apply 1-n),
# "c" colour bundle (4), "t" 3D transform bundle (9), "w" window designer
# (4), "s" power slope (3), "u64" raw history capacity (1 slot width),
# "offs" indexed view-offset parameter.

# ref: VectorscopeParameters.h:139-162
_VECTORSCOPE_SLOTS = [
    ("p", "window_size"),
    ("p", "input_gain"),
    ("p", "wave_z_rotation"),
    ("p", "antialias"),
    ("p", "fade_older_points"),
    ("p", "diagnostics"),
    ("p", "interconnect_samples"),
    ("c", "axis_colour"),
    ("c", "background_colour"),
    ("c", "waveform_colour"),
    ("t", "transform"),
    ("c", "skeleton_colour"),  # the reference's wireframeColour
    ("p", "primitive_size"),
    ("p", "auto_gain"),
    ("p", "envelope_window"),
    ("p", "operational_mode"),
    ("p", "stereo_window"),
    ("c", "meter_colour"),
    ("p", "scale_polar_mode_to_fill"),
    ("p", "show_legend"),
    ("c", "widget_colour"),
]

# ref: OscilloscopeParameters.h:531-570
_OSCILLOSCOPE_SLOTS = [
    ("p", "window_size"),
    ("p", "input_gain"),
    ("p", "antialias"),
    ("p", "diagnostics"),
    ("c", "graph_colour"),
    ("c", "background_colour"),
    ("c", "primary_colour"),
    ("t", "transform"),
    ("p", "primitive_size"),
    ("p", "auto_gain"),
    ("p", "envelope_window"),
    ("p", "sub_sample_interpolation"),
    ("p", "channel_configuration"),
    ("p", "pct_for_division"),
    ("p", "trigger_phase_offset"),
    ("p", "trigger_mode"),
    ("p", "time_mode"),
    # viewOffsets: Left, Top plain; Right, Bottom carry the
    # reverseUnitRange IN the parameter now (matching the reference), so
    # the serialized normalized value applies verbatim
    ("offs", 0),
    ("offs", 1),
    ("offs", 2),
    ("offs", 3),
    ("p", "dot_samples"),
    ("p", "trigger_on_custom_frequency"),
    ("p", "custom_trigger_frequency"),
    ("p", "overlay_channels"),
    ("p", "channel_colouring"),
    ("c", "low_colour"),
    ("c", "mid_colour"),
    ("c", "high_colour"),
    ("c", "secondary_colour"),
    ("p", "colour_smoothing"),
    ("p", "cursor_tracker"),
    ("c", "widget_colour"),
    ("p", "frequency_colouring_blend"),
    ("p", "trigger_hysteresis"),
    ("p", "trigger_threshold"),
    ("p", "show_legend"),
    ("p", "triggering_channel"),
]

# ref: SpectrumParameters.h:242-289
_SPECTRUM_SLOTS = [
    ("p", "view_scaling"),
    ("p", "algorithm"),
    ("p", "channel_configuration"),
    ("p", "display_mode"),
    ("p", "high_dbs"),
    ("p", "low_dbs"),
    ("p", "window_size"),
    ("p", "pct_for_division"),
    ("line", 0),  # colourOne, colourTwo, decay
    ("line", 1),
    ("c", "grid_colour"),
    ("p", "blob_size"),
    ("c", "background_colour"),
    ("p", "frame_update_smoothing"),
    ("grad", 0),  # colour + ratio
    ("grad", 1),
    ("grad", 2),
    ("grad", 3),
    ("grad", 4),
    ("p", "bin_interpolation"),
    ("p", "view_left"),
    ("p", "view_right"),  # the param itself is reverseUnitRange (ref :128)
    ("w", "dsp_win"),
    ("p", "free_q"),
    ("p", "spectrum_stretching"),
    ("p", "frequency_tracker"),
    ("p", "primitive_size"),
    ("p", "flood_fill_alpha"),
    ("s", "slope"),
    ("p", "reference_tuning"),
    ("u64", None),  # audioHistoryTransformatter capacity
    ("p", "tracker_smoothing"),
    ("c", "widget_colour"),
    ("p", "show_legend"),
]

# cpl's 18-entry WindowTypes (reconstructed; see module docstring) -> ours.
REF_WINDOW_TABLE: Tuple[WindowType, ...] = (
    WindowType.RECTANGULAR,
    WindowType.HANN,
    WindowType.HAMMING,
    WindowType.FLAT_TOP,
    WindowType.BLACKMAN,
    WindowType.EXACT_BLACKMAN,
    WindowType.NUTTALL,
    WindowType.BLACKMAN_NUTTALL,
    WindowType.BLACKMAN_HARRIS,
    WindowType.GAUSSIAN,
    WindowType.SLEPIAN,
    WindowType.SLEPIAN,  # Dolph-Chebyshev: nearest shipped minimax design
    WindowType.KAISER,
    WindowType.KAISER,  # Ultraspherical: Kaiser-class substitute
    WindowType.HANN,  # Sine: nearest shipped mainlobe shape
    WindowType.LANCZOS,
    WindowType.TRIANGULAR,
    WindowType.PARZEN,
)

_SOURCE = "sgn-preset"


def _slot_count(kind: str) -> int:
    return {"p": 1, "pr": 1, "offs": 1, "offs-r": 1, "c": 4, "t": 9,
            "w": 4, "s": 3, "u64": 1, "line": 9, "grad": 5}[kind]


def _expected_slots(slots) -> int:
    return sum(_slot_count(kind) for kind, _ in slots)


def _apply_window_design(bundle, values: List[float]) -> None:
    """(type, symmetry, alpha, beta) normalized slots -> our designer."""
    type_n, symmetry_n, alpha_n, beta_n = values
    ref_index = int(round(type_n * (len(REF_WINDOW_TABLE) - 1)))
    ref_index = max(0, min(ref_index, len(REF_WINDOW_TABLE) - 1))
    ours = REF_WINDOW_TABLE[ref_index]
    denom = max(len(WindowType) - 1, 1)
    bundle.window_type.set_normalized(int(ours) / denom, source=_SOURCE)
    # 3-way symmetry choice: 0 = Symmetric, else periodic variants
    symmetric = round(symmetry_n * 2) == 0
    bundle.symmetric.set_normalized(1.0 if symmetric else 0.0, source=_SOURCE)
    bundle.alpha.set_normalized(alpha_n, source=_SOURCE)
    bundle.beta.set_normalized(beta_n, source=_SOURCE)


def apply_view_parameters(content, blob: bytes) -> int:
    """Apply a view preset's ``Parameters`` blob to the matching Content.

    Returns the history capacity if the blob carried one (spectrum), else 0.
    Raises :class:`SgnFormatError` on a size mismatch — the blob layout is
    fully static per view, so any drift means the archive is not what we
    think it is.
    """
    name = type(content).NAME
    slots = {
        "Vectorscope": _VECTORSCOPE_SLOTS,
        "Oscilloscope": _OSCILLOSCOPE_SLOTS,
        "Spectrum": _SPECTRUM_SLOTS,
    }[name]
    expected = _expected_slots(slots)
    if len(blob) != expected * 8:
        raise SgnFormatError(
            f"{name} parameter blob is {len(blob)} bytes, expected {expected * 8}"
        )
    capacity = 0
    pos = 0

    def take(k: int) -> List[float]:
        nonlocal pos
        out = list(struct.unpack_from(f"<{k}d", blob, pos * 8))
        pos += k
        return out

    for kind, target in slots:
        if kind == "p":
            getattr(content, target).set_normalized(take(1)[0], source=_SOURCE)
        elif kind == "pr":
            getattr(content, target).set_normalized(1.0 - take(1)[0], source=_SOURCE)
        elif kind == "offs":
            content.view_offsets[target].set_normalized(take(1)[0], source=_SOURCE)
        elif kind == "offs-r":
            content.view_offsets[target].set_normalized(1.0 - take(1)[0], source=_SOURCE)
        elif kind == "c":
            for p, v in zip(getattr(content, target).parameters(), take(4)):
                p.set_normalized(v, source=_SOURCE)
        elif kind == "t":
            for p, v in zip(getattr(content, target).parameters(), take(9)):
                p.set_normalized(v, source=_SOURCE)
        elif kind == "w":
            _apply_window_design(getattr(content, target), take(4))
        elif kind == "s":
            bundle = getattr(content, target)
            for p, v in zip((bundle.base, bundle.pivot, bundle.slope), take(3)):
                p.set_normalized(v, source=_SOURCE)
        elif kind == "line":
            decay, one, two = content.lines[target]
            for p, v in zip(one.parameters(), take(4)):
                p.set_normalized(v, source=_SOURCE)
            for p, v in zip(two.parameters(), take(4)):
                p.set_normalized(v, source=_SOURCE)
            decay.set_normalized(take(1)[0], source=_SOURCE)
        elif kind == "grad":
            for p, v in zip(content.spec_colours[target].parameters(), take(4)):
                p.set_normalized(v, source=_SOURCE)
            content.spec_ratios[target].set_normalized(take(1)[0], source=_SOURCE)
        elif kind == "u64":
            capacity = struct.unpack_from("<Q", blob, pos * 8)[0]
            pos += 1
    return capacity


# view name inside a main preset's Parameters child per Content class name
_VIEW_KEYS = {"Vectorscope": "Vectorscope", "Oscilloscope": "Oscilloscope",
              "Spectrum": "Spectrum"}


def apply_preset(preset: SgnPreset, *, vectorscope=None, oscilloscope=None,
                 spectrum=None) -> List[str]:
    """Apply a parsed preset to whichever Contents are supplied.

    Per-view presets (``*.spectrum.sgn`` …) apply to the matching Content;
    ``main`` presets apply every supplied view. Returns the view names
    that were applied.
    """
    contents = {
        "vectorscope": vectorscope,
        "oscilloscope": oscilloscope,
        "spectrum": spectrum,
    }
    applied: List[str] = []
    if preset.name in contents:
        content = contents[preset.name]
        if content is not None:
            blob = preset.parameters()
            if blob is None:
                raise SgnFormatError(f"{preset.name} preset has no Parameters blob")
            apply_view_parameters(content, blob)
            applied.append(preset.name)
        return applied
    # main preset: per-view children
    for view, content in contents.items():
        if content is None:
            continue
        blob = preset.parameters(_VIEW_KEYS[type(content).NAME])
        if blob is not None:
            apply_view_parameters(content, blob)
            applied.append(view)
    return applied


# --------------------------------------------------------------------------
# export: write our state back in the reference's wire format
# --------------------------------------------------------------------------
# Byte-level templates replicate the corpus exactly (the reference's own
# loader reads these structures). The 16-byte file-header digest is the
# MD5 of the body — verified against every shipped preset.

# version stamp written into archive masters: cpl::Version(0,4,3) packed
# as 16-bit fields, matching the reference release the corpus targets.
_EXPORT_VERSION = (0 << 32) | (4 << 16) | 3
# the 0x16 info block's header tail as written by the reference (writer
# metadata; constant across the whole corpus)
_INFO_TAIL = bytes.fromhex("3a005c004100000004000000 0000".replace(" ", ""))

# our window list -> cpl's 18-entry list (inverse of REF_WINDOW_TABLE;
# Welch has no cpl equivalent and exports as Triangular)
_OURS_TO_REF_WINDOW = {
    WindowType.RECTANGULAR: 0,
    WindowType.HANN: 1,
    WindowType.HAMMING: 2,
    WindowType.FLAT_TOP: 3,
    WindowType.BLACKMAN: 4,
    WindowType.EXACT_BLACKMAN: 5,
    WindowType.NUTTALL: 6,
    WindowType.BLACKMAN_NUTTALL: 7,
    WindowType.BLACKMAN_HARRIS: 8,
    WindowType.GAUSSIAN: 9,
    WindowType.SLEPIAN: 10,
    WindowType.KAISER: 12,
    WindowType.LANCZOS: 15,
    WindowType.TRIANGULAR: 16,
    WindowType.WELCH: 16,
    WindowType.PARZEN: 17,
}


def _key_block(name: str) -> bytes:
    raw = name.encode("latin1")
    return struct.pack("<QQH6xQQ", 40, len(raw), _T_KEY, 1, 0) + raw


def _data_block(payload: bytes) -> bytes:
    # the corpus writes 0x73 ('s') in the data header tail
    return struct.pack("<QQHB5x", 24, len(payload), _T_DATA, 0x73) + payload


def _child_block(body: bytes) -> bytes:
    return struct.pack("<QQH6x", 24, len(body), _T_CHILD) + body


def _info_block() -> bytes:
    return struct.pack("<QQH", 32, 0, _T_INFO) + _INFO_TAIL


def _end_block() -> bytes:
    return struct.pack("<QQH6x", 24, 0, _T_END)


def _archive_body(tree: Tree, *, top_level: bool) -> bytes:
    entries = b"" if top_level else _info_block()
    for key, value in tree.items():
        if key != DATA_KEY:
            entries += _key_block(key)
        if isinstance(value, dict):
            entries += _child_block(_archive_body(value, top_level=False))
        else:
            entries += _data_block(value)
    if not top_level:
        return entries
    # master block's size field covers master + entries + terminator
    total = 40 + len(entries) + 24
    master = struct.pack("<QQH6xQQ", 40, 0, _T_ARCHIVE_MASTER, total, _EXPORT_VERSION)
    return master + entries + _end_block()


def write_sgn(name: str, tree: Tree) -> bytes:
    """Serialize a keyed tree as a ``.sgn`` archive (the reference's
    format, incl. the MD5 body digest in the file header)."""
    import hashlib

    raw_name = name.encode("latin1") + b"\0"
    body = _archive_body(tree, top_level=True)
    header = struct.pack("<QQH", 40, len(raw_name), _T_FILE_HEADER)
    header += hashlib.md5(body).digest() + b"\0" * 6
    return header + raw_name + body


def _build_window_design(bundle) -> List[float]:
    ours = bundle.get_window_type()
    ref_index = _OURS_TO_REF_WINDOW.get(ours, 1)
    type_n = ref_index / (len(REF_WINDOW_TABLE) - 1)
    symmetry_n = 0.0 if bundle.symmetric.get_transformed() > 0.5 else 0.5
    return [type_n, symmetry_n,
            bundle.alpha.get_normalized(), bundle.beta.get_normalized()]


def build_view_parameters(content) -> bytes:
    """Inverse of :func:`apply_view_parameters`: our Content's knobs as the
    reference's normalized-f64 Parameters blob."""
    name = type(content).NAME
    slots = {
        "Vectorscope": _VECTORSCOPE_SLOTS,
        "Oscilloscope": _OSCILLOSCOPE_SLOTS,
        "Spectrum": _SPECTRUM_SLOTS,
    }[name]
    out = bytearray()

    def put(*values: float) -> None:
        out.extend(struct.pack(f"<{len(values)}d", *values))

    for kind, target in slots:
        if kind == "p":
            put(getattr(content, target).get_normalized())
        elif kind == "pr":
            put(1.0 - getattr(content, target).get_normalized())
        elif kind == "offs":
            put(content.view_offsets[target].get_normalized())
        elif kind == "offs-r":
            put(1.0 - content.view_offsets[target].get_normalized())
        elif kind in ("c", "t"):
            put(*(p.get_normalized() for p in getattr(content, target).parameters()))
        elif kind == "w":
            put(*_build_window_design(getattr(content, target)))
        elif kind == "s":
            bundle = getattr(content, target)
            put(bundle.base.get_normalized(), bundle.pivot.get_normalized(),
                bundle.slope.get_normalized())
        elif kind == "line":
            decay, one, two = content.lines[target]
            put(*(p.get_normalized() for p in one.parameters()))
            put(*(p.get_normalized() for p in two.parameters()))
            put(decay.get_normalized())
        elif kind == "grad":
            put(*(p.get_normalized() for p in content.spec_colours[target].parameters()))
            put(content.spec_ratios[target].get_normalized())
        elif kind == "u64":
            out.extend(struct.pack("<Q", int(content.audio_history_transformatter.capacity)))
    return bytes(out)


def save_sgn(path, *, vectorscope=None, oscilloscope=None, spectrum=None,
             history_capacity: Optional[int] = None) -> bytes:
    """Write a ``.sgn`` preset file from our Contents.

    One view -> a per-view preset named like the reference's
    (``<anything>.<view>.sgn``); several views -> a ``main`` preset with
    per-view Parameters children and an Engine capacity leaf.

    Caveat: the reference's *controller* UI state ("Editor" blobs — widget
    layout, colour scheme) is GUI-only and not reconstructed; our own
    importer and any Parameters-reading consumer round-trip fully.
    """
    contents = {
        "Vectorscope": vectorscope,
        "Oscilloscope": oscilloscope,
        "Spectrum": spectrum,
    }
    supplied = {k: v for k, v in contents.items() if v is not None}
    if not supplied:
        raise ValueError("supply at least one Content")
    if len(supplied) == 1:
        ((view_name, content),) = supplied.items()
        data = write_sgn(view_name.lower(),
                         {"Parameters": {DATA_KEY: build_view_parameters(content)}})
    else:
        params: Tree = {
            view: {DATA_KEY: build_view_parameters(content)}
            for view, content in supplied.items()
        }
        cap = history_capacity
        if cap is None:
            any_content = next(iter(supplied.values()))
            tf = getattr(any_content, "audio_history_transformatter",
                         getattr(any_content, "window_transformatter", None))
            cap = int(tf.capacity) if tf is not None else 48_000
        tree: Tree = {"Parameters": params,
                      "Engine": {DATA_KEY: struct.pack("<Q", cap)}}
        data = write_sgn("main", tree)
    Path(path).write_bytes(data)
    return data
