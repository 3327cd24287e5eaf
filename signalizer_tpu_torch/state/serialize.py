"""Versioned keyed-tree serialization — the checkpoint system.

The port's own copy of :mod:`signalizer_tpu.state.serialize` (format and
behaviour unchanged: the two write the same bytes, which tests check). Semantic equivalent of cpl's ``CSerializer`` as the reference uses it
(ref: SURVEY.md §3.4/§5.4; entry points PluginProcessor.cpp:224-406;
format-evolution example OscilloscopeParameters.h:606-636): a hierarchical
keyed archive where every subtree carries a version stamp, deserialization
tolerates missing keys (old presets keep loading) and readers can gate
fields on the writer's version.

Format re-design (deliberate, per SURVEY §5.4 "import the semantics, not
the binary format"): the on-disk representation is JSON with base64-encoded
little-endian arrays — debuggable, diffable, schema-free — rather than the
reference's opaque length-prefixed binary. numpy arrays and CPU tensors
round-trip losslessly; tensors come back as numpy (device placement is
the caller's business).
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

FORMAT_MAGIC = "signalizer-tpu/archive"
FORMAT_VERSION = 1


def _check_serializable(v: Any) -> None:
    """Type-only mirror of :func:`_encode_value` for eager validation at
    Archive assignment — recursing on structure WITHOUT producing the
    encoded blob (the old validate-by-encoding base64'd every stored
    array twice per save)."""
    if isinstance(v, (bool, int, float, str, bytes)) or v is None:
        return
    if isinstance(v, (list, tuple)):
        for x in v:
            _check_serializable(x)
        return
    if isinstance(v, (np.integer, np.floating)):
        return
    if hasattr(v, "__array__"):
        return
    raise TypeError(f"cannot serialize {type(v)!r}")


def _encode_value(v: Any) -> Any:
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, bytes):
        return {"__bytes__": base64.b64encode(v).decode("ascii")}
    if isinstance(v, (list, tuple)):
        return {"__list__": [_encode_value(x) for x in v]}
    # numpy scalars BEFORE the __array__ probe (they satisfy it too) so
    # np.int32(5) round-trips as a plain number, not a 0-d array blob
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if hasattr(v, "__array__"):  # numpy arrays / CPU tensors
        arr = np.asarray(v)
        return {
            "__ndarray__": base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode("ascii"),
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
        }
    raise TypeError(f"cannot serialize {type(v)!r}")


def _decode_value(v: Any) -> Any:
    if isinstance(v, dict):
        if "__ndarray__" in v:
            raw = base64.b64decode(v["__ndarray__"])
            return np.frombuffer(raw, dtype=np.dtype(v["dtype"])).reshape(v["shape"]).copy()
        if "__bytes__" in v:
            return base64.b64decode(v["__bytes__"])
        if "__list__" in v:
            return [_decode_value(x) for x in v["__list__"]]
    return v


class Archive:
    """One node of the keyed tree: values + child archives + a version."""

    def __init__(self, version: int = 0):
        self._values: Dict[str, Any] = {}
        self._children: Dict[str, "Archive"] = {}
        self.version = version

    # --- values -------------------------------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        _check_serializable(value)  # validate eagerly, without encoding
        self._values[key] = value

    def __getitem__(self, key: str) -> Any:
        return self._values[key]

    def get(self, key: str, default: Any = None) -> Any:
        """Tolerant read — the version-compat workhorse."""
        return self._values.get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self._values or key in self._children

    def keys(self) -> Iterator[str]:
        return iter(self._values.keys())

    # --- children -----------------------------------------------------------
    def child(self, key: str) -> "Archive":
        """Get-or-create a subtree (ref: CSerializer getContent/operator[])."""
        if key not in self._children:
            self._children[key] = Archive(self.version)
        return self._children[key]

    def find_child(self, key: str) -> Optional["Archive"]:
        return self._children.get(key)

    def children(self) -> Iterator[Tuple[str, "Archive"]]:
        return iter(self._children.items())

    def remove_child(self, key: str) -> bool:
        """Drop a subtree (used to slim per-view preset archives)."""
        return self._children.pop(key, None) is not None

    @property
    def is_empty(self) -> bool:
        return not self._values and not self._children

    def clear(self) -> None:
        self._values.clear()
        self._children.clear()

    # --- io -------------------------------------------------------------------
    def _to_tree(self) -> dict:
        return {
            "v": self.version,
            "values": {k: _encode_value(v) for k, v in self._values.items()},
            "children": {k: c._to_tree() for k, c in self._children.items()},
        }

    @classmethod
    def _from_tree(cls, tree: dict) -> "Archive":
        ar = cls(tree.get("v", 0))
        ar._values = {k: _decode_value(v) for k, v in tree.get("values", {}).items()}
        ar._children = {k: cls._from_tree(c) for k, c in tree.get("children", {}).items()}
        return ar

    def to_bytes(self) -> bytes:
        doc = {"magic": FORMAT_MAGIC, "format": FORMAT_VERSION, "root": self._to_tree()}
        return json.dumps(doc, separators=(",", ":")).encode("utf-8")

    @classmethod
    def from_bytes(cls, data: bytes) -> "Archive":
        doc = json.loads(data.decode("utf-8"))
        if doc.get("magic") != FORMAT_MAGIC:
            raise ValueError("not a signalizer-tpu archive")
        fmt = doc.get("format", 0)
        if not isinstance(fmt, int) or fmt > FORMAT_VERSION:
            # a future encoding must refuse loudly, not mis-decode into
            # wrong values (the module's whole purpose is version-gated
            # deserialization)
            raise ValueError(
                f"archive format {fmt!r} is newer than this reader "
                f"(supports <= {FORMAT_VERSION})"
            )
        return cls._from_tree(doc["root"])

    def set_version_recursive(self, version: int) -> None:
        self.version = version
        for _, c in self.children():
            c.set_version_recursive(version)


class SerializableObject:
    """Protocol base (ref: cpl SafeSerializableObject): implement
    ``serialize(archive)`` / ``deserialize(archive)``."""

    def serialize(self, archive: Archive) -> None:
        raise NotImplementedError

    def deserialize(self, archive: Archive) -> None:
        raise NotImplementedError

    def get_state(self) -> bytes:
        ar = Archive()
        self.serialize(ar)
        return ar.to_bytes()

    def set_state(self, data: bytes) -> None:
        self.deserialize(Archive.from_bytes(data))


def serialize_parameter_set(pset, archive: Archive) -> None:
    """Persist every parameter's normalized value by name
    (ref: per-view Content::serialize walking parameter values)."""
    for p in pset:
        archive[p.name] = p.get_normalized()


def deserialize_parameter_set(pset, archive: Archive) -> None:
    for p in pset:
        v = archive.get(p.name)
        if v is not None:
            p.set_normalized(float(v), source="host")
