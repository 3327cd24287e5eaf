"""Preset manager — named archives on disk.

Semantic equivalent of cpl's CPresetManager (ref: usage at
PluginProcessor.cpp:83-101 default-preset load and the CPresetWidget;
presets shipped as Make/Skeleton/presets/*.sgn). Files are ``.sgz``
(our JSON archive format, see state/serialize.py).

The port's own copy of :mod:`signalizer_tpu.state.presets`, arithmetic and names unchanged;
tests/test_torch_params_state.py holds the two equal.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

from signalizer_tpu_torch.state.serialize import Archive

PRESET_EXTENSION = ".sgz"
DEFAULT_PRESET_NAME = "default.main"


class PresetManager:
    """User preset directory with a read-only factory-corpus fallback
    (the reference installs Make/Skeleton/presets/ beside the binary and
    resolves names against it; here the corpus ships inside the package,
    see state/factory_presets.py).

    ``directory=None`` gives a factory-only manager (loads resolve
    against the shipped corpus; saves raise).
    """

    def __init__(self, directory=None, *, factory_dir=None):
        self.directory = None
        if directory is not None:
            self.directory = Path(directory)
            self.directory.mkdir(parents=True, exist_ok=True)
        if factory_dir is None:
            from signalizer_tpu_torch.state.factory_presets import FACTORY_DIR

            factory_dir = FACTORY_DIR
        self.factory_dir = Path(factory_dir)

    @staticmethod
    def _validate_name(name: str) -> str:
        """Reject path-traversal names: preset names are plain file stems,
        never paths (names reach this layer from network-facing editor
        endpoints, so '../..' must not escape the preset directory)."""
        if (
            not name
            or name != Path(name).name
            or ".." in name
            or "/" in name
            or "\\" in name
            or name in (".", "~")
        ):
            raise ValueError(f"invalid preset name: {name!r}")
        return name

    def _path(self, name: str) -> Path:
        self._validate_name(name)
        if self.directory is None:
            raise RuntimeError("PresetManager has no writable directory")
        return self.directory / (name + PRESET_EXTENSION)

    def _resolve(self, name: str) -> Path:
        """User dir first, then the shipped factory corpus."""
        fname = self._validate_name(name) + PRESET_EXTENSION
        if self.directory is not None:
            p = self.directory / fname
            if p.exists():
                return p
        return self.factory_dir / fname

    def list_presets(self) -> List[str]:
        names = set()
        for d in (self.directory, self.factory_dir):
            if d is not None and d.is_dir():
                names.update(
                    p.name[: -len(PRESET_EXTENSION)]
                    for p in d.glob(f"*{PRESET_EXTENSION}")
                )
        return sorted(names)

    def save(self, name: str, archive: Archive) -> Path:
        path = self._path(name)
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(archive.to_bytes())
        os.replace(tmp, path)  # atomic
        return path

    def load(self, name: str) -> Archive:
        return Archive.from_bytes(self._resolve(name).read_bytes())

    def try_load(self, name: str) -> Optional[Archive]:
        try:
            return self.load(name)
        except Exception:
            # the tolerant path: a corrupt/truncated/hostile archive can
            # raise KeyError/AttributeError/TypeError out of
            # Archive.from_bytes, not just ValueError (a
            # malformed default.main.sgz must not crash engine construction)
            return None

    def load_default(self) -> Optional[Archive]:
        """ref: default.main.sgn loaded at plugin construction."""
        return self.try_load(DEFAULT_PRESET_NAME)

    def delete(self, name: str) -> bool:
        try:
            self._path(name).unlink()
            return True
        except FileNotFoundError:
            return False
