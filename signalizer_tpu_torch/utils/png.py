"""Minimal RGBA PNG encoder (stdlib zlib only).

A copy of :mod:`signalizer_tpu.utils.png` (the port imports nothing of
the JAX package). The editor shell streams the spectrogram's scrolled
image and needs a compact wire format without adding an imaging
dependency; a PNG writer over zlib is ~30 lines. Used for the browser editor's image endpoint and
handy for golden-image dumps in tests.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["encode_png"]


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(rgba: np.ndarray) -> bytes:
    """[H, W, 4] uint8 -> PNG bytes (RGBA8, filter 0 rows)."""
    img = np.ascontiguousarray(rgba, np.uint8)
    if img.ndim != 3 or img.shape[2] != 4:
        raise ValueError(f"expected [H, W, 4] u8, got {img.shape}")
    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)  # 8-bit RGBA
    # filter byte 0 before every row
    raw = np.empty((h, 1 + w * 4), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(h, w * 4)
    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            _chunk(b"IHDR", ihdr),
            _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
            _chunk(b"IEND", b""),
        ]
    )
