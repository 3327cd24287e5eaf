"""ctypes bindings for the native host runtime
(``signalizer_tpu_torch/native/host_runtime.cpp``).

The port's own copy of :mod:`signalizer_tpu.native_bindings`: the C++
source is the JAX package's, byte for byte, and the classes below keep its
interface and behaviour (tests hold the native ring equal to the numpy one
and both sources equal). What differs is where the library goes: ``g++``
builds it on first use into ``build/signalizer_tpu_torch/`` beside the
package, named by a hash of the source and the flags, never beside the
source and never at import. :class:`NativeRingBuffer` has the interface of
:class:`signalizer_tpu_torch.stream.ring_buffer.RingBuffer` plus a bulk
``frame_gather``; :class:`NativePacketQueue` is the threaded stream's SPSC
packet queue. Where no compiler is available the callers keep to the numpy
ring and ``queue.Queue`` (``native_available()``, ``native_build_error()``
say which ran); nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from signalizer_tpu_torch.kernels._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "native" / "host_runtime.cpp"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++20")

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libsignalizer_host_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile the shared library into ``out``; returns an error string or
    None. Builds into a file of this process's own and renames it, so that
    processes building at once never load a half-written library."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            return proc.stderr[:2000]
        os.replace(tmp, out)
        return None
    except (OSError, subprocess.TimeoutExpired) as e:  # no compiler etc.
        return str(e)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        if not path.exists():
            err = _build(path)
            if err is not None:
                _build_error = err
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _build_error = str(e)
            return None
        c_i64 = ctypes.c_int64
        c_fp = ctypes.POINTER(ctypes.c_float)
        lib.sz_ring_create.restype = ctypes.c_void_p
        lib.sz_ring_create.argtypes = [c_i64, c_i64]
        lib.sz_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.sz_ring_clock.restype = c_i64
        lib.sz_ring_clock.argtypes = [ctypes.c_void_p]
        lib.sz_ring_capacity.restype = c_i64
        lib.sz_ring_capacity.argtypes = [ctypes.c_void_p]
        lib.sz_ring_clear.argtypes = [ctypes.c_void_p]
        lib.sz_ring_seek.argtypes = [ctypes.c_void_p, c_i64]
        lib.sz_ring_write.argtypes = [ctypes.c_void_p, c_fp, c_i64]
        lib.sz_ring_read_at.restype = ctypes.c_int
        lib.sz_ring_read_at.argtypes = [ctypes.c_void_p, c_i64, c_fp, c_i64]
        lib.sz_ring_latest.restype = ctypes.c_int
        lib.sz_ring_latest.argtypes = [ctypes.c_void_p, c_fp, c_i64]
        lib.sz_frame_gather.restype = c_i64
        lib.sz_frame_gather.argtypes = [ctypes.c_void_p, c_i64, c_i64, ctypes.c_double, c_i64, c_fp]
        lib.sz_mix_accumulate.restype = ctypes.c_int
        lib.sz_mix_accumulate.argtypes = [ctypes.c_void_p, c_i64, c_i64, c_fp, c_i64]
        c_dbl = ctypes.c_double
        c_ip = ctypes.POINTER(c_i64)
        c_dp = ctypes.POINTER(c_dbl)
        lib.sz_pq_create.restype = ctypes.c_void_p
        lib.sz_pq_create.argtypes = [c_i64, c_i64, c_i64]
        lib.sz_pq_destroy.argtypes = [ctypes.c_void_p]
        lib.sz_pq_size.restype = c_i64
        lib.sz_pq_size.argtypes = [ctypes.c_void_p]
        lib.sz_pq_dropped.restype = c_i64
        lib.sz_pq_dropped.argtypes = [ctypes.c_void_p]
        lib.sz_pq_push.restype = ctypes.c_int
        lib.sz_pq_push.argtypes = [
            ctypes.c_void_p, c_fp, c_i64, c_i64, c_i64, c_dbl, c_i64, c_i64, c_i64,
        ]
        lib.sz_pq_pop.restype = ctypes.c_int
        lib.sz_pq_pop.argtypes = [ctypes.c_void_p, c_fp, c_ip, c_dp, c_i64]
        lib.sz_pq_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_build_error() -> Optional[str]:
    _load()
    return _build_error


def _fp(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeRingBuffer:
    """Drop-in native counterpart of stream.ring_buffer.RingBuffer."""

    def __init__(self, channels: int, capacity: int, dtype=np.float32):
        if dtype != np.float32:
            raise ValueError("native ring is float32 only")
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_build_error}")
        self._lib = lib
        self.channels = channels
        self.capacity = capacity
        self._handle = lib.sz_ring_create(channels, capacity)
        if not self._handle:
            raise RuntimeError("sz_ring_create failed")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.sz_ring_destroy(handle)
            self._handle = None

    @property
    def sample_clock(self) -> int:
        return int(self._lib.sz_ring_clock(self._handle))

    @property
    def valid_samples(self) -> int:
        return min(self.sample_clock, self.capacity)

    def clear(self) -> None:
        self._lib.sz_ring_clear(self._handle)

    def seek_to(self, clock: int) -> None:
        self._lib.sz_ring_seek(self._handle, int(clock))

    def write(self, block: np.ndarray) -> None:
        block = np.ascontiguousarray(block, np.float32)
        if block.ndim != 2 or block.shape[0] != self.channels:
            raise ValueError(f"expected [{self.channels}, n] block, got {block.shape}")
        self._lib.sz_ring_write(self._handle, _fp(block), block.shape[1])

    def latest(self, n: int, out: Optional[np.ndarray] = None) -> np.ndarray:
        if n > self.capacity:
            raise ValueError(f"window {n} exceeds capacity {self.capacity}")
        # a caller-supplied out buffer of the wrong shape/dtype would hand
        # the native writer an undersized raw pointer — heap corruption
        if (
            out is None
            or not out.flags.c_contiguous
            or out.shape != (self.channels, n)
            or out.dtype != np.float32
        ):
            out = np.empty((self.channels, n), np.float32)
        self._lib.sz_ring_latest(self._handle, _fp(out), n)
        return out

    def read_at(self, clock: int, n: int) -> np.ndarray:
        out = np.empty((self.channels, n), np.float32)
        rc = self._lib.sz_ring_read_at(self._handle, clock, _fp(out), n)
        if rc == -2:
            raise ValueError("cannot read the future")
        if rc == -1:
            raise ValueError("window no longer in the ring")
        return out

    def frame_gather(self, first_frame: int, num_frames: int, hop: float, window: int) -> np.ndarray:
        """Bulk batcher extraction: [emitted, channels, window]."""
        out = np.empty((num_frames, self.channels, window), np.float32)
        emitted = self._lib.sz_frame_gather(
            self._handle, first_frame, num_frames, float(hop), window, _fp(out)
        )
        return out[:emitted]

    def mix_accumulate(self, end_clock: int, src_channel: int, dst_row: np.ndarray) -> bool:
        """Accumulate one aligned channel window into dst_row; returns
        False when silence was contributed (scrolled out / bad channel)."""
        # hard checks, not assert (compiled out under -O): the native
        # accumulator writes n floats through this pointer
        if dst_row.dtype != np.float32 or not dst_row.flags.c_contiguous:
            raise ValueError("dst_row must be contiguous float32")
        rc = self._lib.sz_mix_accumulate(
            self._handle, end_clock, src_channel, _fp(dst_row), len(dst_row)
        )
        return rc == 0


class NativePacketQueue:
    """Blocking lock-free SPSC packet queue (readerwriterqueue analogue,
    ref: SURVEY.md §2.8/§2.9 — cpl CLockFreeDataQueue feeding the threaded
    AudioStream's consumer). Pushes are wait-free and allocation-free;
    pops block on a counting semaphore with a timeout."""

    def __init__(self, channels: int, max_samples: int, capacity: int = 256):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_build_error}")
        self._lib = lib
        self.channels = int(channels)
        self.max_samples = int(max_samples)
        self.capacity = int(capacity)
        self._handle = lib.sz_pq_create(channels, max_samples, capacity)
        if not self._handle:
            raise RuntimeError("sz_pq_create failed")
        # consumer-side preallocated buffers (single consumer by contract)
        self._out = np.empty((channels, max_samples), np.float32)
        self._meta = np.empty(6, np.int64)
        self._bpm = ctypes.c_double(0.0)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.sz_pq_destroy(handle)
            self._handle = None

    def push(self, block: np.ndarray, position: int, steady: int, bpm: float,
             playing: bool, end_clock: int = 0, generation: int = 0) -> bool:
        """Wait-free producer push; returns False when the queue was full
        (the packet is dropped and counted — the RT thread never blocks).
        ``end_clock``/``generation`` stamp the packet's last sample on the
        source ring's monotonic clock (see ListenerContext).

        The channel count must match the queue's: the native memcpy loop
        reads ``channels * n`` floats from the block pointer, so a
        narrower block (e.g. during a channel reconfigure racing the
        queue rebuild) would be an out-of-bounds read. Mismatches drop
        the packet instead."""
        block = np.ascontiguousarray(block, np.float32)
        if block.ndim != 2 or block.shape[0] != self._out.shape[0]:
            return False
        rc = self._lib.sz_pq_push(
            self._handle, _fp(block), block.shape[1],
            int(position), int(steady), float(bpm), int(bool(playing)),
            int(end_clock), int(generation),
        )
        return rc == 0

    def pop(self, timeout_ms: int = 100):
        """Blocking pop: (block [channels, n], position, steady, bpm,
        playing, end_clock, generation) or None on timeout; raises
        StopIteration once closed and drained."""
        rc = self._lib.sz_pq_pop(
            self._handle, _fp(self._out),
            self._meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.byref(self._bpm), int(timeout_ms),
        )
        if rc == -1:
            return None
        if rc == -2:
            raise StopIteration
        n = int(self._meta[0])
        return (
            self._out[:, :n].copy(),
            int(self._meta[1]),
            int(self._meta[2]),
            float(self._bpm.value),
            bool(self._meta[3]),
            int(self._meta[4]),
            int(self._meta[5]),
        )

    def close(self) -> None:
        self._lib.sz_pq_close(self._handle)

    @property
    def size(self) -> int:
        return int(self._lib.sz_pq_size(self._handle))

    @property
    def dropped(self) -> int:
        return int(self._lib.sz_pq_dropped(self._handle))
