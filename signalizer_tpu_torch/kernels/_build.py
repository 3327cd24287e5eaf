"""Build the port's CUDA kernels from ``signalizer_tpu_torch/csrc`` on first
use and load them with ``ctypes``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes). The library lands in ``build/signalizer_tpu_torch/`` beside
the package, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing file. Nothing here runs at
import: :func:`library` builds on its first call, and raises if ``nvcc`` is
missing or the build fails. :func:`launch` is the one caller of the C entries.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "signalizer_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argument types (every pointer and the stream as
# c_void_p, every int as c_int or c_longlong, every float as c_float; each
# returns its cudaError_t as an int)
SIGNATURES = {
    # frames, window, twiddles, out, batch, channels, window_size,
    # log2_n, mode, stream
    "sig_window_fft_mag": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # frames, window, twiddles, scratch, out, batch, channels, window_size,
    # log2_n, mode, stream
    "sig_window_fft_mag_long": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # frames, window, twiddles, out, batch, channels, window_size, log2_n,
    # mode, log2_cluster_size, stream
    "sig_window_fft_mag_cluster": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # mags, interp_indices, interp_weights, interp_mask, single_mask,
    # single_bin, chunk_lo, chunk_len, slope_map, decay_poles,
    # display_scalars, valid, state, out, pairs, T, K, rows, P, n_values,
    # taps, cluster, stream
    "sig_display_map": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # vals, slope_map, decay_poles, display_scalars, valid, state, out,
    # starts (or null), ends (or null), pairs, T, K, rows, P, frames_a_group,
    # groups, stream
    "sig_display_decay_db": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # mags, interp_indices, interp_weights, interp_mask, single_mask,
    # single_bin, chunk_lo, chunk_len, display_scalars, out, frames, rows,
    # P, n_values, taps, stream
    "sig_display_remap": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
    ),
    # x, pos, out, near (or null), B, R, W, P, a, kind, rotation (a host
    # array, or null unless lanczos), stream
    "sig_banded_resample": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    # x, start, step (or null), step_all, lo, hi, out, near (or null), B, R,
    # W, P, a, kind, rotation, stream
    "sig_banded_resample_affine": (
        _P, _P, _F, _F, _F, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
    ),
    # x, row_stride, valid (or null), state_in, holding_in, threshold (or
    # null), hysteresis (or null), thr2, hysteresis value, decay, state_out,
    # holding_out, fires, rows, W, first, stream
    "sig_peak_hold": (_P, _L, _P, _P, _P, _P, _P, _F, _F, _F, _P, _P, _P, _I, _I, _I, _P),
    # x, row_stride, state_in, holding_in, ages_in, threshold (or null),
    # hysteresis (or null), thr2, hysteresis value, decay, new_samples,
    # half_m1, hf, hf_m1, half_w, hf_minus_w, state_out, holding_out,
    # ages_out, found, start, rows, W, first, stream
    "sig_envelope_hold": (
        _P, _L, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _F, _F, _F, _F,
        _P, _P, _P, _P, _P, _I, _I, _I, _P,
    ),
    # x, row_stride, table, z_in, z_out, bands, rows, W, chunk, threads,
    # cluster, stream
    "sig_colour_split": (_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x (or bands), row_stride, bands_in, table, z_in (or null), z_out (or
    # null), smooth_in, smooth_out, band_colours, key, key_pair_stride,
    # key_row_stride, rows_per_pair, blend (or null), blend value, colours,
    # rows, W, chunk, threads, cluster, stream
    "sig_colour_track": (
        _P, _L, _I, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _P, _F, _P, _I, _I, _I, _I, _I, _P,
    ),
    # mags, mags_stride, offsets, offs_stride, threshold (or null),
    # hysteresis (or null), thr value, inv_h value, iq value, qs, n,
    # hist_in (or null), index, value, offset, hist_out (or null), passes,
    # rows, m, stream
    "sig_spectral_walk": (
        _P, _L, _P, _L, _P, _P, _F, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P, _I, _I, _P,
    ),
    # spec, spec_stride, threshold (or null), hysteresis (or null), thr
    # value, inv_h value, iq value, qs, n, hist_in (or null), index, value,
    # offset, hist_out (or null), passes, rows, m, stream
    "sig_spectral_walk_spectrum": (
        _P, _L, _P, _P, _F, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P, _I, _I, _P,
    ),
    # vals, slope_map, decay_poles, phase_poles, display_scalars, valid (or
    # null), magnitude, phase, out, starts (or null), pairs, T, K, rows, P,
    # chunk_frames, stream
    "sig_phase_decay_db": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # state, drives, decay_re, decay_im, valid (or null), combine, gain,
    # state_out, re, im, mag, readouts (or null), B, T, P, V, decay_stride,
    # stream
    "sig_resonator_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, x's pair, row and pixel strides, colours, tables, bounds, out,
    # pairs, T, P, S, stream
    "sig_colormap": (_P, _L, _L, _L, _P, _I, _P, _P, _I, _I, _I, _I, _P),
    # spec, interp_indices, interp_weights, interp_mask, single_mask,
    # single_bin, chunk_lo, chunk_len, display_scalars, out, frames, P,
    # n_values, taps, longest chunk, stream
    "sig_phase_values": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

# what the last build in this process printed and how long it took
build_info = {"seconds": None, "log": "", "path": None}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``, or ``nvcc``
    on ``PATH``; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the "
            "CUDA toolkit is needed to build signalizer_tpu_torch/csrc"
        )
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = BUILD_DIR / f"libsignalizer_tpu_torch_{_digest()}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.tmp"
    cu = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in cu]
    t0 = time.perf_counter()
    compiles = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(cu, objs)
    ]
    logs = [p.communicate()[0] for p in compiles]
    failed = [p.returncode for p in compiles if p.returncode != 0]
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        logs.append(link.stdout + link.stderr)
        failed = [link.returncode] if link.returncode != 0 else []
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = "".join(logs)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_info['log']}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path = build()
    build_info["path"] = str(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sig_error_string.argtypes = (ctypes.c_int,)
    lib.sig_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().sig_error_string(err).decode()
        raise RuntimeError(f"{name} failed: cudaError_t {err} ({msg})")


def launch(entry: str, device: torch.device, *args, name: str) -> None:
    """Call the C entry ``entry`` with ``args`` and ``device``'s current
    stream appended, on ``device`` (made current only when it is not), and
    raise through :func:`check` as ``name``. torch's private accessor gives
    the stream without building a Stream object (~2.6 us less a launch);
    where a torch version lacks it, the public one does."""
    index, raw = device.index, getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream
    fn = getattr(library(), entry)
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    check(err, name)
