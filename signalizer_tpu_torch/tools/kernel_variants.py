"""Time other versions of kernels A to H against the package's own, on
one GPU, at the shapes the main paths give them.

    python -m signalizer_tpu_torch.tools.kernel_variants [NAME=DIR ...]
        [--kernels abcdefghlrt] [--named VARIANT ...] [--flat-twiddles NAME ...]
        [--wrapper] [--out FILE]

Each ``DIR`` holds another version of ``window_fft_mag.cu``,
``display_map.cu``, ``banded_resample.cu`` and/or
``window_fft_mag_cluster.cu`` with the same C entry points
(``sig_window_fft_mag``, ``sig_display_map``, ``sig_banded_resample``,
``sig_window_fft_mag_cluster``): an earlier revision unpacked with
``git show``, or a copy with one thing changed to see what it costs. A file
a directory lacks comes from ``signalizer_tpu_torch/csrc`` (headers too).
Every version is built with the package's ``nvcc`` flags into its own
library under ``build/kernel_variants/`` and timed in turns with the
package's kernels (``repo``): all versions in order, then in reverse order,
so that drift of the card shows as a difference between the two rounds.
``--kernels`` picks which kernels are timed (any of ``a``, ``b``, ``c``,
``d``, ``e``, ``f``, ``g``, ``h``, ``l``, ``r``, ``t``; the default is ``abc``). ``--named`` adds versions kept
in ``signalizer_tpu_torch/tools/variants/`` (``NAMED_VARIANTS``): the
earlier two-pass form (``long_v1``, entry ``sig_window_fft_mag_long_v1``),
the package's two-pass form with its pass-2 block size and waves as
arguments (``long_general``, entry ``sig_window_fft_mag_long_general``) and the
earlier decay-and-dB kernel (``decay_db_v1``, entry
``sig_display_decay_db_v1``), the earlier ones also with one part left out
(the outputs are then wrong; the time shows what the part costs), and
kernel D with its step as a C++ select (``peak_hold_cpp_select``, the
package's entries, timed with ``--kernels h``), and kernel E's measured
designs (``--kernels e``): its first (``colour_v1``: a block scan a
recurrence), the one before its reciprocal normalisation (``colour_v2``;
``colour_v2_no_mix``, ``_no_scans``, ``_no_fixup`` with one part left out,
``colour_v2_chunk8`` with 8 samples a thread), a whole row a tile
(``colour_row``) and one block of 512 threads a row (``colour_v3``, the
design before the row was split across a cluster); and kernel G's first design
(``phase_decay_db_v1``: a thread per 4 pixels mapping every frame itself),
second (``phase_decay_db_v2``: R helper threads a pixel, a branch a
frame) and third (``phase_decay_db_v3``: the helpers with a branch-free
ring, before the walk-then-map layout; ``--kernels g``).
``--flat-twiddles``
names versions of kernel A that read the flat ``exp(-2*pi*i*k/N)``, k < N/2
table instead of the stage-ordered one. A version of kernel C without the
entry ``sig_banded_resample_affine`` is called with the first revision's
arguments (no rotation table); one whose affine entry still takes a per-pair
``step`` pointer (the revisions before the session's) gets a null one.

A time is the device time of one launch: a CUDA graph of back-to-back
launches (no host gaps between them), timed with CUDA events, median of 9
replays. Kernels A and B run at the Spectrum headline: 16 pairs x 128 frames
(and x 1 frame, the per-tick call), a 4096-point window, SEPARATE stereo,
LINEAR interpolation, a LOGARITHMIC axis of 1024 pixels, 2 line graphs.
Kernel A's cluster form (``l``) runs on rows of the engine's default
48000-sample history, N = 65536, SEPARATE: 16 pairs x 16 frames (512 rows)
and the live tick's 8 pairs x 1 frame (16 rows), with 2, 4 and 8 blocks a
cluster each (``l_t16_s8_us`` ...). Kernel A's two-pass form (``t``) runs
at four shapes (``TWO_PASS_SHAPES``): the Spectrum's 16 pairs of 200000
samples (N = 262144, its main path), the cluster form's 16 x 16 x 48000
(N = 65536) and one pair at N = 2^20 and 2^21, with ``torch.fft.rfft`` of
the already windowed rows beside it; ``long_general`` with every pass-2 block
size R of 8, 16 and 32 that fits (``t_n262144_r8_us`` ...) and, at
N = 262144, in waves of 16 and 8 rows. The decay-and-dB entry (``d``) runs
at the headline's remapped values (16 pairs x 128 frames x 2 rows x 1024 px,
2 line graphs), at T = 1 and at the spectrogram's cfg4 (1 pair x 512 frames
x 1 row, the last 3 frames invalid). Kernel D (``h``, ``peak_hold.cu``)
runs at cfg3's tick (16 rows, 1600 of 2048 samples consumed) and at 16 x
8192, its function entry and, where a version has it, its fused entry
(``h_cfg3_tick_fused_us`` ...). Kernel E (``e``, ``colour_track.cu``) runs
its fused entry (x to colours, both states carried in) at cfg3's 16 pairs x
2 rows x 16384 samples, a coloured session's 1 pair x 2 rows x 16384 and 3
pairs x 2 rows x 3001, each version with the host table of its own chunk
length (its source's ``kChunk``, or ``-DSIG_CHUNK``) and layout; the
package's with ``colour_plan``'s cluster and with the sizes of
``COLOUR_CLUSTERS`` (``e_cfg3_c4_us`` ...). Kernel F (``f``, ``spectral_walk.cu``) runs at cfg3b's 16 lookaheads
of 8192 samples (4094 candidate bins each) and at one: a version's spectrum
entry on the rfft (``f_cfg3b_spectrum_us``; unfiltered ``_spectrum_walk_us``), its bins
entry on ``spectral_bins``' magnitudes and offsets (``f_cfg3b_us``;
unfiltered ``_walk_us``; after the torch operations that form them, in one
graph, ``_with_tail_us``), each output held against the plain version, and
each route with the rfft before it as the main path runs it
(``f_cfg3b_rfft_spectrum_us``, ``f_cfg3b_rfft_with_tail_us``); a
line after the rounds gives those torch operations alone
(``f_cfg3b_tail_us``) and their kernels' device µs and launches from the
profiler. ``--named
spectral_walk_v1`` is the first design (bins entry only),
``spectral_walk_v1_load_only`` and ``_one_pass`` the same with no pass or
at most one. Kernel G (``g``,
``phase_decay_db.cu``) runs at the headline in PHASE (16 pairs x 128
frames and x 1, 2 line graphs, 1024 px) and at the spectrogram's cfg4 (1
pair x 512 frames, the last 3 invalid), with the wrapper's ``phase_plan``
and with T in chunks of 32, 64 and 128 frames or one chunk
(``g_cfg4_f32_us`` ...); the designs with helper threads with their
helpers a pixel and with each of 1, 2, 4 and 8 (``g_headline_r4_us``
...); kernel H (``r``,
``resonator_scan.cu``) at the cfg6 backlog (32 banks x 16 chunks of 512,
1024 px, the last 3 invalid; with and without a readout a chunk) and
tick (one chunk of 800). Kernel C runs at three shapes of the
oscilloscope, all 16 pairs over a 16384-sample history: ``cfg3`` (Lanczos
a = 10 with the nearest pick, 2 rows, a 1024-sample window over 8192 px),
``colour`` (the colour track's nearest pick, 6 rows, the same positions) and
``zoom_out`` (Lanczos a = 10, 2 rows, the whole history over 1024 px, step
~16); a version with the
affine entry is also timed forming cfg3's positions itself
(``c_cfg3_affine_us``). Each version's output is held against the package's
kernels (largest absolute difference; kernel A relative to each row's peak).

``--wrapper`` adds host-clock times of kernel C's Python wrapper at cfg3,
microseconds per call over 2000 calls queued back to back and one
synchronize: the package's two entries, the position tensor formed by torch
operations and handed to the ``pos`` entry, the parts a wrapper is made of
(argument checks, an allocation, the device context, the stream lookup by
a Stream object and by the raw handle, the two output views, the bare ctypes
call), and the wrapper of every version whose directory holds
its own ``banded_resample.py``, run against that version's library. With
``--kernels e`` it adds the same for kernel E's wrapper ``colour_track`` at
cfg3 and 1 x 2 x 16384, the package's and each version's own
``colour_track.py`` in turns, and the plan's lookup alone.

Prints one JSON line per version and round, after the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from signalizer_tpu_torch import BinInterpolation, SpectrumChannels, ViewScaling
from signalizer_tpu_torch.core.constant import make_spectrum_constant
from signalizer_tpu_torch.kernels import _build
from signalizer_tpu_torch.kernels import banded_resample as br
from signalizer_tpu_torch.kernels import colour_track as ct
from signalizer_tpu_torch.kernels import display_map as dm
from signalizer_tpu_torch.kernels import window_fft_mag as wfm

PAIRS, FRAMES, WINDOW, PIXELS = 16, 128, 4096, 1024
KERNEL_SOURCES = {
    "a": "window_fft_mag.cu", "b": "display_map.cu", "c": "banded_resample.cu", "d": "display_decay_db.cu",
    "l": "window_fft_mag_cluster.cu", "t": "window_fft_mag_long.cu", "h": "peak_hold.cu",
    "e": "colour_track.cu", "f": "spectral_walk.cu", "g": "phase_decay_db.cu", "r": "resonator_scan.cu",
}
VARIANTS_DIR = Path(__file__).resolve().parent / "variants"
# versions kept beside the tool: name -> (source in VARIANTS_DIR, nvcc defines)
NAMED_VARIANTS = {
    "long_v1": ("window_fft_mag_long_v1.cu", ()),
    "long_v1_no_pass2_stores": ("window_fft_mag_long_v1.cu", ("-DSIG_DROP_STORES",)),
    "long_general": ("window_fft_mag_long_general.cu", ()),
    "decay_db_v1": ("display_decay_db_v1.cu", ()),
    "decay_db_v1_no_loads": ("display_decay_db_v1.cu", ("-DSIG_DROP_LOADS",)),
    "decay_db_v1_no_db": ("display_decay_db_v1.cu", ("-DSIG_DROP_DB",)),
    "decay_db_v1_no_fold": ("display_decay_db_v1.cu", ("-DSIG_DROP_FOLD",)),
    "peak_hold_cpp_select": ("peak_hold_cpp_select.cu", ()),
    "colour_v1": ("colour_track_v1.cu", ()),
    "colour_v2": ("colour_track_v2.cu", ()),
    "colour_v2_no_mix": ("colour_track_v2.cu", ("-DSIG_DROP_MIX",)),
    "colour_v2_no_scans": ("colour_track_v2.cu", ("-DSIG_DROP_SCANS",)),
    "colour_v2_no_fixup": ("colour_track_v2.cu", ("-DSIG_DROP_FIXUP",)),
    "colour_v2_chunk8": ("colour_track_v2.cu", ("-DSIG_CHUNK=8",)),
    "colour_row": ("colour_track_row.cu", ()),
    "colour_v3": ("colour_track_v3.cu", ()),
    "phase_decay_db_v1": ("phase_decay_db_v1.cu", ()),
    "phase_decay_db_v2": ("phase_decay_db_v2.cu", ()),
    "phase_decay_db_v3": ("phase_decay_db_v3.cu", ()),
    "spectral_walk_v1": ("spectral_walk_v1.cu", ()),
    "spectral_walk_v1_load_only": ("spectral_walk_v1.cu", ("-DSIG_LOAD_ONLY",)),
    "spectral_walk_v1_one_pass": ("spectral_walk_v1.cu", ("-DSIG_ONE_PASS",)),
}
# the most shared memory a block may opt in to on sm_90 (long_general's R fits it)
MAX_SHARED_BYTES = 232448
# kernel A's two-pass form: pairs, frames, window samples
TWO_PASS_SHAPES = {
    "n262144": (16, 1, 200_000), "n65536_t16": (16, 16, 48_000), "n1048576": (1, 1, 1 << 20),
    "n2097152": (1, 1, 1 << 21),
}
# kernel D: rows, W, samples consumed (cfg3's tick in its 2048-sample
# bucket, and the whole 8192-sample lookahead)
HOLD_SHAPES = {"cfg3_tick": (16, 2048, 1600), "cfg3_lookahead": (16, 8192, 8192)}
# kernel E: pairs, rows, W (cfg3, a coloured session's one pair, and a
# short row no multiple of a tile)
COLOUR_SHAPES = {"cfg3": (16, 2, 16384), "session": (1, 2, 16384), "w3001": (3, 2, 3001)}
# kernel E's cluster sizes timed beside the plan's, by shape
COLOUR_CLUSTERS = {"cfg3": (2, 4, 16), "session": (4, 16), "w3001": (2, 6)}
# kernel F: rows of 8192-sample lookaheads (cfg3b's 16 pairs, and one)
WALK_SHAPES = {"cfg3b": 16, "1x4094": 1}
WALK_N = 8192
# the decay-and-dB entry: pairs, T, rows, last invalid frames
DECAY_SHAPES = {"headline": (16, 128, 2, 0), "t1": (16, 1, 2, 0), "cfg4": (1, 512, 1, 3)}
LONG_WINDOW, LONG_FRAMES, LIVE_PAIRS = 48_000, 16, 8
OSC_HISTORY = 16384
# kernel C's shapes: kind, a, with_nearest, rows, pixels, step
RESAMPLE_SHAPES = {
    "cfg3": ("lanczos", 10, True, 2, 8192, 1023.0 / 8191),
    "colour": ("nearest", 1, False, 6, 8192, 1023.0 / 8191),
    "zoom_out": ("lanczos", 10, False, 2, 1024, (OSC_HISTORY - 1.0) / 1023),
}
# each kind's position clip range (kernels/oscilloscope.py), by a and W
CLIP = {
    "lanczos": lambda a, w: (-(a + 1.0), w - 1.0 + a),
    "nearest": lambda a, w: (-1.0, float(w)),
}
# sig_banded_resample as the first revision took it: no rotation table
RESAMPLE_V1 = _build.SIGNATURES["sig_banded_resample"][:-2] + (ctypes.c_void_p,)
# sig_banded_resample_affine as the revisions up to the session's took it: a
# per-pair step pointer (passed null) before the host step
AFFINE_STEP_POINTER = (
    _build.SIGNATURES["sig_banded_resample_affine"][:2] + (ctypes.c_void_p,)
    + _build.SIGNATURES["sig_banded_resample_affine"][2:]
)
# the versions whose affine entry takes that pointer, by name
_affine_step_pointer = set()
# kernel E's and G's entries as their earlier designs took them: E a row a
# block (no cluster argument), G with R helper threads a pixel (no start
# scratch, no chunk length)
COLOUR_ONE_BLOCK = {
    "sig_colour_split": _build.SIGNATURES["sig_colour_split"][:-2] + (ctypes.c_void_p,),
    "sig_colour_track": _build.SIGNATURES["sig_colour_track"][:-2] + (ctypes.c_void_p,),
}
PHASE_HELPERS = _build.SIGNATURES["sig_phase_decay_db"][:9] + _build.SIGNATURES["sig_phase_decay_db"][10:]
# the versions built with those entries, by name
_colour_one_block, _phase_helpers = set(), set()
# the named variants' entries: the arguments their kernels took then
_P, _I = ctypes.c_void_p, ctypes.c_int
V1_SIGNATURES = {
    "sig_window_fft_mag_long_v1": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "sig_window_fft_mag_long_general": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "sig_display_decay_db_v1": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "sig_phase_decay_db_v1": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}
# kernel G: pairs, T, last invalid frames (the headline in PHASE at T = 128
# and 1, the spectrogram's cfg4 in PHASE), 2 line graphs over 1024 px
PHASE_SHAPES = {"headline": (16, 128, 0), "t1": (16, 1, 0), "cfg4": (1, 512, 3)}
# kernel H: banks (pairs x rows), chunks, last invalid chunks, readouts
# after every chunk (the cfg6 backlog and tick, 16 pairs x 2 rows, 1024 px,
# a Hann window's 3 vectors)
SCAN_SHAPES = {"cfg6_backlog": (32, 16, 3, False), "cfg6_backlog_readouts": (32, 16, 3, True),
               "cfg6_tick": (32, 1, 0, False)}


def build(name: str, directory: Path, kernels, sources=None, defines=()) -> ctypes.CDLL:
    """Compile the picked kernels of one version (or the given ``sources``)
    into their own library."""
    out_dir = _build.BUILD_DIR.parent / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    if sources is None:
        files = [f for k, f in KERNEL_SOURCES.items() if k in kernels]
        sources = [directory / f if (directory / f).is_file() else _build.CSRC / f for f in files]
    out = out_dir / f"{name}.so"
    done = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC), "-shared", "-o", str(out),
         *map(str, sources)],
        capture_output=True, text=True,
    )
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"# {name}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    signatures = dict(_build.SIGNATURES, **V1_SIGNATURES)
    if not hasattr(lib, "sig_banded_resample_affine"):
        signatures["sig_banded_resample"] = RESAMPLE_V1
    elif any(Path(f).name == "banded_resample.cu" and "const float* step;" in Path(f).read_text() for f in sources):
        signatures["sig_banded_resample_affine"] = AFFINE_STEP_POINTER
        _affine_step_pointer.add(name)
    texts = {Path(f).name: Path(f).read_text() for f in sources}
    if any(n.startswith("colour_track") and "int cluster," not in t for n, t in texts.items()):
        signatures.update(COLOUR_ONE_BLOCK)
        _colour_one_block.add(name)
    if any(n.startswith("phase_decay_db") and "int helpers" in t for n, t in texts.items()):
        signatures["sig_phase_decay_db"] = PHASE_HELPERS
        _phase_helpers.add(name)
    for entry, argtypes in signatures.items():
        if hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def device_us(fn, launches: int) -> float:
    """Device microseconds per launch of ``fn``: ``launches`` of them
    captured back to back in a CUDA graph, median of 9 timed replays."""
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(launches):
                fn()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(9):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / launches * 1e3


def host_us(fn, calls: int = 2000) -> float:
    """Host microseconds per call of ``fn``: ``calls`` of them back to back
    on the host clock, ending in one synchronize."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


class Spectrum:
    """Kernels A and B at the headline shape."""

    def __init__(self, libs, dev, flat_twiddles):
        self.libs, self.flat_names = libs, flat_twiddles
        self.c = c = make_spectrum_constant(
            device=dev, axis_points=PIXELS, window_size=WINDOW, sample_rate=48_000.0,
            configuration=SpectrumChannels.SEPARATE, bin_interpolation=BinInterpolation.LINEAR,
            view_scaling=ViewScaling.LOGARITHMIC,
        )
        k = np.arange(WINDOW // 2, dtype=np.float64)
        ang = -2.0 * np.pi * k / WINDOW
        self.flat = torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)).to(dev)
        rng = np.random.default_rng(10)
        self.frames = torch.from_numpy(
            (rng.standard_normal((PAIRS, FRAMES, 2, WINDOW)) * 0.3).astype(np.float32)
        ).to(dev)
        self.state0 = torch.from_numpy((rng.random((PAIRS, 2, 2, PIXELS)) * 0.5).astype(np.float32)).to(dev)
        nv = c.n_spectrum_values
        self.mags = {t: torch.empty((PAIRS, t, 2, nv), device=dev) for t in (FRAMES, 1)}
        self.shown = {t: torch.empty((PAIRS, t, 2, 2, PIXELS), device=dev) for t in (FRAMES, 1)}
        # frames[:, :1] is not what a T = 1 call reads: kernel A takes the first
        # PAIRS frames of the tensor, which is as much work
        self.kernel_a("repo", FRAMES, self.mags[FRAMES])
        self.kernel_a("repo", 1, self.mags[1])
        state = self.state0.clone()
        self.kernel_b("repo", self.mags[FRAMES], state, self.shown[FRAMES])
        torch.cuda.synchronize()
        self.want = self.mags[FRAMES].clone(), self.shown[FRAMES].clone(), state.clone()

    def kernel_a(self, name, t, out):
        c = self.c
        err = self.libs[name].sig_window_fft_mag(
            self.frames.data_ptr(), c.window_kernel.data_ptr(),
            (self.flat if name in self.flat_names else c.fft_twiddles).data_ptr(), out.data_ptr(),
            PAIRS * t, 2, WINDOW, WINDOW.bit_length() - 1, int(c.configuration),
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(err, f"{name}: window_fft_mag")

    def kernel_b(self, name, mags, state, out):
        c = self.c
        err = self.libs[name].sig_display_map(
            mags.data_ptr(), c.interp_indices.data_ptr(), c.interp_weights.data_ptr(),
            c.interp_mask.data_ptr(), c.single_mask.data_ptr(), c.single_bin.data_ptr(),
            c.chunk_lo.data_ptr(), c.chunk_len.data_ptr(), c.slope_map.data_ptr(),
            c.decay_poles.data_ptr(), c.display_scalars.data_ptr(), None, state.data_ptr(),
            out.data_ptr(), PAIRS, mags.shape[1], 2, 2, PIXELS, c.n_spectrum_values, c.interp_taps,
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(err, f"{name}: display_map")

    def measure(self, name, kernels) -> dict:
        want_mags, want_shown, want_state = self.want
        mags, shown = self.mags, self.shown
        line = {}
        state = self.state0.clone()
        if "a" in kernels:
            got = torch.empty_like(want_mags)
            self.kernel_a(name, FRAMES, got)
            torch.cuda.synchronize()
            peak = want_mags.abs().amax(-1).clamp(min=1e-30)
            line["a_row_rel_diff_vs_repo"] = float(((got - want_mags).abs().amax(-1) / peak).max())
            line["a_t128_us"] = device_us(lambda: self.kernel_a(name, FRAMES, mags[FRAMES]), 10)
            line["a_t1_us"] = device_us(lambda: self.kernel_a(name, 1, mags[1]), 50)
        if "b" in kernels:
            # compare this first launch's outputs before the timed launches
            # move the state on
            self.kernel_b(name, want_mags, state, shown[FRAMES])
            torch.cuda.synchronize()
            line["b_max_abs_diff_vs_repo"] = float((shown[FRAMES] - want_shown).abs().max())
            line["b_state_equal_repo"] = bool(torch.equal(state, want_state))
            line["b_t128_us"] = device_us(lambda: self.kernel_b(name, want_mags, state, shown[FRAMES]), 10)
            line["b_t1_us"] = device_us(lambda: self.kernel_b(name, mags[1], state, shown[1]), 50)
        return line


class LongRows:
    """Kernel A's cluster form on rows of 48000 samples, N = 65536: the
    timed shape (16 pairs x 16 frames) and the live tick (8 pairs x 1)."""

    def __init__(self, libs, dev):
        self.libs = libs
        self.c = make_spectrum_constant(
            device=dev, axis_points=PIXELS, window_size=LONG_WINDOW, sample_rate=48_000.0,
            configuration=SpectrumChannels.SEPARATE, bin_interpolation=BinInterpolation.LINEAR,
            view_scaling=ViewScaling.LOGARITHMIC,
        )
        rng = np.random.default_rng(40)
        self.frames = torch.from_numpy(
            (rng.standard_normal((PAIRS, LONG_FRAMES, 2, LONG_WINDOW)) * 0.3).astype(np.float32)
        ).to(dev)
        self.out = torch.empty((PAIRS * LONG_FRAMES, 2, self.c.n_spectrum_values), device=dev)
        self.launch("repo", PAIRS * LONG_FRAMES, 3)
        torch.cuda.synchronize()
        self.want = self.out.clone()

    def launch(self, name, batch, log2s):
        c = self.c
        err = self.libs[name].sig_window_fft_mag_cluster(
            self.frames.data_ptr(), c.window_kernel.data_ptr(), c.fft_twiddles.data_ptr(), self.out.data_ptr(),
            batch, 2, LONG_WINDOW, c.transform_size.bit_length() - 1, int(c.configuration), log2s,
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(err, f"{name}: window_fft_mag_cluster")

    def measure(self, name) -> dict:
        line = {}
        peak = self.want.abs().amax(-1).clamp(min=1e-30)
        for log2s in (1, 2, 3):
            self.out.zero_()
            self.launch(name, PAIRS * LONG_FRAMES, log2s)
            torch.cuda.synchronize()
            diff = float(((self.out - self.want).abs().amax(-1) / peak).max())
            line[f"l_s{1 << log2s}_row_rel_diff_vs_repo"] = diff
            line[f"l_t16_s{1 << log2s}_us"] = device_us(lambda: self.launch(name, PAIRS * LONG_FRAMES, log2s), 10)
            line[f"l_live_s{1 << log2s}_us"] = device_us(lambda: self.launch(name, LIVE_PAIRS, log2s), 50)
        return line


def _windowed(c, frames):
    """Rows already packed and windowed for ``torch.fft.rfft`` (SEPARATE)."""
    return frames * c.window_kernel


class TwoPass:
    """Kernel A's two-pass form at TWO_PASS_SHAPES, through its C entries."""

    def __init__(self, libs, dev):
        self.libs, self.cases = libs, {}
        for shape, (pairs, t, window) in TWO_PASS_SHAPES.items():
            c = make_spectrum_constant(
                device=dev, axis_points=PIXELS, window_size=window, sample_rate=48_000.0,
                configuration=SpectrumChannels.SEPARATE, bin_interpolation=BinInterpolation.LINEAR,
                view_scaling=ViewScaling.LOGARITHMIC,
            )
            rng = np.random.default_rng(50 + t)
            frames = torch.from_numpy((rng.standard_normal((pairs, t, 2, window)) * 0.3).astype(np.float32)).to(dev)
            l1, l2 = wfm.long_core(c)
            case = types.SimpleNamespace(
                c=c, frames=frames, batch=pairs * t, rows=pairs * t * 2, l1=l1, l2=l2,
                out=torch.empty(wfm.out_shape(c, (pairs, t)), device=dev),
                scratch=torch.empty((pairs * t * 2, l1 * l2, 2), device=dev),
                want=wfm.window_fft_mag_plain(c, frames),
            )
            self.cases[shape] = case
        self.rfft_done = False

    def launch(self, name, case, r=8, wave=0):
        """One call of a version's entry; ``long_general`` with R rows a pass-2
        block, in waves of ``wave`` rows (0: all at once)."""
        lib, c, stream = self.libs[name], case.c, torch.cuda.current_stream().cuda_stream
        head = (case.frames.data_ptr(), c.window_kernel.data_ptr(), c.fft_twiddles.data_ptr(),
                case.scratch.data_ptr(), case.out.data_ptr(), case.batch, 2, c.window_size,
                c.transform_size.bit_length() - 1, int(c.configuration))
        if hasattr(lib, "sig_window_fft_mag_long_v1"):
            err = lib.sig_window_fft_mag_long_v1(*head, stream)
        elif hasattr(lib, "sig_window_fft_mag_long_general"):
            err = lib.sig_window_fft_mag_long_general(*head, r.bit_length() - 1, wave, stream)
        else:
            err = lib.sig_window_fft_mag_long(*head, stream)
        _build.check(err, f"{name}: window_fft_mag_long")

    def rows_a_block(self, case):
        """Every R of 8, 16, 32 that long_general's pass-2 block takes."""
        return [r for r in (8, 16, 32) if 2 * r <= case.l1 and (2 * r + 1) * (case.l2 + 1) * 8 <= MAX_SHARED_BYTES]

    def measure(self, name) -> dict:
        line = {}
        general = hasattr(self.libs[name], "sig_window_fft_mag_long_general")
        for shape, case in self.cases.items():
            case.out.zero_()
            self.launch(name, case)
            torch.cuda.synchronize()
            peak = case.want.abs().amax(-1).clamp(min=1e-30)
            line[f"t_{shape}_row_rel_err"] = float(((case.out - case.want).abs().amax(-1) / peak).max())
            reps = 10 if case.rows > 8 else 40
            line[f"t_{shape}_us"] = device_us(lambda: self.launch(name, case), reps)
            if not self.rfft_done:
                rows = _windowed(case.c, case.frames)
                line[f"t_{shape}_rfft_us"] = device_us(
                    lambda: torch.fft.rfft(rows, n=case.c.transform_size, dim=-1), reps)
                del rows
            if not general:
                continue
            for r in self.rows_a_block(case):
                line[f"t_{shape}_r{r}_us"] = device_us(lambda: self.launch(name, case, r=r), reps)
            if shape == "n262144":
                for wave in (16, 8):
                    case.out.zero_()
                    self.launch(name, case, wave=wave)
                    torch.cuda.synchronize()
                    line[f"t_{shape}_wave{wave}_row_rel_err"] = float(
                        ((case.out - case.want).abs().amax(-1) / peak).max())
                    line[f"t_{shape}_wave{wave}_us"] = device_us(lambda: self.launch(name, case, wave=wave), reps)
        self.rfft_done = True
        return line


class DecayDb:
    """The decay-and-dB entry at DECAY_SHAPES, through its C entries."""

    def __init__(self, libs, dev):
        self.libs, self.cases = libs, {}
        c = make_spectrum_constant(
            device=dev, axis_points=PIXELS, window_size=WINDOW, sample_rate=48_000.0,
            configuration=SpectrumChannels.SEPARATE, bin_interpolation=BinInterpolation.LINEAR,
            view_scaling=ViewScaling.LOGARITHMIC,
        )
        self.c, self.sms = c, torch.cuda.get_device_properties(dev).multi_processor_count
        rng = np.random.default_rng(60)
        for shape, (pairs, t, rows, invalid) in DECAY_SHAPES.items():
            valid = None
            if invalid:
                mask = np.ones(t, bool)
                mask[-invalid:] = False
                valid = torch.from_numpy(mask).to(dev)
            k = c.num_line_graphs
            frames, groups, chunks = dm.decay_db_plan(pairs, t, k, rows, PIXELS, self.sms)
            groups_in_t = -(-t // frames)
            case = types.SimpleNamespace(
                pairs=pairs, t=t, rows=rows, k=k, valid=valid, plan=(frames, groups),
                starts=torch.empty((pairs, groups_in_t, k, rows, PIXELS), device=dev) if groups_in_t > 1 else None,
                vals=torch.from_numpy((np.abs(rng.standard_normal((pairs, t, rows, PIXELS))) * 0.3)
                                      .astype(np.float32)).to(dev),
                state0=torch.from_numpy((rng.random((pairs, k, rows, PIXELS)) * 0.5).astype(np.float32)).to(dev),
                out=torch.empty((pairs, t, k, rows, PIXELS), device=dev),
                ends=torch.empty((chunks, pairs, k, rows, PIXELS), device=dev) if chunks > 1 else None,
            )
            case.state = case.state0.clone()
            self.cases[shape] = case
            self.launch("repo", case)
            torch.cuda.synchronize()
            case.want_out, case.want_state = case.out.clone(), case.state.clone()

    def launch(self, name, case):
        lib, c, stream = self.libs[name], self.c, torch.cuda.current_stream().cuda_stream
        head = (case.vals.data_ptr(), c.slope_map.data_ptr(), c.decay_poles.data_ptr(), c.display_scalars.data_ptr(),
                None if case.valid is None else case.valid.data_ptr(), case.state.data_ptr(), case.out.data_ptr())
        tail = (case.pairs, case.t, case.k, case.rows, PIXELS)
        if hasattr(lib, "sig_display_decay_db_v1"):
            err = lib.sig_display_decay_db_v1(*head, *tail, stream)
        else:
            scratch = (None if x is None else x.data_ptr() for x in (case.starts, case.ends))
            err = lib.sig_display_decay_db(*head, *scratch, *tail, *case.plan, stream)
        _build.check(err, f"{name}: display_decay_db")

    def measure(self, name) -> dict:
        line = {}
        for shape, case in self.cases.items():
            case.state.copy_(case.state0)
            self.launch(name, case)
            torch.cuda.synchronize()
            line[f"d_{shape}_max_abs_diff_vs_repo"] = float((case.out - case.want_out).abs().max())
            line[f"d_{shape}_state_equal_repo"] = bool(torch.equal(case.state, case.want_state))
            line[f"d_{shape}_us"] = device_us(lambda: self.launch(name, case), 10 if case.t > 1 else 50)
        return line


class PeakHold:
    """Kernel D at HOLD_SHAPES through its C entries: the function entry
    (``sig_peak_hold``) and, where a version has it, the fused entry
    (``sig_envelope_hold``, the queue at cfg3's window and history)."""

    def __init__(self, libs, dev):
        self.libs, self.cases = libs, {}
        rng = np.random.default_rng(70)
        for shape, (rows, w, consumed) in HOLD_SHAPES.items():
            t = np.arange(w)
            env = 0.55 + 0.45 * np.sin(2 * np.pi * t / (w / 3.0) + rng.uniform(0, 6.3, (rows, 1)))
            x = torch.from_numpy((env * rng.standard_normal((rows, w))).astype(np.float32)).to(dev)
            case = types.SimpleNamespace(
                rows=rows, w=w, first=w - consumed, consumed=consumed, x=x,
                state=torch.full((rows,), 0.01, device=dev), holding=torch.zeros(rows, dtype=torch.bool, device=dev),
                ages=torch.full((rows, 8), 1e9, device=dev), fires=torch.empty((rows, w), dtype=torch.bool, device=dev),
                state_out=torch.empty(rows, device=dev), holding_out=torch.empty(rows, dtype=torch.bool, device=dev),
                ages_out=torch.empty((rows, 8), device=dev), found=torch.empty(rows, dtype=torch.bool, device=dev),
                start=torch.empty(rows, device=dev),
            )
            self.cases[shape] = case
            self.launch("repo", case)
            self.launch("repo", case, fused=True)
            torch.cuda.synchronize()
            case.want = case.fires.clone(), case.state_out.clone(), case.ages_out.clone(), case.start.clone()

    def launch(self, name, case, fused=False):
        lib, stream = self.libs[name], torch.cuda.current_stream().cuda_stream
        head = (case.x.data_ptr(), case.w)
        if fused:
            err = lib.sig_envelope_hold(
                *head, case.state.data_ptr(), case.holding.data_ptr(), case.ages.data_ptr(), None, None,
                float(np.float32(0.01)), 0.5, float(np.float32(0.9999)), float(case.consumed), 511.0, 16384.0,
                16383.0, 511.5, 15360.0, case.state_out.data_ptr(), case.holding_out.data_ptr(),
                case.ages_out.data_ptr(), case.found.data_ptr(), case.start.data_ptr(), case.rows, case.w,
                case.first, stream,
            )
        else:
            err = lib.sig_peak_hold(
                *head, None, case.state.data_ptr(), case.holding.data_ptr(), None, None, float(np.float32(0.01)),
                0.5, float(np.float32(0.9999)), case.state_out.data_ptr(), case.holding_out.data_ptr(),
                case.fires.data_ptr(), case.rows, case.w, case.first, stream,
            )
        _build.check(err, f"{name}: {'envelope_hold' if fused else 'peak_hold'}")

    def measure(self, name) -> dict:
        line = {}
        for shape, case in self.cases.items():
            self.launch(name, case)
            torch.cuda.synchronize()
            line[f"h_{shape}_fires_equal_repo"] = bool(torch.equal(case.fires, case.want[0]))
            line[f"h_{shape}_state_equal_repo"] = bool(torch.equal(case.state_out, case.want[1]))
            line[f"h_{shape}_us"] = device_us(lambda: self.launch(name, case), 20)
            if hasattr(self.libs[name], "sig_envelope_hold"):
                self.launch(name, case, fused=True)
                torch.cuda.synchronize()
                line[f"h_{shape}_fused_equal_repo"] = bool(
                    torch.equal(case.ages_out, case.want[2]) and torch.equal(case.start, case.want[3])
                    and torch.equal(case.state_out, case.want[1])
                )
                line[f"h_{shape}_fused_us"] = device_us(lambda: self.launch(name, case, fused=True), 20)
        return line


class SpectralWalk:
    """Kernel F at WALK_SHAPES, filtered (a history of -1 sentinels),
    threshold 0.1 and hysteresis 0 (cfg3b's) as host values: the rfft of
    8192-sample lookaheads at 96 kHz, a sine a row (150 Hz to 4 kHz) and
    noise 40 dB below it. A version with the spectrum entry
    (``sig_spectral_walk_spectrum``) runs on the rfft itself; a version with the bins
    entry (``sig_spectral_walk``) on the magnitudes and offsets that
    ``spectral_bins``' torch operations form, alone and after those
    operations in one graph (the main path before the spectrum stage), and
    unfiltered. Each output is held against the plain version's."""

    def __init__(self, libs, dev):
        from signalizer_tpu_torch.kernels import spectral_walk as sw

        self.libs, self.cases, self.sw = libs, {}, sw
        self.qs = float(np.float32(sw.QUARTER_SEMITONE))
        rng = np.random.default_rng(71)
        t = np.arange(WALK_N) / 96_000.0
        for shape, rows in WALK_SHAPES.items():
            f = np.geomspace(150.0, 4000.0, rows)[:, None]
            x = 0.5 * np.sin(2 * np.pi * f * t) + 0.0035 * rng.standard_normal((rows, WALK_N))
            x = torch.from_numpy(x.astype(np.float32)).to(dev)
            spec = torch.fft.rfft(x, dim=-1)
            empty = lambda dtype=torch.float32: torch.empty(rows, dtype=dtype, device=dev)  # noqa: E731
            hist = torch.full((rows, 8), -1.0, device=dev)
            case = types.SimpleNamespace(
                rows=rows, x=x, spec=spec, mags=spec.abs(), offsets=sw._quad_delta(spec), hist=hist,
                index=empty(torch.int32), value=empty(), offset=empty(), passes=empty(torch.int32),
                hist_out=torch.empty((rows, 8), device=dev),
            )
            want_hist, want, want_passes = sw.spectral_walk_filtered_spectrum_plain(spec, WALK_N, hist, 0.1, 0.0)
            case.want = [*want, want_passes.int(), want_hist]
            self.cases[shape] = case

    def _tail(self, case, hist=True):
        return (None, None, float(np.float32(0.1)), 1.0, self.qs, self.qs,
                float(WALK_N), case.hist.data_ptr() if hist else None, case.index.data_ptr(),
                case.value.data_ptr(), case.offset.data_ptr(), case.hist_out.data_ptr() if hist else None,
                case.passes.data_ptr(), case.rows, WALK_N // 2 - 2)

    def launch(self, name, case, hist=True, mags=None, offsets=None):
        """The bins entry on ``mags`` and ``offsets`` (the case's own by
        default)."""
        mags = case.mags if mags is None else mags
        offsets = case.offsets if offsets is None else offsets
        h = WALK_N // 2 + 1
        err = self.libs[name].sig_spectral_walk(
            mags.data_ptr(), h, offsets.data_ptr(), h, *self._tail(case, hist),
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(err, f"{name}: spectral_walk")

    def launch_spectrum(self, name, case, hist=True, spec=None):
        spec = case.spec if spec is None else spec
        err = self.libs[name].sig_spectral_walk_spectrum(
            spec.data_ptr(), WALK_N // 2 + 1, *self._tail(case, hist),
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(err, f"{name}: spectral_walk_spectrum")

    def with_tail(self, name, case, rfft=False):
        """``spectral_bins``' torch operations after the rfft (and the rfft
        itself with ``rfft``), then the bins entry on what they formed."""
        spec = torch.fft.rfft(case.x, dim=-1) if rfft else case.spec
        self.launch(name, case, mags=spec.abs(), offsets=self.sw._quad_delta(spec))

    def _equal(self, case) -> bool:
        got = (case.index, case.value, case.offset, case.passes, case.hist_out)
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, case.want))

    def measure(self, name) -> dict:
        line, lib = {}, self.libs[name]
        for shape, case in self.cases.items():
            if hasattr(lib, "sig_spectral_walk_spectrum"):
                self.launch_spectrum(name, case)
                torch.cuda.synchronize()
                line[f"f_{shape}_spectrum_equal_plain"] = self._equal(case)
                line[f"f_{shape}_passes"] = int(case.passes.max())
                line[f"f_{shape}_spectrum_us"] = device_us(lambda: self.launch_spectrum(name, case), 20)
                line[f"f_{shape}_spectrum_walk_us"] = device_us(lambda: self.launch_spectrum(name, case, False), 20)
                line[f"f_{shape}_rfft_spectrum_us"] = device_us(
                    lambda: self.launch_spectrum(name, case, spec=torch.fft.rfft(case.x, dim=-1)), 20)
            self.launch(name, case)
            torch.cuda.synchronize()
            line[f"f_{shape}_equal_plain"] = self._equal(case)
            line[f"f_{shape}_passes"] = int(case.passes.max())
            line[f"f_{shape}_us"] = device_us(lambda: self.launch(name, case), 20)
            line[f"f_{shape}_walk_us"] = device_us(lambda: self.launch(name, case, False), 20)
            line[f"f_{shape}_with_tail_us"] = device_us(lambda: self.with_tail(name, case), 20)
            line[f"f_{shape}_rfft_with_tail_us"] = device_us(lambda: self.with_tail(name, case, True), 20)
        return line

    def tail_us(self) -> dict:
        """``spectral_bins``' torch operations after the rfft alone: device
        µs a call in a graph, and each kernel's device µs a call from
        ``torch.profiler`` over 20 calls."""
        line = {}
        for shape, case in self.cases.items():
            ops = lambda: (case.spec.abs(), self.sw._quad_delta(case.spec))  # noqa: E731
            line[f"f_{shape}_tail_us"] = device_us(ops, 20)
            for _ in range(3):
                ops()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    ops()
                torch.cuda.synchronize()
            kernels = {}
            for e in prof.key_averages():
                us = getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
                if us > 0 and e.count > 0 and not e.key.startswith("aten::"):
                    kernels[e.key[:80]] = {"us": us / 20, "launches": e.count / 20}
            line[f"f_{shape}_tail_kernels"] = kernels
            line[f"f_{shape}_tail_launches"] = sum(k["launches"] for k in kernels.values())
            line[f"f_{shape}_tail_profiled_us"] = sum(k["us"] for k in kernels.values())
        return line


def helpers_v3(pairs: int, t: int, k: int, p: int) -> int:
    """The helper threads a pixel the second and third designs took (their
    wrapper's ``helpers_for``): the fewest that give the grid 2048 warps, at
    most 8 and at most T."""
    tiles = -(-p // 32) * k * pairs
    r = 1
    while 2 * r <= min(8, t) and tiles * r < 2048:
        r *= 2
    return r


class PhaseDecay:
    """Kernel G at PHASE_SHAPES through its C entry: the package's with the
    wrapper's plan (``g_<shape>_us``) and with T in chunks of 32, 64 and 128
    frames or one chunk (``g_<shape>_f<frames>_us``); the designs with R
    helper threads a pixel with the helpers they picked and with each of 1,
    2, 4 and 8 (``g_<shape>_r<R>_us``); the first design
    (``sig_phase_decay_db_v1``) as it is."""

    def __init__(self, libs, dev):
        from signalizer_tpu_torch.kernels import phase_decay_db as pd

        self.libs, self.cases, self.pd = libs, {}, pd
        self.sms = torch.cuda.get_device_properties(dev).multi_processor_count
        c = make_spectrum_constant(
            device=dev, axis_points=PIXELS, window_size=WINDOW, sample_rate=48_000.0,
            configuration=SpectrumChannels.PHASE, bin_interpolation=BinInterpolation.LINEAR,
            view_scaling=ViewScaling.LOGARITHMIC,
        )
        self.c, self.pp = c, pd.phase_poles(c)
        rng = np.random.default_rng(61)
        for shape, (pairs, t, invalid) in PHASE_SHAPES.items():
            k = c.num_line_graphs
            valid = None
            if invalid:
                valid = torch.ones(t, device=dev)
                valid[-invalid:] = 0.0
            mid = np.abs(rng.standard_normal((pairs, t, PIXELS))) * 0.3
            case = types.SimpleNamespace(
                pairs=pairs, t=t, k=k, valid=valid,
                vals=torch.from_numpy(np.stack([mid, rng.random((pairs, t, PIXELS))], -2).astype(np.float32)).to(dev),
                mag0=torch.from_numpy((rng.random((pairs, k, 2, PIXELS)) * 0.05).astype(np.float32)).to(dev),
                ph0=torch.from_numpy((rng.random((pairs, k, PIXELS)) * 0.05).astype(np.float32)).to(dev),
                out=torch.empty((pairs, t, k, 2, PIXELS), device=dev),
                starts=torch.empty((pairs, t, k, 2, PIXELS), device=dev),
            )
            case.mag, case.ph = case.mag0.clone(), case.ph0.clone()
            self.cases[shape] = case
            self.launch("repo", case)
            torch.cuda.synchronize()
            case.want = (case.out.clone(), case.mag.clone(), case.ph.clone())

    def launch(self, name, case, helpers=None, frames=None):
        lib, c = self.libs[name], self.c
        args = (case.vals.data_ptr(), c.slope_map.data_ptr(), c.decay_poles.data_ptr(), self.pp.data_ptr(),
                c.display_scalars.data_ptr(), None if case.valid is None else case.valid.data_ptr(),
                case.mag.data_ptr(), case.ph.data_ptr(), case.out.data_ptr())
        dims = (case.pairs, case.t, case.k, 2, PIXELS)
        stream = torch.cuda.current_stream().cuda_stream
        if hasattr(lib, "sig_phase_decay_db_v1"):
            err = lib.sig_phase_decay_db_v1(*args, *dims, stream)
        elif name in _phase_helpers:
            r = helpers_v3(case.pairs, case.t, case.k, PIXELS) if helpers is None else helpers
            err = lib.sig_phase_decay_db(*args, *dims, r, stream)
        else:
            if frames is None:
                frames, _ = self.pd.phase_plan(case.pairs, case.t, case.k, PIXELS, self.sms)
            err = lib.sig_phase_decay_db(*args, case.starts.data_ptr(), *dims, frames, stream)
        _build.check(err, f"{name}: phase_decay_db")

    def measure(self, name) -> dict:
        line = {}
        lib = self.libs[name]
        for shape, case in self.cases.items():
            case.mag.copy_(case.mag0)
            case.ph.copy_(case.ph0)
            self.launch(name, case)
            torch.cuda.synchronize()
            line[f"g_{shape}_max_abs_diff_vs_repo"] = float((case.out - case.want[0]).abs().max())
            line[f"g_{shape}_states_equal_repo"] = bool(torch.equal(case.mag, case.want[1])
                                                        and torch.equal(case.ph, case.want[2]))
            reps = 10 if case.t > 1 else 50
            line[f"g_{shape}_us"] = device_us(lambda: self.launch(name, case), reps)
            line[f"g_{shape}_launch_host_us"] = host_us(lambda: self.launch(name, case))
            if name in _phase_helpers:
                for r in (1, 2, 4, 8):
                    if r <= case.t:
                        line[f"g_{shape}_r{r}_us"] = device_us(lambda r=r: self.launch(name, case, r), reps)
            elif hasattr(lib, "sig_phase_decay_db"):
                for f in sorted({32, 64, 128, case.t}):
                    if f < case.t or f == case.t > 1:
                        line[f"g_{shape}_f{f}_us"] = device_us(lambda f=f: self.launch(name, case, frames=f), reps)
        return line


class ResonatorScan:
    """Kernel H at SCAN_SHAPES through its C entry, on drives formed as
    ``resonate_chunks`` forms them (the plan's c^W read in place)."""

    def __init__(self, libs, dev):
        from signalizer_tpu_torch.kernels import resonator as rz

        self.libs, self.cases = libs, {}
        bank = rz.make_resonator_constant(np.geomspace(20.0, 20000.0, PIXELS), 48_000.0, WINDOW, device=dev)
        self.bank = bank
        rng = np.random.default_rng(62)
        for shape, (b, t, invalid, readouts) in SCAN_SHAPES.items():
            w = 800 if t == 1 else 512
            plan = rz.make_block_plan(bank, w)
            chunks = torch.from_numpy((rng.standard_normal((b, t, w)) * 0.3).astype(np.float32)).to(dev)
            valid = None
            if invalid:
                valid = torch.ones(t, device=dev)
                valid[-invalid:] = 0.0
            case = types.SimpleNamespace(
                b=b, t=t, valid=valid, plan=plan,
                drives=rz._drive(plan.drive_matrix, chunks, PIXELS, bank.vectors),
                state=torch.from_numpy((rng.standard_normal((b, PIXELS, bank.vectors, 2))).astype(np.float32)).to(dev),
                out=[torch.empty((b, PIXELS, bank.vectors, 2), device=dev)]
                + [torch.empty((b, PIXELS), device=dev) for _ in range(3)]
                + [torch.empty((t, b, PIXELS), device=dev) if readouts else None],
            )
            self.cases[shape] = case
            self.launch("repo", case)
            torch.cuda.synchronize()
            case.want = [None if x is None else x.clone() for x in case.out]

    def launch(self, name, case):
        bank, decay = self.bank, case.plan.decay
        err = self.libs[name].sig_resonator_scan(
            case.state.data_ptr(), case.drives.data_ptr(), decay.data_ptr(), decay.data_ptr() + 4,
            None if case.valid is None else case.valid.data_ptr(), bank.combine.data_ptr(), bank.gain.data_ptr(),
            *(None if x is None else x.data_ptr() for x in case.out), case.b, case.t, PIXELS, bank.vectors, 2,
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(err, f"{name}: resonator_scan")

    def measure(self, name) -> dict:
        line = {}
        for shape, case in self.cases.items():
            self.launch(name, case)
            torch.cuda.synchronize()
            line[f"r_{shape}_state_equal_repo"] = bool(torch.equal(case.out[0], case.want[0]))
            line[f"r_{shape}_max_abs_diff_vs_repo"] = max(
                float((x - y).abs().max()) for x, y in zip(case.out[1:], case.want[1:]) if x is not None)
            line[f"r_{shape}_us"] = device_us(lambda: self.launch(name, case), 20)
        return line


def colour_chunk(source: Path, defines=()) -> int:
    """The samples a thread of a version of kernel E holds: ``-DSIG_CHUNK``,
    else its source's ``kChunk`` (or ``SIG_CHUNK`` default)."""
    for d in defines:
        if d.startswith("-DSIG_CHUNK="):
            return int(d.split("=", 1)[1])
    text = source.read_text()
    found = re.search(r"constexpr int kChunk = (\d+);", text) or re.search(r"#define SIG_CHUNK (\d+)", text)
    return int(found.group(1))


class ColourTrack:
    """Kernel E at COLOUR_SHAPES through its fused entry
    (``sig_colour_track``), 96 kHz, the 10 ms smoother, a key a row: the
    package's with the wrapper's plan (``e_<shape>_us``) and with the
    cluster sizes of COLOUR_CLUSTERS (``e_<shape>_c<S>_us``), the designs
    that run a row in one block as they are."""

    FS = 96_000.0
    POLE = float(np.exp(-1.0 / (10e-3 * 96_000.0)))

    def __init__(self, libs, chunks, dev):
        self.libs, self.chunks, self.dev, self.cases, self.tables = libs, chunks, dev, {}, {}
        self.sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rng = np.random.default_rng(71)
        for shape, (pairs, rows, w) in COLOUR_SHAPES.items():
            n = pairs * rows

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

            case = types.SimpleNamespace(
                rows=n, rows_pp=rows, w=w, x=t(rng.standard_normal((n, w)) * 0.3),
                z=t(rng.standard_normal((n, 8, 2)) * 0.01), s=t(rng.random((n, 3)) * 0.01),
                bc=t(np.eye(3)), key=t(rng.random((rows, 3))), blend=t(0.8),
                colours=torch.empty((n, 3, w), device=dev), z_out=torch.empty((n, 8, 2), device=dev),
                s_out=torch.empty((n, 3), device=dev),
            )
            self.cases[shape] = case
            self.launch("repo", case)
            torch.cuda.synchronize()
            case.want = case.colours.clone(), case.z_out.clone(), case.s_out.clone()

    def table(self, name) -> torch.Tensor:
        key = self.chunks[name], name in _colour_one_block
        if key not in self.tables:
            self.tables[key] = torch.from_numpy(
                ct.host_table(self.FS, pole=self.POLE, chunk=key[0],
                              steps=int(np.log2(ct.THREADS // ct.WARP)) if key[1] else ct.STEPS)).to(self.dev)
        return self.tables[key]

    def launch(self, name, case, cluster=None):
        if name in _colour_one_block:
            geometry = (ct.THREADS,)
        elif cluster is None:
            geometry = ct.colour_plan(case.rows, case.w, self.sms, self.chunks[name])
        else:
            geometry = (ct.colour_threads(case.w, cluster, self.chunks[name]), cluster)
        err = self.libs[name].sig_colour_track(
            case.x.data_ptr(), case.w, 0, self.table(name).data_ptr(), case.z.data_ptr(), case.z_out.data_ptr(),
            case.s.data_ptr(), case.s_out.data_ptr(), case.bc.data_ptr(), case.key.data_ptr(), 0, 3, case.rows_pp,
            case.blend.data_ptr(), 0.0, case.colours.data_ptr(), case.rows, case.w, self.chunks[name], *geometry,
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(err, f"{name}: colour_track")

    def measure(self, name) -> dict:
        line = {}
        for shape, case in self.cases.items():
            self.launch(name, case)
            torch.cuda.synchronize()
            got = case.colours, case.z_out, case.s_out
            line[f"e_{shape}_max_abs_diff_repo"] = max(float((g - w).abs().max()) for g, w in zip(got, case.want))
            line[f"e_{shape}_us"] = device_us(lambda: self.launch(name, case), 20)
            line[f"e_{shape}_launch_host_us"] = host_us(lambda: self.launch(name, case))
            if name not in _colour_one_block:
                line[f"e_{shape}_geometry"] = list(ct.colour_plan(case.rows, case.w, self.sms, self.chunks[name]))
                for cluster in COLOUR_CLUSTERS[shape]:
                    line[f"e_{shape}_c{cluster}_us"] = device_us(lambda c=cluster: self.launch(name, case, c), 20)
        return line

    def wrapper_host_us(self, versions: dict) -> dict:
        """Host microseconds per call of kernel E's wrapper ``colour_track``
        at cfg3 and a session's 1 x 2 x 16384: the package's and that of
        every version whose directory holds its own ``colour_track.py``
        (run against that version's library), all in order then in
        reverse, twice (``<name>_<shape>_r<round>``); and the plan's lookup
        alone (``part_geometry_<shape>``)."""
        wrappers = {"repo": ct}
        for name, directory in versions.items():
            source = Path(directory) / "colour_track.py"
            if not source.is_file():
                continue
            spec = importlib.util.spec_from_file_location(f"kernel_variants_colour_{name}", source)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            module._build = types.SimpleNamespace(library=lambda lib=self.libs[name]: lib, check=_build.check)
            wrappers[name] = module
        line = {"wrapper": "host us per colour_track call"}
        for shape in ("cfg3", "session"):
            case = self.cases[shape]
            pairs = case.rows // case.rows_pp
            args = (case.x.view(pairs, case.rows_pp, case.w), self.FS,
                    ct.CrossoverState(z=case.z.view(pairs, case.rows_pp, 8, 2)), self.POLE, case.bc, case.key,
                    case.blend, case.s.view(pairs, case.rows_pp, 3))
            want = ct.colour_track(*args)[0]
            for name, module in wrappers.items():
                got = module.colour_track(*args)[0]
                torch.cuda.synchronize()
                line[f"{name}_{shape}_max_abs_diff_vs_repo"] = float((got - want).abs().max())
            names = list(wrappers)
            for rnd, order in enumerate((names, names[::-1], names, names[::-1])):
                for name in order:
                    line[f"{name}_{shape}_r{rnd}"] = host_us(lambda m=wrappers[name]: m.colour_track(*args))
            line[f"part_geometry_{shape}"] = host_us(lambda: ct._geometry(self.dev, case.rows, case.w))
        return line


class Resample:
    """Kernel C at RESAMPLE_SHAPES."""

    def __init__(self, libs, dev):
        self.libs = libs
        self.cases = {}
        rng = np.random.default_rng(30)
        for shape, (kind, a, dual, rows, p, step) in RESAMPLE_SHAPES.items():
            x = torch.from_numpy((rng.standard_normal((PAIRS, rows, OSC_HISTORY)) * 0.4).astype(np.float32)).to(dev)
            span = step * (p - 1)
            start = torch.from_numpy(
                (rng.uniform(0.0, OSC_HISTORY - 1.0 - span, PAIRS) + 0.3137).astype(np.float32)
            ).to(dev)
            lo, hi = CLIP[kind](a, OSC_HISTORY)
            case = types.SimpleNamespace(
                kind=kind, a=a, dual=dual, rows=rows, p=p, step=float(np.float32(step)), lo=lo, hi=hi,
                x=x, start=start, pos=br.affine_positions(x, start, step, p, lo, hi),
                out=torch.empty((2, PAIRS, rows, p), device=dev),
            )
            case.out_ptr = case.out[0].data_ptr()
            case.near_ptr = case.out[1].data_ptr() if dual else None
            self.cases[shape] = case
            self.launch("repo", case)
            torch.cuda.synchronize()
            case.want = case.out.clone()

    def launch(self, name, case, affine: bool = False):
        lib = self.libs[name]
        tail = (case.out_ptr, case.near_ptr, PAIRS, case.rows, OSC_HISTORY, case.p, case.a, br.KINDS[case.kind])
        stream = torch.cuda.current_stream().cuda_stream
        if not hasattr(lib, "sig_banded_resample_affine"):
            err = lib.sig_banded_resample(case.x.data_ptr(), case.pos.data_ptr(), *tail, stream)
        else:
            rotation = br._rotation_address(case.a) if case.kind == "lanczos" else None
            if affine:
                pointer = (None,) if name in _affine_step_pointer else ()
                err = lib.sig_banded_resample_affine(
                    case.x.data_ptr(), case.start.data_ptr(), *pointer, case.step, case.lo, case.hi,
                    *tail, rotation, stream,
                )
            else:
                err = lib.sig_banded_resample(case.x.data_ptr(), case.pos.data_ptr(), *tail, rotation, stream)
        _build.check(err, f"{name}: banded_resample")

    def measure(self, name) -> dict:
        line = {}
        outs = lambda case, t: t[: 2 if case.dual else 1]
        for shape, case in self.cases.items():
            case.out.zero_()
            self.launch(name, case)
            torch.cuda.synchronize()
            line[f"c_{shape}_max_abs_diff_vs_repo"] = float((outs(case, case.out) - outs(case, case.want)).abs().max())
            line[f"c_{shape}_us"] = device_us(lambda: self.launch(name, case), 50)
        if hasattr(self.libs[name], "sig_banded_resample_affine"):
            case = self.cases["cfg3"]
            case.out.zero_()
            self.launch(name, case, affine=True)
            torch.cuda.synchronize()
            line["c_cfg3_affine_max_abs_diff_vs_repo"] = float((case.out - case.want).abs().max())
            line["c_cfg3_affine_us"] = device_us(lambda: self.launch(name, case, affine=True), 50)
        return line

    def wrapper_host_us(self, versions: dict) -> dict:
        """Host microseconds per call of kernel C's wrappers at cfg3."""
        case = self.cases["cfg3"]
        x, pos, start = case.x, case.pos, case.start
        kw = dict(a=case.a, kind=case.kind, with_nearest=True)
        dev = x.device

        def context():
            with torch.cuda.device(dev):
                pass

        entry = self.libs["repo"].sig_banded_resample
        bare = (
            x.data_ptr(), pos.data_ptr(), case.out_ptr, case.near_ptr, PAIRS, case.rows, OSC_HISTORY,
            case.p, case.a, br.KINDS[case.kind], br._rotation_address(case.a),
            torch.cuda.current_stream(dev).cuda_stream,
        )

        line = {
            "wrapper": "host us per call at cfg3",
            "repo_pos_entry": host_us(lambda: br.banded_resample(x, pos, **kw)),
            "repo_affine_entry": host_us(
                lambda: br.banded_resample_affine(x, start, case.step, case.p, case.lo, case.hi, **kw)
            ),
            "repo_positions_by_torch_then_pos_entry": host_us(
                lambda: br.banded_resample(
                    x, br.affine_positions(x, start, case.step, case.p, case.lo, case.hi), **kw
                )
            ),
            "part_checks": host_us(lambda: (br._check_x(x, case.a, case.kind), br._check_rows(x, pos, "pos", 2))),
            "part_one_empty": host_us(lambda: torch.empty((PAIRS, case.rows, case.p), device=dev)),
            "part_device_context": host_us(context),
            "part_stream_lookup": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
            "part_raw_stream_lookup": host_us(lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
            "part_two_views": host_us(lambda: case.out.unbind(0)),
            "part_bare_ctypes_launch": host_us(lambda: entry(*bare)),
        }
        for name, directory in versions.items():
            source = Path(directory) / "banded_resample.py"
            if not source.is_file():
                continue
            spec = importlib.util.spec_from_file_location(f"kernel_variants_wrapper_{name}", source)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            lib = self.libs[name]
            module._build = types.SimpleNamespace(library=lambda lib=lib: lib, check=_build.check)
            got = module.banded_resample(x, pos, **kw)
            torch.cuda.synchronize()
            line[f"{name}_pos_entry_max_abs_diff_vs_repo"] = float((got[0] - case.want[0]).abs().max())
            line[f"{name}_pos_entry"] = host_us(lambda: module.banded_resample(x, pos, **kw))
        return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("versions", nargs="*", metavar="NAME=DIR")
    parser.add_argument("--kernels", default="abc", help="which kernels to time: any of a, b, c, d, e, f, g, h, l, r, t")
    parser.add_argument("--named", nargs="*", default=[], choices=sorted(NAMED_VARIANTS), metavar="VARIANT",
                        help="versions kept in tools/variants/")
    parser.add_argument("--flat-twiddles", nargs="*", default=[], metavar="NAME")
    parser.add_argument("--wrapper", action="store_true",
                        help="also time kernel C's and kernel E's wrappers on the host clock")
    parser.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False; this needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)

    kernels = set(args.kernels.lower())
    versions = dict(spec.split("=", 1) for spec in args.versions)
    libs = {"repo": build("repo", _build.CSRC, kernels)}
    chunks = {"repo": colour_chunk(_build.CSRC / KERNEL_SOURCES["e"])}  # kernel E's samples a thread
    for name, directory in versions.items():
        libs[name] = build(name, Path(directory), kernels)
        own = Path(directory) / KERNEL_SOURCES["e"]
        chunks[name] = colour_chunk(own if own.is_file() else _build.CSRC / KERNEL_SOURCES["e"])
    for name in args.named:
        source, defines = NAMED_VARIANTS[name]
        libs[name] = build(name, VARIANTS_DIR, kernels, sources=[VARIANTS_DIR / source], defines=defines)
        if source.startswith("colour_track"):
            chunks[name] = colour_chunk(VARIANTS_DIR / source, defines)
    # each class times the versions that have its entries
    entries = {
        "spectrum": ("sig_window_fft_mag", "sig_display_map"), "resample": ("sig_banded_resample",),
        "long_rows": ("sig_window_fft_mag_cluster",),
        "two_pass": ("sig_window_fft_mag_long", "sig_window_fft_mag_long_v1", "sig_window_fft_mag_long_general"),
        "decay_db": ("sig_display_decay_db", "sig_display_decay_db_v1"),
        "peak_hold": ("sig_peak_hold",),
        "colour_track": ("sig_colour_track",),
        "spectral_walk": ("sig_spectral_walk", "sig_spectral_walk_spectrum"),
        "phase_decay": ("sig_phase_decay_db", "sig_phase_decay_db_v1"),
        "resonator_scan": ("sig_resonator_scan",),
    }
    timers = {
        "spectrum": Spectrum(libs, dev, args.flat_twiddles) if kernels & {"a", "b"} else None,
        "resample": Resample(libs, dev) if "c" in kernels else None,
        "long_rows": LongRows(libs, dev) if "l" in kernels else None,
        "two_pass": TwoPass(libs, dev) if "t" in kernels else None,
        "decay_db": DecayDb(libs, dev) if "d" in kernels else None,
        "peak_hold": PeakHold(libs, dev) if "h" in kernels else None,
        "colour_track": ColourTrack(libs, chunks, dev) if "e" in kernels else None,
        "spectral_walk": SpectralWalk(libs, dev) if "f" in kernels else None,
        "phase_decay": PhaseDecay(libs, dev) if "g" in kernels else None,
        "resonator_scan": ResonatorScan(libs, dev) if "r" in kernels else None,
    }
    resample = timers["resample"]

    lines = []
    for rnd, names in enumerate((list(libs), list(libs)[::-1])):
        for name in names:
            line = {"version": name, "round": rnd}
            for what, timer in timers.items():
                if timer is None or not any(hasattr(libs[name], e) for e in entries[what]):
                    continue
                line.update(timer.measure(name, kernels) if what == "spectrum" else timer.measure(name))
            line["card"] = smi
            lines.append(line)
            print(json.dumps(line), flush=True)
    if timers["spectral_walk"] is not None:
        lines.append(dict(timers["spectral_walk"].tail_us(), card=smi))
        print(json.dumps(lines[-1]), flush=True)
    for timer in (resample, timers["colour_track"]) if args.wrapper else ():
        if timer is not None:
            line = dict(timer.wrapper_host_us(versions), card=smi)
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
