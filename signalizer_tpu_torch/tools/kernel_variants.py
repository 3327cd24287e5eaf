"""Time other versions of kernels A, B and C against the package's own, on
one GPU, at the shapes the main paths give them.

    python -m signalizer_tpu_torch.tools.kernel_variants NAME=DIR [NAME=DIR ...]
        [--kernels abcl] [--flat-twiddles NAME ...] [--wrapper] [--out FILE]

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
``l``; the default leaves out ``l``). ``--flat-twiddles``
names versions of kernel A that read the flat ``exp(-2*pi*i*k/N)``, k < N/2
table instead of the stage-ordered one. A version of kernel C without the
entry ``sig_banded_resample_affine`` is called with the first revision's
arguments (no rotation table).

A time is the device time of one launch: a CUDA graph of back-to-back
launches (no host gaps between them), timed with CUDA events, median of 9
replays. Kernels A and B run at the Spectrum headline: 16 pairs x 128 frames
(and x 1 frame, the per-tick call), a 4096-point window, SEPARATE stereo,
LINEAR interpolation, a LOGARITHMIC axis of 1024 pixels, 2 line graphs.
Kernel A's cluster form (``l``) runs on rows of the engine's default
48000-sample history, N = 65536, SEPARATE: 16 pairs x 16 frames (512 rows)
and the live tick's 8 pairs x 1 frame (16 rows), with 2, 4 and 8 blocks a
cluster each (``l_t16_s8_us`` ...). Kernel C runs at three shapes of the
oscilloscope, all 16 pairs over a
16384-sample history: ``cfg3`` (Lanczos a = 10 with the nearest pick, 2
rows, a 1024-sample window over 8192 px), ``colour`` (the colour track's
nearest pick, 6 rows, the same positions) and ``zoom_out`` (Lanczos a = 10,
2 rows, the whole history over 1024 px, step ~16); a version with the
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
its own ``banded_resample.py``, run against that version's library.

Prints one JSON line per version and round, after the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
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

PAIRS, FRAMES, WINDOW, PIXELS = 16, 128, 4096, 1024
KERNEL_SOURCES = {
    "a": "window_fft_mag.cu", "b": "display_map.cu", "c": "banded_resample.cu", "l": "window_fft_mag_cluster.cu",
}
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


def build(name: str, directory: Path, kernels) -> ctypes.CDLL:
    """Compile the picked kernels of one version into their own library."""
    out_dir = _build.BUILD_DIR.parent / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    files = [f for k, f in KERNEL_SOURCES.items() if k in kernels]
    sources = [directory / f if (directory / f).is_file() else _build.CSRC / f for f in files]
    out = out_dir / f"{name}.so"
    done = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", str(out),
         *map(str, sources)],
        capture_output=True, text=True,
    )
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if "Compiling entry" in line and ("banded" in line or "cluster" in line) or "Used" in line or "spill" in line:
            print(f"# {name}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    signatures = dict(_build.SIGNATURES)
    if not hasattr(lib, "sig_banded_resample_affine"):
        signatures["sig_banded_resample"] = RESAMPLE_V1
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
                err = lib.sig_banded_resample_affine(
                    case.x.data_ptr(), case.start.data_ptr(), None, case.step, case.lo, case.hi,
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
    parser.add_argument("--kernels", default="abc", help="which kernels to time: any of a, b, c, l")
    parser.add_argument("--flat-twiddles", nargs="*", default=[], metavar="NAME")
    parser.add_argument("--wrapper", action="store_true", help="also time kernel C's wrapper on the host clock")
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
    for name, directory in versions.items():
        libs[name] = build(name, Path(directory), kernels)
    spectrum = Spectrum(libs, dev, args.flat_twiddles) if kernels & {"a", "b"} else None
    resample = Resample(libs, dev) if "c" in kernels else None
    long_rows = LongRows(libs, dev) if "l" in kernels else None

    lines = []
    for rnd, names in enumerate((list(libs), list(libs)[::-1])):
        for name in names:
            line = {"version": name, "round": rnd}
            if spectrum:
                line.update(spectrum.measure(name, kernels))
            if resample:
                line.update(resample.measure(name))
            if long_rows:
                line.update(long_rows.measure(name))
            line["card"] = smi
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.wrapper and resample:
        line = dict(resample.wrapper_host_us(versions), card=smi)
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
