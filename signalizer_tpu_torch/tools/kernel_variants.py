"""Time other versions of kernels A and B against the package's own, on one
GPU, at the Spectrum headline shape.

    python -m signalizer_tpu_torch.tools.kernel_variants NAME=DIR [NAME=DIR ...]
        [--flat-twiddles NAME ...] [--out FILE]

Each ``DIR`` holds another version of ``window_fft_mag.cu`` and/or
``display_map.cu`` with the same C entry points (``sig_window_fft_mag``,
``sig_display_map``): an earlier revision unpacked with ``git show``, or a
copy with one thing changed to see what it costs. A file a directory lacks
comes from ``signalizer_tpu_torch/csrc``. Every version is built with the
package's ``nvcc`` flags into its own library under
``build/kernel_variants/`` and timed in turns with the package's kernels
(``repo``): all versions in order, then in reverse order, so that drift of
the card shows as a difference between the two rounds. ``--flat-twiddles``
names versions of kernel A that read the flat ``exp(-2*pi*i*k/N)``, k < N/2
table instead of the stage-ordered one.

A time is the device time of one launch: a CUDA graph of back-to-back
launches (no host gaps between them), timed with CUDA events, median of 9
replays. The shape is the headline's: 16 pairs x 128 frames (and x 1 frame,
the per-tick call), a 4096-point window, SEPARATE stereo, LINEAR
interpolation, a LOGARITHMIC axis of 1024 pixels, 2 line graphs. Each
version's output is also held against the package's kernels (largest
absolute difference; kernel A relative to each row's peak). Prints one JSON
line per version and round, after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from signalizer_tpu_torch import BinInterpolation, SpectrumChannels, ViewScaling
from signalizer_tpu_torch.core.constant import make_spectrum_constant
from signalizer_tpu_torch.kernels import _build

PAIRS, FRAMES, WINDOW, PIXELS = 16, 128, 4096, 1024
KERNEL_SOURCES = ("window_fft_mag.cu", "display_map.cu")


def build(name: str, directory: Path) -> ctypes.CDLL:
    """Compile kernels A and B of one version into their own library."""
    out_dir = _build.BUILD_DIR.parent / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = [
        directory / f if (directory / f).is_file() else _build.CSRC / f for f in KERNEL_SOURCES
    ]
    out = out_dir / f"{name}.so"
    done = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), *map(str, sources)],
        capture_output=True, text=True,
    )
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if "Used" in line or "spill" in line:
            print(f"# {name}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    for entry in ("sig_window_fft_mag", "sig_display_map"):
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("versions", nargs="*", metavar="NAME=DIR")
    parser.add_argument("--flat-twiddles", nargs="*", default=[], metavar="NAME")
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

    c = make_spectrum_constant(
        device=dev, axis_points=PIXELS, window_size=WINDOW, sample_rate=48_000.0,
        configuration=SpectrumChannels.SEPARATE, bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LOGARITHMIC,
    )
    k = np.arange(WINDOW // 2, dtype=np.float64)
    ang = -2.0 * np.pi * k / WINDOW
    flat = torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)).to(dev)
    rng = np.random.default_rng(10)
    frames = torch.from_numpy(
        (rng.standard_normal((PAIRS, FRAMES, 2, WINDOW)) * 0.3).astype(np.float32)
    ).to(dev)
    state0 = torch.from_numpy((rng.random((PAIRS, 2, 2, PIXELS)) * 0.5).astype(np.float32)).to(dev)
    nv = c.n_spectrum_values

    libs = {"repo": build("repo", _build.CSRC)}
    for spec in args.versions:
        name, _, directory = spec.partition("=")
        libs[name] = build(name, Path(directory))

    def kernel_a(name, t, out):
        err = libs[name].sig_window_fft_mag(
            frames.data_ptr(), c.window_kernel.data_ptr(),
            (flat if name in args.flat_twiddles else c.fft_twiddles).data_ptr(), out.data_ptr(),
            PAIRS * t, 2, WINDOW, WINDOW.bit_length() - 1, int(c.configuration),
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(err, f"{name}: window_fft_mag")

    def kernel_b(name, mags, state, out):
        err = libs[name].sig_display_map(
            mags.data_ptr(), c.interp_indices.data_ptr(), c.interp_weights.data_ptr(),
            c.interp_mask.data_ptr(), c.single_mask.data_ptr(), c.single_bin.data_ptr(),
            c.chunk_lo.data_ptr(), c.chunk_len.data_ptr(), c.slope_map.data_ptr(),
            c.decay_poles.data_ptr(), c.display_scalars.data_ptr(), None, state.data_ptr(),
            out.data_ptr(), PAIRS, mags.shape[1], 2, 2, PIXELS, nv, c.interp_taps,
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(err, f"{name}: display_map")

    mags = {t: torch.empty((PAIRS, t, 2, nv), device=dev) for t in (FRAMES, 1)}
    shown = {t: torch.empty((PAIRS, t, 2, 2, PIXELS), device=dev) for t in (FRAMES, 1)}
    # frames[:, :1] is not what a T = 1 call reads: kernel A takes the first
    # PAIRS frames of the tensor, which is as much work
    kernel_a("repo", FRAMES, mags[FRAMES])
    kernel_a("repo", 1, mags[1])
    state = state0.clone()
    kernel_b("repo", mags[FRAMES], state, shown[FRAMES])
    torch.cuda.synchronize()
    want_mags, want_shown, want_state = mags[FRAMES].clone(), shown[FRAMES].clone(), state.clone()

    lines = []
    for rnd, names in enumerate((list(libs), list(libs)[::-1])):
        for name in names:
            got = torch.empty_like(want_mags)
            kernel_a(name, FRAMES, got)
            state = state0.clone()
            kernel_b(name, want_mags, state, shown[FRAMES])
            torch.cuda.synchronize()
            # compare this first launch's outputs before the timed launches
            # move the state on
            peak = want_mags.abs().amax(-1).clamp(min=1e-30)
            a_diff = float(((got - want_mags).abs().amax(-1) / peak).max())
            b_diff = float((shown[FRAMES] - want_shown).abs().max())
            state_equal = bool(torch.equal(state, want_state))
            line = {
                "version": name, "round": rnd,
                "a_t128_us": device_us(lambda: kernel_a(name, FRAMES, mags[FRAMES]), 10),
                "a_t1_us": device_us(lambda: kernel_a(name, 1, mags[1]), 50),
                "b_t128_us": device_us(lambda: kernel_b(name, want_mags, state, shown[FRAMES]), 10),
                "b_t1_us": device_us(lambda: kernel_b(name, mags[1], state, shown[1]), 50),
                "a_row_rel_diff_vs_repo": a_diff,
                "b_max_abs_diff_vs_repo": b_diff,
                "b_state_equal_repo": state_equal,
                "card": smi,
            }
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
