#!/usr/bin/env python3
"""Drive the PyTorch port's Spectrum main path once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one informational line:

1. device — name, CUDA version, ``nvidia-smi`` name and power limit, TF32 off;
2. build — both kernels from ``signalizer_tpu_torch/csrc`` with ``nvcc``;
3. kernel A (window -> FFT -> |.|) against its plain PyTorch version at the
   headline shape and at small COMPLEX, PHASE and zero-padded shapes;
4. kernel B (remap -> decay -> dB) against its plain version at the
   headline shape, at T=1 and with padded (invalid) frames;
5. the slice end to end: a seeded 48 kHz stereo stream for 16 channel
   pairs, framed at hop 800 (60 fps), through ``SpectrumProcessor`` in three
   T=128 calls and three T=1 calls, held against the plain functions on the
   same CUDA tensors, with launch counts, finiteness, sine-peak and silence
   checks;
6. profile — ``torch.profiler`` over 20 T=128 and 20 T=1 calls of the
   slice on device-resident frames gives the device time per kernel; the
   same 20 calls timed again without the profiler give the host wall time
   per call, and the device busy share is kernel time over that wall time.

The headline geometry is the repo's bench cell (bench.py:240-266): a
4096-sample window at 48 kHz, SEPARATE stereo, LINEAR bin interpolation, a
LOGARITHMIC axis of 1024 pixels, 2 line graphs, 16 pairs x 128 frames.
Times are medians of CUDA-event timings. The last two lines are a JSON
object of the kernels and a JSON object ``{"ok": true, "device": ...}``;
any failed check raises and exits non-zero before them. Without a CUDA
device the script exits non-zero and prints no result. It imports no jax.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

sys.modules["jax"] = None  # any jax import below fails loudly

FS = 48_000.0
WINDOW = 4096
AXIS_POINTS = 1024
PAIRS = 16
T = 128
HOP = 800  # 48 kHz / 60 fps
REPS = 25
KERNELS = {
    "window_fft_mag": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/window_fft_mag.cu",
        replaces="signalizer_tpu/kernels/pallas_spectrum.py:147",
    ),
    "display_map": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/display_map.cu",
        replaces="tools/pallas_display_map.py:233",
    ),
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def headline(**overrides) -> dict:
    """The headline constant's keywords (bench.py:240-266)."""
    from signalizer_tpu_torch import BinInterpolation, SpectrumChannels, ViewScaling

    kw = dict(
        axis_points=AXIS_POINTS,
        window_size=WINDOW,
        sample_rate=FS,
        configuration=SpectrumChannels.SEPARATE,
        bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LOGARITHMIC,
    )
    kw.update(overrides)
    return kw


def info(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def median_ms(torch, fn, reps: int = REPS) -> float:
    """Median over ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def row_rel_err(got, want) -> float:
    err = (got - want).abs().amax(-1)
    return float((err / want.abs().amax(-1).clamp(min=1e-30)).max())


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    info({
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvidia_smi": smi,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    })
    return smi


def phase_build():
    from signalizer_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    ptxas = [
        ln.strip() for ln in _build.build_info["log"].splitlines()
        if "Used" in ln or "spill" in ln
    ]
    info({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "nvcc_seconds": _build.build_info["seconds"],
        "library": _build.build_info["path"],
        "ptxas": ptxas,
    })


def _frames(torch, shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32)).to(dev)


def phase_kernel_a(torch, dev, results):
    from signalizer_tpu_torch import SpectrumChannels as SC
    from signalizer_tpu_torch.core.constant import make_spectrum_constant
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm

    report = {"phase": "kernel_a", "cases": {}}
    cases = [
        ("headline", headline(), (PAIRS, T, 2, WINDOW)),
        ("complex", headline(window_size=1024, configuration=SC.COMPLEX), (4, 8, 2, 1024)),
        ("phase", headline(window_size=1024, configuration=SC.PHASE), (4, 8, 2, 1024)),
        ("zero_pad", headline(window_size=3000), (4, 8, 2, 3000)),
    ]
    for i, (name, kw, shape) in enumerate(cases):
        c = make_spectrum_constant(device=dev, **kw)
        frames = _frames(torch, shape, seed=10 + i, dev=dev)
        got = wfm.window_fft_mag(c, frames)
        want = wfm.window_fft_mag_plain(c, frames)
        torch.cuda.synchronize()
        rel = row_rel_err(got, want)
        require(got.shape == want.shape and got.dtype == want.dtype, f"kernel A {name} shape")
        require(rel <= 5e-6, f"kernel A {name}: row-relative error {rel} > 5e-6")
        ms = median_ms(torch, lambda: wfm.window_fft_mag(c, frames))
        plain_ms = median_ms(torch, lambda: wfm.window_fft_mag_plain(c, frames))
        report["cases"][name] = {"shape": list(shape), "row_rel_err": rel, "ms": ms, "plain_ms": plain_ms}
        if name == "headline":
            results["window_fft_mag"] = dict(
                max_abs_err=float((got - want).abs().max()), ms=ms, plain_ms=plain_ms
            )
            headline_mags = got
            headline_constant = c
    info(report)
    return headline_constant, headline_mags


def phase_kernel_b(torch, dev, c, mags, results):
    from signalizer_tpu_torch.kernels import display_map as dm

    report = {"phase": "kernel_b", "cases": {}}
    rng = np.random.default_rng(20)
    state0 = torch.from_numpy(
        (rng.random((PAIRS, c.num_line_graphs, c.state_channels, c.axis_points)) * 0.5).astype(np.float32)
    ).to(dev)
    valid = rng.random(T) > 0.25
    valid[0] = False
    cases = [
        ("headline", mags, None),
        ("t1", mags[:, :1].contiguous(), None),
        ("valid_mask", mags, torch.from_numpy(valid).to(dev)),
    ]
    for name, m, v in cases:
        s_kernel, s_plain = state0.clone(), state0.clone()
        got = dm.display_map(c, m, s_kernel, v)
        want = dm.display_map_plain(c, m, s_plain, v)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        state_rel = float(((s_kernel - s_plain).abs() / s_plain.abs().clamp(min=1e-30)).max())
        require(got.shape == want.shape, f"kernel B {name} shape")
        require(err <= 1e-5, f"kernel B {name}: display error {err} > 1e-5")
        require(state_rel <= 1e-6, f"kernel B {name}: state relative error {state_rel} > 1e-6")
        scratch = state0.clone()
        ms = median_ms(torch, lambda: dm.display_map(c, m, scratch, v))
        plain_ms = median_ms(torch, lambda: dm.display_map_plain(c, m, scratch, v))
        report["cases"][name] = {
            "shape": list(m.shape), "max_abs_err": err, "state_rel_err": state_rel,
            "ms": ms, "plain_ms": plain_ms,
        }
        if name == "headline":
            results["display_map"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    info(report)


def make_stream(pairs: int, n_frames: int):
    """Seeded stereo stream [pairs, 2, L] at 48 kHz: pair i carries a sine
    on an exact FFT bin between 100 Hz and 15 kHz (both channels, the right
    one phase-shifted) plus independent noise 40 dB below it; the last pair
    is silent. Returns the stream and each sounding pair's frequency."""
    rng = np.random.default_rng(2026)
    length = HOP * (n_frames - 1) + WINDOW
    n = np.arange(length)
    bins = np.unique(np.round(np.geomspace(100.0, 15_000.0, pairs - 1) * WINDOW / FS).astype(int))
    require(len(bins) == pairs - 1, "distinct sine bins")
    freqs = bins * FS / WINDOW
    amp = 0.5
    noise_std = amp / np.sqrt(2.0) * 10 ** (-40 / 20)
    stream = np.zeros((pairs, 2, length), np.float32)
    for i, f in enumerate(freqs):
        for ch, phase in ((0, 0.0), (1, 0.3)):
            tone = amp * np.sin(2 * np.pi * f * n / FS + phase)
            stream[i, ch] = tone + rng.standard_normal(length) * noise_std
    return stream, freqs


def frame_stream(stream, n_frames: int):
    """[pairs, 2, L] -> [pairs, n_frames, 2, WINDOW] at hop HOP."""
    view = np.lib.stride_tricks.sliding_window_view(stream, WINDOW, axis=-1)[:, :, ::HOP]
    return np.ascontiguousarray(view[:, :, :n_frames].transpose(0, 2, 1, 3))


def phase_slice(torch, dev, launches_out):
    from signalizer_tpu_torch import SpectrumProcessor
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm

    n_frames = 3 * T + 3
    stream, freqs = make_stream(PAIRS, n_frames)
    frames = frame_stream(stream, n_frames)
    proc = SpectrumProcessor.create(pairs=PAIRS, device=dev, **headline())
    c = proc.constant
    clip_db = float(c.clip_db)
    plain_state = proc.state.magnitude.clone()
    calls = [frames[:, i * T : (i + 1) * T] for i in range(3)]
    calls += [frames[:, 3 * T + i] for i in range(3)]  # per-tick [pairs, 2, W]

    worst = 0.0
    wfm.launches = 0
    dm.launches = 0
    for chunk in calls:
        out = proc.process(chunk)
        x = torch.from_numpy(chunk).to(dev)
        if x.ndim == 3:
            x = x[:, None]
        want = dm.display_map_plain(c, wfm.window_fft_mag_plain(c, x), plain_state)
        torch.cuda.synchronize()
        require(out.shape == want.shape, "slice output shape")
        require(bool(torch.isfinite(out).all()), "slice output finite")
        worst = max(worst, float((out - want).abs().max()))
        require(bool((out[-1] == clip_db).all()), "silent pair reads clip_db everywhere")
    launches = {"window_fft_mag": wfm.launches, "display_map": dm.launches}
    launches_out.update(launches)
    require(worst <= 2e-4, f"slice vs plain display error {worst} > 2e-4")
    require(launches == {"window_fft_mag": len(calls), "display_map": len(calls)},
            f"launch counts {launches} != {len(calls)} calls each")
    state_err = float(((proc.state.magnitude - plain_state).abs()).max())
    require(state_err <= 1e-5 * float(plain_state.abs().max()), f"slice state error {state_err}")

    # each sounding pair's LineMain peak lies within one pixel of its sine
    mapped = c.mapped_frequencies.cpu().numpy()
    last = out[:, -1, 0].cpu().numpy()  # [pairs, rows, P], LineMain
    peaks = []
    for i, f in enumerate(freqs):
        expect = int(np.argmin(np.abs(mapped - f)))
        for r in range(2):
            got = int(np.argmax(last[i, r]))
            require(abs(got - expect) <= 1, f"pair {i} row {r}: peak pixel {got}, sine at {expect} ({f} Hz)")
        peaks.append([float(f), expect, int(np.argmax(last[i, 0]))])

    # information only: throughput on device-resident frames
    x = torch.from_numpy(calls[0]).to(dev)
    scratch = proc.state.magnitude.clone()
    slice_ms = median_ms(torch, lambda: proc.process(x), reps=10)
    plain_ms = median_ms(
        torch, lambda: dm.display_map_plain(c, wfm.window_fft_mag_plain(c, x), scratch), reps=10
    )
    tick = torch.from_numpy(calls[3]).to(dev)
    tick_ms = median_ms(torch, lambda: proc.process(tick))
    info({
        "phase": "slice",
        "calls": [list(np.shape(ch)) for ch in calls],
        "max_abs_err_vs_plain": worst,
        "state_max_abs_err": state_err,
        "launches": launches,
        "peaks_hz_expected_got": peaks,
        "frames_per_s": PAIRS * T / (slice_ms / 1e3),
        "plain_frames_per_s": PAIRS * T / (plain_ms / 1e3),
        "t128_call_ms": slice_ms,
        "plain_t128_call_ms": plain_ms,
        "t1_call_ms": tick_ms,
    })
    return proc, x, tick


def phase_profile(torch, proc, x, tick, calls: int = 20):
    """Device time per kernel and busy share of the slice's step, T=128
    and T=1: kernel times from ``torch.profiler`` (CUPTI) over ``calls``
    calls, host wall time from the same calls run without the profiler
    (which slows the host side)."""
    from torch.profiler import ProfilerActivity, profile

    def run(frames) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            proc.process(frames)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    report = {"phase": "profile", "calls": calls}
    for name, frames in (("t128", x), ("t1", tick)):
        run(frames)  # warm-up
        wall_us = run(frames)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_wall_us = run(frames)
        kernels_us = {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            if us > 0:
                kernel = evt.key.removeprefix("(anonymous namespace)::").split("(")[0]
                kernels_us[kernel] = us / calls
        device_us = sum(kernels_us.values())
        require(device_us > 0, f"profile {name}: the profiler saw no device time")
        report[name] = {
            "wall_us_per_call": wall_us / calls,
            "profiled_wall_us_per_call": profiled_wall_us / calls,
            "device_us_per_call": device_us,
            "busy_share": device_us * calls / wall_us,
            "kernels_us_per_call": kernels_us,
        }
    info(report)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU", file=sys.stderr)
        return 1
    import signalizer_tpu_torch  # noqa: F401 — fails here when run outside the repo

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_device(torch)
    phase_build()
    results = {}
    c, mags = phase_kernel_a(torch, dev, results)
    phase_kernel_b(torch, dev, c, mags, results)
    del mags
    launches = {}
    proc, x, tick = phase_slice(torch, dev, launches)
    phase_profile(torch, proc, x, tick)
    kernels = [
        dict(name=name, **meta, launches=launches[name], **results[name])
        for name, meta in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
