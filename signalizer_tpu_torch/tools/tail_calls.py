"""Time the calls that carry kernels E, F, G and H (the colour track, the
spectral trigger's walk, the PHASE display tail and the resonator bank) in
one or more checkouts, on one GPU.

    python -m signalizer_tpu_torch.tools.tail_calls [TREE ...]

Each ``TREE`` is the root of a checkout: its ``signalizer_tpu_torch`` is the
one imported. The trees run one after another, each in a process of its
own, in the order given, so ``parent change change parent`` shows the card's
drift beside the difference. Without a ``TREE`` the checkout this module
lives in runs.

The calls, each through the public entry a user calls, at full width:

* ``phase_t128`` and ``phase_t1``: ``SpectrumProcessor.process`` at the
  Spectrum headline (``bench.py:240-266``: 4096-point window, 48 kHz, a
  LOGARITHMIC axis of 1024 px, 2 line graphs, 16 pairs) in the PHASE
  configuration, on 128 frames and on 1;
* ``phase_cfg4``: the spectrogram's batched step (``bench.py:881-924``:
  1 pair x T = 512 frames of a 16384-point window, 1024 px, the last 3
  frames invalid, a host mask) in PHASE;
* ``rsnt_tick`` and ``rsnt_backlog``: ``ResonatorSpectrumProcessor`` at the
  headline constant (SEPARATE), 16 pairs, one 800-sample chunk, and the
  cfg6 backlog (``bench.py:1052-1114``: 16 chunks of 512, the last 3
  invalid); ``rsnt_phase_backlog`` the backlog in PHASE;
* ``rsnt_session_tick``: ``AnalysisSession.tick()`` at the factory default
  preset with the Spectrum's algorithm set to RSNT, four views at 1024 px,
  800-sample blocks of a seeded pair of sines in noise;
* ``osc_cfg3_colour``: ``OscilloscopeProcessor.process`` at cfg3
  (``bench.py:769-822``: 16 SEPARATE pairs at 96 kHz, a 16384-sample
  history, ZERO_CROSSING, LANCZOS of a 1024-sample window to 8192 px,
  PEAK_DECAY) with the colour track on, 1600 new samples a call;
* ``coloured_session_tick``: a tick of the same session as
  ``rsnt_session_tick`` at the factory preset ``coloured.oscilloscope``;
* ``osc_cfg3b``: the same oscilloscope with the SPECTRAL trigger
  (``bench.py:824-879``) and no colour track; ``cycles_session_tick``: a
  tick of the session at the factory preset ``cycles.oscilloscope``;
* ``colour_cfg3`` and ``colour_session``: kernel E's wrapper alone,
  ``colour_track`` on cfg3's 16 pairs x 2 rows x 16384 samples and on a
  coloured session's 1 pair x 2 rows, 96 kHz, the 10 ms smoother, carried
  states, a key a row, the blend a device scalar.

For each: ms a call (host clock up to a ``torch.cuda.synchronize()``, the
median of ``CALLS`` calls after a warm-up), ``queued_us`` (µs a call of
``QUEUED`` calls queued back to back and one synchronize, the median of 5
such runs: the host path of a call whose kernels are shorter than it,
what an event pair around queued calls times), the device kernels launched
and their µs a call (``torch.profiler`` over ``PROFILED`` calls; CUPTI now
and then hands a short session no kernel record, which is run again up to
3 times), the top kernels, and the synchronizing operations of one call
(``torch.cuda.set_sync_debug_mode``) with the line that asked for each. Prints one JSON line a tree with the
card's name and power limit; with trees given, a last line holds each
call's ms, launches and device µs run by run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

FS, WINDOW, AXIS_POINTS, PAIRS, HOP = 48_000.0, 4096, 1024, 16, 800
OSC_FS, OSC_HISTORY, OSC_PIXELS, OSC_HOP = 96_000.0, 16384, 8192, 1600
CALLS, PROFILED, QUEUED = 40, 20, 100
FIELDS = ("ms", "queued_us", "launches", "device_us")


def _calls(torch, dev):
    """``[(name, fn)]``: each call at full width, its inputs on the card."""
    from signalizer_tpu_torch import (
        AutoGain,
        BinInterpolation,
        OscChannels,
        OscilloscopeProcessor,
        ResonatorSpectrumProcessor,
        SpectrumChannels,
        SpectrumProcessor,
        SubSampleInterpolation,
        TriggerMode,
        ViewScaling,
    )
    from signalizer_tpu_torch.core.config import DisplayMode
    from signalizer_tpu_torch.core.constant import make_spectrum_constant
    from signalizer_tpu_torch.kernels import spectrum as ts
    from signalizer_tpu_torch.kernels.colormap import gradient_bounds, normalize_ratios
    from signalizer_tpu_torch.views import spectrogram as tv

    def headline(**kw):
        base = dict(axis_points=AXIS_POINTS, window_size=WINDOW, sample_rate=FS,
                    configuration=SpectrumChannels.SEPARATE, bin_interpolation=BinInterpolation.LINEAR,
                    view_scaling=ViewScaling.LOGARITHMIC)
        base.update(kw)
        return base

    rng = np.random.default_rng(2031)

    def frames(shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32)).to(dev)

    phase = SpectrumProcessor.create(pairs=PAIRS, device=dev, **headline(configuration=SpectrumChannels.PHASE))
    x128, x1 = frames((PAIRS, 128, 2, WINDOW)), frames((PAIRS, 1, 2, WINDOW))

    c4 = make_spectrum_constant(device=dev, **headline(
        window_size=16384, configuration=SpectrumChannels.PHASE, display_mode=DisplayMode.COLOUR_SPECTRUM))
    x4 = frames((1, 512, 2, 16384))
    valid4 = np.ones(512, bool)
    valid4[-3:] = False
    colours = torch.from_numpy(tv.DEFAULT_GRADIENT[None]).to(dev)
    ratios = torch.from_numpy(normalize_ratios(tv.DEFAULT_RATIOS).astype(np.float32)).to(dev)
    bounds = gradient_bounds(ratios)
    state4 = ts.init_line_graph_state(c4, (1,))

    bank = ResonatorSpectrumProcessor.create(pairs=PAIRS, device=dev, **headline())
    bank_phase = ResonatorSpectrumProcessor.create(
        pairs=PAIRS, device=dev, **headline(configuration=SpectrumChannels.PHASE))
    audio = frames((PAIRS, 2, 16 * 512))
    tick = audio[..., :HOP][:, :, None, :].contiguous()
    backlog = audio.reshape(PAIRS, 2, 16, 512)
    valid6 = np.ones(16, bool)
    valid6[-3:] = False

    osc = OscilloscopeProcessor.create(
        pairs=PAIRS, device=dev, sample_rate=OSC_FS, channel_mode=OscChannels.SEPARATE,
        trigger_mode=TriggerMode.ZERO_CROSSING, interpolation=SubSampleInterpolation.LANCZOS, pixels=OSC_PIXELS,
        lookahead=8192, trigger_threshold=0.1, autogain=AutoGain.PEAK_DECAY, window_samples=1024.0,
        colour_enabled=True,
    )
    n = np.arange(OSC_HISTORY)
    tones = np.sin(2 * np.pi * np.geomspace(150.0, 4000.0, PAIRS)[:, None, None] * n / OSC_FS + [[0.0], [0.3]])
    history = torch.from_numpy((0.5 * tones + 0.005 * rng.standard_normal(tones.shape)).astype(np.float32)).to(dev)

    from signalizer_tpu_torch.kernels import colour_track as ct

    def colour(pairs):
        x = frames((pairs, 2, OSC_HISTORY))
        state = ct.CrossoverState(z=frames((pairs, 2, 8, 2)) * 0.01)
        smooth, key = frames((pairs, 2, 3)).abs() * 0.01, frames((pairs, 2, 3)).abs()
        bc = torch.from_numpy(rng.random((3, 3)).astype(np.float32)).to(dev)
        blend, pole = torch.tensor(0.8, device=dev), float(np.exp(-1.0 / (10e-3 * OSC_FS)))
        return lambda: ct.colour_track(x, OSC_FS, state, pole, bc, key, blend, smooth)

    def rsnt(eng):
        eng.spectrum.algorithm.set_normalized(1.0)  # RSNT

    def coloured(eng):
        if not eng.load_preset("coloured.oscilloscope"):
            raise SystemExit("tail_calls: no factory preset coloured.oscilloscope")

    def cycles(eng):
        if not eng.load_preset("cycles.oscilloscope"):
            raise SystemExit("tail_calls: no factory preset cycles.oscilloscope")

    spectral = OscilloscopeProcessor.create(
        pairs=PAIRS, device=dev, sample_rate=OSC_FS, channel_mode=OscChannels.SEPARATE,
        trigger_mode=TriggerMode.SPECTRAL, interpolation=SubSampleInterpolation.LANCZOS, pixels=OSC_PIXELS,
        lookahead=8192, trigger_threshold=0.1, autogain=AutoGain.PEAK_DECAY, window_samples=1024.0,
    )

    return [
        ("phase_t128", lambda: phase.process(x128)),
        ("phase_t1", lambda: phase.process(x1)),
        ("phase_cfg4", lambda: tv.spectrogram_step(c4, state4, x4, colours, ratios, valid4, bounds)),
        ("rsnt_tick", lambda: bank.process_chunks(tick)),
        ("rsnt_backlog", lambda: bank.process_chunks(backlog, valid=valid6)),
        ("rsnt_phase_backlog", lambda: bank_phase.process_chunks(backlog, valid=valid6)),
        ("rsnt_session_tick", _session(dev, rsnt)),
        ("osc_cfg3_colour", lambda: osc.process(history, new_samples=OSC_HOP)),
        ("coloured_session_tick", _session(dev, coloured)),
        ("colour_cfg3", colour(PAIRS)),
        ("colour_session", colour(1)),
        ("osc_cfg3b", lambda: spectral.process(history, new_samples=OSC_HOP)),
        ("cycles_session_tick", _session(dev, cycles)),
    ]


def _session(dev, knobs):
    """A tick of a session at the factory default changed by ``knobs(engine)``,
    fed a new block each call."""
    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.session import AnalysisSession
    from signalizer_tpu_torch.stream.audio_stream import Playhead

    eng = SignalizerEngine("tail_calls", device=dev)
    eng.spectrum.frequency_tracker.set_normalized(1 / 3)  # transform
    knobs(eng)
    s = AnalysisSession(eng, axis_points=AXIS_POINTS, pixels=AXIS_POINTS, cursor_fraction=1000.0 / (FS / 2))
    rng = np.random.default_rng(2024)
    n = 64
    t = np.arange(n * HOP) / FS
    x = np.stack([0.5 * np.sin(2 * np.pi * 1000.0 * t), 0.4 * np.sin(2 * np.pi * 1500.0 * t + 0.3)])
    x = (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32)
    blocks = [np.ascontiguousarray(x[:, i * HOP : (i + 1) * HOP]) for i in range(n)]
    i = [0]

    def tick():
        clock = (i[0] + 1) * HOP
        s.feed(blocks[i[0] % n], Playhead(steady_clock=clock, position_samples=clock, is_playing=True))
        i[0] += 1
        return s.tick()

    return tick


def _kernels(torch, fn, n):
    """Device µs a call by kernel name and launches a call, from
    ``torch.profiler`` over ``n`` calls (a session with no kernel record is
    run again, at most 3 times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us, launched = {}, 0
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            t = getattr(evt, "self_device_time_total", None)
            t = evt.self_cuda_time_total if t is None else t
            if t > 0:
                launched += evt.count
                name = evt.key.split("(anonymous namespace)::", 1)[-1].split("(")[0][:80]
                us[name] = us.get(name, 0.0) + t / n
        if us:
            return us, launched / n
    raise RuntimeError("tail_calls: the profiler saw no device time")


def _syncs(torch, fn) -> dict:
    """The synchronizing operations of one call, by the file and line that
    asked for each."""
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = {}
    for w in log:
        if "called a synchronizing" in str(w.message):
            site = f"{os.path.basename(w.filename)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def run() -> dict:
    import torch

    import signalizer_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("tail_calls: torch.cuda.is_available() is False; this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"package": str(Path(signalizer_tpu_torch.__file__).parent)}
    for name, fn in _calls(torch, dev):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        queued = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(QUEUED):
                fn()
            torch.cuda.synchronize()
            queued.append((time.perf_counter() - t0) * 1e6 / QUEUED)
        us, launches = _kernels(torch, fn, PROFILED)
        top = dict(sorted(us.items(), key=lambda kv: -kv[1])[:6])
        sites = _syncs(torch, fn)
        out[name] = {"ms": float(np.median(ms)), "ms_p90": float(np.percentile(ms, 90)),
                     "queued_us": float(np.median(queued)),
                     "launches": launches, "device_us": sum(us.values()), "syncs": sum(sites.values()),
                     "sync_sites": sites, "top_kernels_us": top}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="*", metavar="TREE")
    args = parser.parse_args(argv)
    if not args.trees:
        print(json.dumps(run()), flush=True)
        return 0
    runs = []
    for tree in args.trees:
        root = str(Path(tree).resolve())
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
        done = subprocess.run([sys.executable, __file__], env=env, cwd=root, capture_output=True, text=True)
        if done.returncode != 0:
            sys.stderr.write(done.stderr)
            return done.returncode
        line = done.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append((tree, json.loads(line)))
    names = [k for k, v in runs[0][1].items() if isinstance(v, dict)]
    summary = {n: {f: [[t, r[n][f]] for t, r in runs] for f in FIELDS} for n in names}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
