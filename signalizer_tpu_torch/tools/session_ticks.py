"""Time session ticks of one or more checkouts in turns, on one GPU.

    python -m signalizer_tpu_torch.tools.session_ticks [TREE ...]

Each ``TREE`` is the root of a checkout: its ``signalizer_tpu_torch`` is the
one imported. The trees run one after another, each in a process of its
own, in the order given, so ``parent change change parent ...`` shows the
card's drift beside the difference. Without a ``TREE`` the checkout this
module lives in runs.

In a process, one ``AnalysisSession`` for each of ``PRESETS`` (``default``
is the factory default preset; ``cycles.oscilloscope`` is loaded over it),
four views at 1024 px with the Transform tracker on the left sine, as
``chip_smoke.py``'s session phase opens it, is fed 800-sample blocks of a
seeded stereo pair of sines (1000 and 1500 Hz) in noise, and the sessions
tick a tick each in turn, the order alternating. After ``WARMUP`` ticks
each, ``TICKS`` ticks each are timed on the host clock up to a
``torch.cuda.synchronize()``; then ten more ticks each have their
synchronizing CUDA operations counted (``torch.cuda.set_sync_debug_mode``).
Prints one JSON line a tree: for each preset ms a tick (p50, p90, p99),
syncs a tick and the median of its pairwise differences from the default's
ticks, with the card's name and power limit. With trees given, a last line
holds each tree's p50s run by run and, where exactly two trees alternate,
the second's p50 minus the first's in each neighbouring pair of runs.
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

HOP, FS, PIXELS = 800, 48_000.0, 1024
PRESETS = ("default", "cycles.oscilloscope")
WARMUP, TICKS, SYNC_TICKS = 60, 200, 10


def _blocks(n: int):
    """The seeded stereo blocks of chip_smoke.py's session phase."""
    rng = np.random.default_rng(2024)
    t = np.arange(n * HOP) / FS
    x = np.stack([0.5 * np.sin(2 * np.pi * 1000.0 * t), 0.4 * np.sin(2 * np.pi * 1500.0 * t + 0.3)])
    x = x + 0.02 * rng.standard_normal(x.shape)
    return [np.ascontiguousarray(x[:, i * HOP : (i + 1) * HOP], dtype=np.float32) for i in range(n)]


def _session(preset: str, device):
    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.session import AnalysisSession

    eng = SignalizerEngine("ticks", device=device)
    if preset != "default" and not eng.load_preset(preset):
        raise SystemExit(f"session_ticks: no factory preset {preset!r}")
    eng.spectrum.frequency_tracker.set_normalized(1 / 3)  # transform
    return AnalysisSession(eng, axis_points=PIXELS, pixels=PIXELS, cursor_fraction=1000.0 / (FS / 2))


def _syncs(torch, fn) -> int:
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in log)


def run() -> dict:
    import torch

    from signalizer_tpu_torch.stream.audio_stream import Playhead

    if not torch.cuda.is_available():
        raise SystemExit("session_ticks: torch.cuda.is_available() is False; this needs a GPU")
    dev = torch.device("cuda", 0)
    blocks = _blocks(WARMUP + TICKS + SYNC_TICKS)
    sessions = {p: _session(p, dev) for p in PRESETS}
    times = {p: [] for p in PRESETS}

    def tick(s, i):
        clock = (i + 1) * HOP
        s.feed(blocks[i], Playhead(steady_clock=clock, position_samples=clock, is_playing=True))
        return s.tick()

    for i in range(WARMUP + TICKS):
        order = list(sessions.items())
        for name, s in order if i % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            tick(s, i)
            torch.cuda.synchronize()
            if i >= WARMUP:
                times[name].append((time.perf_counter() - t0) * 1e3)
    out = {"package": str(Path(sys.modules["signalizer_tpu_torch"].__file__).parent), "ticks": TICKS}
    first = PRESETS[0]
    for name, s in sessions.items():
        syncs = [_syncs(torch, lambda i=i: tick(s, i)) for i in range(WARMUP + TICKS, WARMUP + TICKS + SYNC_TICKS)]
        v = np.asarray(times[name])
        out[name] = {"p50": float(np.percentile(v, 50)), "p90": float(np.percentile(v, 90)),
                     "p99": float(np.percentile(v, 99)), "syncs_per_tick": float(np.median(syncs)),
                     "minus_first_ms": float(np.median(v - np.asarray(times[first])))}
        s.close()
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
    trees = list(dict.fromkeys(args.trees))
    summary = {p: {t: [r[p]["p50"] for u, r in runs if u == t] for t in trees} for p in PRESETS}
    pairs = [dict(runs[i : i + 2]) for i in range(0, len(runs) - 1, 2)]
    if len(trees) == 2 and all(len(pair) == 2 for pair in pairs):
        for p in PRESETS:
            diffs = [pair[trees[1]][p]["p50"] - pair[trees[0]][p]["p50"] for pair in pairs]
            summary[p]["second_minus_first_ms"] = diffs
            summary[p]["median_second_minus_first_ms"] = float(np.median(diffs))
            summary[p]["pairs_second_faster"] = sum(d < 0 for d in diffs)
    print(json.dumps({"summary": summary, "trees": trees}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
