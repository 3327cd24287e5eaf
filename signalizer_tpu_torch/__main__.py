"""Standalone analyzer CLI — the reference's standalone-app analogue.

Counterpart of ``python -m signalizer_tpu``, with the same subcommands and
flags, on the GPU; ``--cpu`` runs it on the CPU (``device="cpu"``, the
kernels' plain versions). Without ``--cpu`` and without a GPU it raises.
The PNG renders need matplotlib, an optional package (the renderers import
it lazily): where it is not installed the CLI still analyses, writes the
arrays it is asked for (``--npz``) and prints the balances, and says on
stderr that it wrote no render.

The reference ships a JUCE standalone build of the plugin (ref:
JuceLibraryCode plugin-client standalone wrapper; CHANGELOG "standalone"
notes). This module is that role for the rebuild: analyse an audio file
offline with any subset of views and write render-ready images/arrays.

Usage:
    python -m signalizer_tpu_torch analyze input.wav [--out dir]
        [--views spectrum,oscilloscope,vectorscope,spectrogram]
        [--preset file.sgn] [--axis-points 1024] [--pixels 1024]
        [--seconds N] [--npz] [--cpu]
    python -m signalizer_tpu_torch presets      # list factory presets

Accepts PCM/float WAV; stereo is analysed as one pair, mono gets the
reference's mono surrogate (zero right channel).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def _load_wav(path: str, max_seconds: float | None):
    from scipy.io import wavfile

    fs, data = wavfile.read(path)
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / float(np.iinfo(data.dtype).max)
    elif data.dtype.kind == "u":
        info = np.iinfo(data.dtype)
        data = (data.astype(np.float32) - (info.max + 1) / 2) / ((info.max + 1) / 2)
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[:, None]
    if max_seconds is not None:
        if max_seconds <= 0:
            raise SystemExit("--seconds must be positive")
        data = data[: int(max_seconds * fs)]
    return float(fs), np.ascontiguousarray(data.T)  # [channels, samples]


def _device(args):
    """``"cpu"`` for ``--cpu``, else None: the GPU (raising without one)."""
    return "cpu" if args.cpu else None


def _renders() -> bool:
    """Whether the PNG renders can be written (matplotlib is installed);
    says so on stderr when they cannot."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("note: matplotlib is not installed: no .png renders written", file=sys.stderr)
        return False
    return True


def cmd_analyze(args) -> int:
    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.session import AnalysisSession
    from signalizer_tpu_torch.stream.audio_stream import Playhead
    from signalizer_tpu_torch.utils.readback import to_host
    from signalizer_tpu_torch.views.render import (
        render_line_graph_frame,
        render_oscilloscope,
        render_spectrogram,
        render_vectorscope,
    )

    fs, audio = _load_wav(args.input, args.seconds)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    views = tuple(v.strip() for v in args.views.split(",") if v.strip())

    eng = SignalizerEngine("cli", sample_rate=fs,
                           history_capacity=max(48_000, int(fs)), device=_device(args))
    try:
        if args.preset:
            if str(args.preset).endswith(".sgn"):
                applied = eng.load_reference_preset(args.preset)
                ok = bool(applied)
            else:
                ok = eng.load_preset(str(args.preset))
            if not ok:
                print(f"error: preset not found or applied no views: "
                      f"{args.preset}", file=sys.stderr)
                return 2
            print(f"preset applied: {args.preset}")
        session = AnalysisSession(eng, views=views,
                                  axis_points=args.axis_points,
                                  pixels=args.pixels)
        hop = 1024
        n = audio.shape[1]
        frame = None
        sg_feed = session.processor("spectrogram")
        # drain the spectrogram hopper while feeding: its ring holds only
        # ~64 blobs, so feeding a whole file before the single tick
        # silently dropped all but the trailing fraction of a second of
        # columns
        drain_every = 16 * hop
        for i in range(0, n, hop):  # every sample, including the tail block
            block = audio[:2, i : i + hop]
            session.feed(block, Playhead(position_samples=i, steady_clock=i,
                                         is_playing=True))
            if sg_feed is not None and i % drain_every == 0:
                sg_feed.pull()
        frame = session.tick()
        stem = pathlib.Path(args.input).stem
        written = []
        render = _renders()
        if render and frame.line_graph is not None and "spectrum" in views:
            written.append(render_line_graph_frame(
                frame.line_graph,
                tracker=frame.tracker,
                hints=eng.spectrum.make_render_hints(),
                path=str(out / f"{stem}.spectrum.png")))
        if render and frame.oscilloscope is not None and "oscilloscope" in views:
            written.append(render_oscilloscope(
                frame.oscilloscope, hints=eng.oscilloscope.make_render_hints(),
                path=str(out / f"{stem}.oscilloscope.png")))
        if render and frame.vectorscope is not None and "vectorscope" in views:
            from signalizer_tpu_torch.views.vectorscope import OperationalMode

            mode = OperationalMode(
                int(eng.vectorscope.operational_mode.get_transformed())
            ).name.lower()
            written.append(render_vectorscope(
                frame.vectorscope, mode=mode,
                hints=eng.vectorscope.make_render_hints(),
                path=str(out / f"{stem}.vectorscope.png")))
        sg = session.processor("spectrogram")
        if render and sg is not None and "spectrogram" in views:
            written.append(render_spectrogram(
                sg.image, path=str(out / f"{stem}.spectrogram.png")))
        if args.npz:
            arrays = {}
            if frame.spectrum is not None:
                arrays["spectrum"] = np.asarray(frame.spectrum)
            # the device frames' arrays, read back in one go
            wave, verts = to_host((
                None if frame.oscilloscope is None else frame.oscilloscope.waveform,
                None if frame.vectorscope is None else frame.vectorscope.vertices,
            ))
            if wave is not None:
                arrays["waveform"] = wave
            if verts is not None:
                arrays["vertices"] = verts
            if sg is not None:
                arrays["spectrogram"] = np.asarray(sg.image.snapshot())
            npz = out / f"{stem}.arrays.npz"
            np.savez_compressed(npz, **arrays)
            written.append(str(npz))
        session.close()
        print(f"analyzed {n / fs:.2f}s @ {fs:.0f} Hz -> {len(written)} outputs in {out}")
        for w in written:
            print(" ", w)
        return 0
    finally:
        eng.close()


def cmd_analyze_batch(args) -> int:
    """Batched offline analysis: every input file becomes one pair of the
    device batch, so N files are analysed in the same dispatches one file
    would take — the device-batch counterpart of opening N plugin
    instances (no reference equivalent)."""
    from signalizer_tpu_torch.core.config import (
        BinInterpolation,
        SpectrumChannels,
        ViewScaling,
    )
    from signalizer_tpu_torch.core.constant import make_spectrum_constant
    from signalizer_tpu_torch.utils.readback import to_host
    from signalizer_tpu_torch.views.render import render_spectrum
    from signalizer_tpu_torch.views.spectrum import SpectrumProcessor
    from signalizer_tpu_torch.views.vectorscope import VectorscopeProcessor

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    loaded = [_load_wav(f, args.seconds) for f in args.inputs]
    fs = loaded[0][0]
    window = 4096
    n = len(loaded)
    frames = np.zeros((n, 1, 2, window), np.float32)
    tails = np.zeros((n, 2, window), np.float32)
    for i, (fs_i, audio) in enumerate(loaded):
        if fs_i != fs:
            print(f"note: {args.inputs[i]} has fs={fs_i:.0f}, batch assumes {fs:.0f}")
        take = min(window, audio.shape[1])
        ch = min(2, audio.shape[0])  # mono: zero-filled right surrogate,
        frames[i, 0, :ch, -take:] = audio[:ch, -take:]  # same as analyze
        tails[i, :ch, -take:] = audio[:ch, -take:]

    constant = make_spectrum_constant(
        axis_points=args.axis_points,
        window_size=window,
        sample_rate=fs,
        configuration=SpectrumChannels.SEPARATE,
        bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LOGARITHMIC,
        device=_device(args),
    )
    from signalizer_tpu_torch.core.constant import host_view

    spec = SpectrumProcessor(constant, pairs=n)
    rows = spec.process_to_host(frames)  # [n, 1, K, rows, P]
    vs = VectorscopeProcessor(pairs=n, device=constant.device)
    vout = vs.process(tails)
    balance = to_host(vout.balance)
    mapped = host_view(constant, "mapped_frequencies")
    low = host_view(constant, "low_dbs")
    high = host_view(constant, "high_dbs")
    written = 0
    for i, f in enumerate(args.inputs if _renders() else ()):
        stem = pathlib.Path(f).stem
        render_spectrum(rows[i, 0, 0], mapped, low_dbs=low, high_dbs=high,
                        path=str(out / f"{stem}.spectrum.png"))
        written += 1
    print(f"batch-analyzed {n} files in one device batch -> {written} renders in {out}")
    for i, f in enumerate(args.inputs):
        print(f"  {pathlib.Path(f).name}: stereo balance {float(balance[i, 0]):+.2f}")
    return 0


def cmd_editor(args) -> int:
    """Serve the interactive browser editor on a demo signal.

    The standalone analogue of opening the reference plugin's editor
    window: a main engine (plus a sidechained second instance so the
    graph tab has something to patch), an AnalysisSession over all four
    views, and the EditorShell HTTP app."""
    import numpy as np

    from signalizer_tpu_torch.editor import EditorShell
    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.session import AnalysisSession
    from signalizer_tpu_torch.stream.audio_stream import Playhead

    device = _device(args)
    eng = SignalizerEngine("main-track", device=device)
    side = SignalizerEngine("kick-bus", device=device)
    session = AnalysisSession(
        eng, axis_points=args.axis_points, pixels=args.pixels,
        cursor_fraction=0.5,
    )
    fs = eng.config.sample_rate
    st = {"t": 0, "phase": 0.0}

    def source(n: int) -> np.ndarray:
        i = np.arange(st["t"], st["t"] + n)
        st["t"] += n
        sec = i / fs
        f0 = 220.0 * 2.0 ** (0.5 * np.sin(2 * np.pi * 0.1 * sec))
        phase = st["phase"] + 2 * np.pi * np.cumsum(f0) / fs
        st["phase"] = float(phase[-1]) % (2 * np.pi)
        kick = 0.8 * np.sin(2 * np.pi * 60 * sec) * np.exp(-((sec % 0.5) * 18))
        side.process_block(
            np.stack([kick, kick]).astype(np.float32),
            Playhead(steady_clock=int(i[0]), bpm=120.0, is_playing=True),
        )
        left = 0.6 * np.sin(phase) + 0.15 * np.sin(2 * np.pi * 3000 * sec)
        right = 0.5 * np.sin(phase + 0.6) + 0.1 * np.sin(2 * np.pi * 880 * sec)
        return np.stack([left, right]).astype(np.float32)

    shell = EditorShell(
        session,
        source=source,
        playhead=Playhead(bpm=120.0, is_playing=True),
        port=args.port,
        device=device,
    )
    shell.start()
    print(f"editor: {shell.url}  (Ctrl+C to stop)")
    try:
        import time as _time

        while True:
            _time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        shell.stop()
        session.close()
        side.close()
    return 0


def cmd_presets(_args) -> int:
    from signalizer_tpu_torch.state.factory_presets import FACTORY_PRESETS

    for name in sorted(FACTORY_PRESETS):
        print(name)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m signalizer_tpu_torch")
    # --cpu works both before AND after the subcommand (the docstring's
    # trailing-flag form routes to the subparser)
    common = argparse.ArgumentParser(add_help=False)
    # SUPPRESS: a subparser default would otherwise overwrite a --cpu
    # given before the subcommand
    common.add_argument("--cpu", action="store_true", default=argparse.SUPPRESS,
                        help="run on the CPU (device=\"cpu\") instead of the GPU")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (device=\"cpu\") instead of the GPU")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pb = sub.add_parser("analyze-batch", parents=[common],
                        help="analyse many files as ONE device batch")
    pb.add_argument("inputs", nargs="+")
    pb.add_argument("--out", default="analysis_out")
    pb.add_argument("--axis-points", type=int, default=1024)
    pb.add_argument("--seconds", type=float, default=None)
    pb.set_defaults(fn=cmd_analyze_batch)
    pa = sub.add_parser("analyze", parents=[common],
                        help="analyse an audio file offline")
    pa.add_argument("input")
    pa.add_argument("--out", default="analysis_out")
    pa.add_argument("--views",
                    default="spectrum,oscilloscope,vectorscope,spectrogram")
    pa.add_argument("--preset", default=None,
                    help="a .sgn (reference) or named framework preset")
    pa.add_argument("--axis-points", type=int, default=1024)
    pa.add_argument("--pixels", type=int, default=1024)
    pa.add_argument("--seconds", type=float, default=None,
                    help="only analyse the first N seconds")
    pa.add_argument("--npz", action="store_true",
                    help="also dump raw render arrays as .npz")
    pa.set_defaults(fn=cmd_analyze)
    pe = sub.add_parser("editor", parents=[common],
                        help="serve the interactive browser editor")
    pe.add_argument("--port", type=int, default=8765)
    pe.add_argument("--axis-points", type=int, default=512)
    pe.add_argument("--pixels", type=int, default=512)
    pe.set_defaults(fn=cmd_editor)
    pp = sub.add_parser("presets", parents=[common], help="list factory presets")
    pp.set_defaults(fn=cmd_presets)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
