"""The port imports and runs with jax blocked and loads nothing of the JAX
package, refuses a missing GPU (asked for or by default), and builds nothing
when its kernel modules are imported."""

import contextlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
# modules of the JAX package the port may load: none, not even its jax-free
# ones (the port keeps its own copies of what it needs from them)
ALLOWED = set()


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )


def test_port_runs_with_jax_blocked():
    """With ``sys.modules['jax'] = None`` any jax import raises; the port
    still imports and a small SpectrumProcessor runs on the CPU. No module
    of the JAX package gets loaded."""
    proc = _run(
        """
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import signalizer_tpu_torch as st
        proc = st.SpectrumProcessor.create(
            pairs=2, device="cpu", axis_points=64, window_size=256,
            configuration=st.SpectrumChannels.SEPARATE,
            view_scaling=st.ViewScaling.LOGARITHMIC)
        out = proc.process(np.random.default_rng(0).standard_normal((2, 3, 2, 256)).astype(np.float32))
        assert tuple(out.shape) == (2, 3, 2, 2, 64), out.shape
        loaded = sorted(m for m in sys.modules if m.startswith("signalizer_tpu.") or m == "signalizer_tpu")
        print(" ".join(loaded))
        """
    )
    assert proc.returncode == 0, proc.stderr
    loaded = set(proc.stdout.split())
    assert loaded <= ALLOWED, loaded


def test_oscilloscope_runs_with_jax_blocked():
    """With jax blocked a CPU OscilloscopeProcessor (ZERO_CROSSING trigger,
    colour track) runs, finds each sine's trigger, and loads no module of
    the JAX package."""
    proc = _run(
        """
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import signalizer_tpu_torch as st
        p = st.OscilloscopeProcessor.create(
            pairs=2, device="cpu", sample_rate=48000.0, pixels=128,
            channel_mode=st.OscChannels.SEPARATE, trigger_mode=st.TriggerMode.ZERO_CROSSING,
            trigger_threshold=0.1, autogain=st.AutoGain.PEAK_DECAY, colour_enabled=True)
        x = np.sin(2 * np.pi * 440.0 * np.arange(4096) / 48000.0).astype(np.float32)
        f = p.process(np.broadcast_to(x, (2, 2, 4096)).copy())
        assert tuple(f.waveform.shape) == (2, 2, 128) and bool(f.trigger_found.all())
        assert tuple(f.colours.shape) == (2, 2, 128, 3)
        loaded = sorted(m for m in sys.modules if m.startswith("signalizer_tpu.") or m == "signalizer_tpu")
        print(" ".join(loaded))
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert set(proc.stdout.split()) <= ALLOWED, proc.stdout


def test_vectorscope_spectrogram_and_resonator_run_with_jax_blocked():
    """With jax blocked the three other views run on the CPU (the
    spectrogram by both ingest routes, byte for byte the same) and, after
    all five processors ran, no module of the JAX package is loaded."""
    proc = _run(
        """
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import signalizer_tpu_torch as st
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 2, 512)).astype(np.float32)
        st.SpectrumProcessor.create(pairs=2, device="cpu", axis_points=64, window_size=256).process(x[..., :256])
        st.OscilloscopeProcessor.create(pairs=2, device="cpu", pixels=64).process(x)
        for mode in st.OperationalMode:
            for gain in st.VectorscopeAutoGain:
                f = st.VectorscopeProcessor(pairs=2, device="cpu", mode=mode, autogain=gain).process(x, new_samples=100)
                assert tuple(f.vertices.shape) == (2, 512, 3) and np.isfinite(f.vertices.numpy()).all()
        cols = []
        for ingest in (True, False):
            sp = st.SpectrogramProcessor(pairs=2, device="cpu", axis_points=64, window_size=256, blob_ms=1.0,
                                         device_ingest=ingest)
            sp.push(x.reshape(4, 512))
            cols.append(sp.pull())
        assert cols[0].shape == (6, 64, 4) and cols[0].dtype == np.uint8 and np.array_equal(*cols)
        rs = st.ResonatorSpectrumProcessor.create(pairs=2, device="cpu", axis_points=64, window_size=256,
                                                  configuration=st.SpectrumChannels.SEPARATE)
        out = rs.process_chunks(x.reshape(2, 2, 4, 128), valid=[True, True, True, False])
        assert tuple(out.shape) == (2, 1, 2, 2, 64)
        loaded = sorted(m for m in sys.modules if m.startswith("signalizer_tpu.") or m == "signalizer_tpu")
        print(" ".join(loaded))
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert set(proc.stdout.split()) <= ALLOWED, proc.stdout


def test_phase_tail_and_resonator_scan_run_with_jax_blocked():
    """With jax blocked the plain versions of kernels G and H run on the CPU
    (the PHASE Spectrum, the PHASE and SEPARATE resonator banks, the scan
    with its readouts), count no launch, upload no mask, and no module of
    the JAX package is loaded."""
    proc = _run(
        """
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import signalizer_tpu_torch as st
        from signalizer_tpu_torch.utils.diagnostics import counter
        from signalizer_tpu_torch.kernels.resonator import init_resonator_state, resonate_chunks
        from signalizer_tpu_torch.stream import pinned
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 3, 2, 256)).astype(np.float32)
        p = st.SpectrumProcessor.create(pairs=2, device="cpu", axis_points=64, window_size=256,
                                        configuration=st.SpectrumChannels.PHASE)
        out = p.process(x)
        assert tuple(out.shape) == (2, 3, 2, 2, 64) and np.isfinite(out.numpy()).all()
        for cfg in (st.SpectrumChannels.PHASE, st.SpectrumChannels.SEPARATE):
            rs = st.ResonatorSpectrumProcessor.create(pairs=2, device="cpu", axis_points=64, window_size=256,
                                                      configuration=cfg)
            out = rs.process_chunks(x[:, 0].reshape(2, 2, 2, 128), valid=[True, False])
            assert tuple(out.shape) == (2, 1, 2, 2, 64) and np.isfinite(out.numpy()).all()
        state, ys = resonate_chunks(rs.resonator, init_resonator_state(rs.resonator, (2,)),
                                    rs._blocks(x[:, 0]).reshape(2, 4, 128), valid=[True] * 3 + [False],
                                    plan=rs.block_plan(128), emit_readouts=True)
        assert tuple(ys.shape) == (4, 2, 64) and bool((ys[3] == ys[2]).all())
        assert (counter("phase_decay_db.launches"), counter("resonator_scan.launches")) == (0, 0)
        assert pinned._mask_uploads == {}
        loaded = sorted(m for m in sys.modules if m.startswith("signalizer_tpu.") or m == "signalizer_tpu")
        print(" ".join(loaded))
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert set(proc.stdout.split()) <= ALLOWED, proc.stdout


def test_live_path_runs_with_jax_blocked():
    """With jax blocked the live ingest path runs on the CPU: a threaded
    16-channel stream with a second instance mixed in through the host and
    mix graphs, the device history mirror read by a Spectrum processor at a
    long window, an Oscilloscope and a Vectorscope, a frame pipeline, the
    exception log and a profile trace; no module of the JAX package gets
    loaded."""
    proc = _run(
        """
        import sys, tempfile
        sys.modules["jax"] = None
        import numpy as np
        import torch
        import signalizer_tpu_torch as st
        from signalizer_tpu_torch.native_bindings import native_available
        from signalizer_tpu_torch.state.serialize import Archive
        from signalizer_tpu_torch.stream import FramePipeline
        from signalizer_tpu_torch.stream.audio_stream import AudioStream, AudioStreamInfo, Playhead
        from signalizer_tpu_torch.stream.device_history import DevicePresentationHistory
        from signalizer_tpu_torch.stream.host_graph import HostGraph, PortPair
        from signalizer_tpu_torch.stream.mix_graph import MixGraph
        from signalizer_tpu_torch.utils import exception_log
        from signalizer_tpu_torch.utils.diagnostics import Diagnostics, profile_trace
        tmp = tempfile.mkdtemp()
        exception_log.set_exception_log_path(tmp + "/exceptions.log")
        inp, out = AudioStream.create(True, AudioStreamInfo(channels=16, audio_history_capacity=4096))
        peer_in, peer_out = AudioStream.create(False, AudioStreamInfo(channels=2, audio_history_capacity=4096))
        me, peer = HostGraph("me", channels=16), HostGraph("peer", channels=2)
        me.stream_output, peer.stream_output = out, peer_out
        mix = MixGraph(me, out, capacity=8192)
        for ch in range(2):
            me.connect(peer.node_id, PortPair(ch, 14 + ch))
        dh = DevicePresentationHistory(mix.presentation_output, device="cpu")
        spec = st.SpectrumProcessor.create(pairs=8, device="cpu", axis_points=64, window_size=3000)
        osc = st.OscilloscopeProcessor.create(pairs=8, device="cpu", pixels=64)
        vs = st.VectorscopeProcessor(pairs=8, device="cpu")
        rng = np.random.default_rng(0)
        diag = Diagnostics()
        for tick in range(6):
            peer_in.process_incoming_audio(rng.standard_normal((2, 800)).astype(np.float32), Playhead(steady_clock=800 * tick))
            inp.process_incoming_audio(rng.standard_normal((16, 800)).astype(np.float32), Playhead(steady_clock=800 * tick))
            assert inp._stream.wait_for_drain(timeout=5.0)
            dh.sync()
            w = dh.window(3000)
            assert np.array_equal(w.numpy(), mix.presentation_output.get_history(3000))
            s = spec.process(w.reshape(8, 2, 3000))
            f = osc.process(dh.window(2048).reshape(8, 2, 2048), new_samples=800)
            v = vs.process(dh.window(512).reshape(8, 2, 512))
            assert torch.isfinite(s).all() and torch.isfinite(v.vertices).all()
            diag.tick_frame()
        pipe = FramePipeline(lambda st_, fr: (fr.sum(), st_), device="cpu")
        assert len(list(pipe.run([np.ones(4, np.float32)] * 3))) == 3
        with profile_trace(tmp + "/trace") as tr:
            spec.process(dh.window(3000).reshape(8, 2, 3000))
        assert tr.path.exists()
        a = Archive(); me.serialize(a); assert Archive.from_bytes(a.to_bytes())["name"] == "me"
        assert native_available() and type(out._stream._history).__name__ == "NativeRingBuffer"
        assert out._stream._native_queue is not None
        mix.close(); inp._stream.close()
        loaded = sorted(m for m in sys.modules if m.startswith("signalizer_tpu.") or m == "signalizer_tpu")
        print(" ".join(loaded))
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert set(proc.stdout.split()) <= ALLOWED, proc.stdout


def test_engine_and_session_tick_with_jax_blocked():
    """With jax blocked a CPU SignalizerEngine loads its factory default
    preset, an AnalysisSession with all four views and the Transform
    tracker ticks (the fused tick included), an RSNT session ticks, the
    engine's archive round-trips, a reference .sgn preset exports and
    imports, and no module of the JAX package gets loaded."""
    proc = _run(
        """
        import sys, tempfile
        sys.modules["jax"] = None
        import numpy as np
        from signalizer_tpu_torch.engine import SignalizerEngine
        from signalizer_tpu_torch.session import AnalysisSession
        from signalizer_tpu_torch.state.serialize import Archive
        from signalizer_tpu_torch.state.sgn_import import load_sgn, save_sgn
        from signalizer_tpu_torch.stream.audio_stream import Playhead
        eng = SignalizerEngine("nojax", device="cpu")
        assert eng.num_parameters() == 201
        eng.spectrum.frequency_tracker.set_normalized(1 / 3)  # transform
        s = AnalysisSession(eng, axis_points=64, pixels=64, cursor_fraction=1000 / 24000)
        x = np.sin(2 * np.pi * 1000 * np.arange(8 * 800) / 48000).astype(np.float32)
        for i in range(8):
            s.feed(np.stack([x, x])[:, 800 * i: 800 * (i + 1)], Playhead(steady_clock=800 * (i + 1)))
            f = s.tick()
        assert f.spectrum.shape == (2, 1, 64) and f.tracker is not None and f.spectrogram_columns is not None
        c = eng.diagnostics.counters
        assert c["session.fused_ticks"] == c["session.ticks"] == 8 and c["session.failures"] == 0
        ar = Archive(); eng.serialize(ar)
        tmp = tempfile.mkdtemp()
        save_sgn(tmp + "/x.main.sgn", vectorscope=eng.vectorscope, oscilloscope=eng.oscilloscope,
                 spectrum=eng.spectrum, history_capacity=48000)
        s.close()
        eng2 = SignalizerEngine("nojax2", device="cpu", load_default_preset=False)
        eng2.deserialize(Archive.from_bytes(ar.to_bytes()))
        assert load_sgn(tmp + "/x.main.sgn").name == "main"
        eng2.spectrum.algorithm.set_normalized(1.0)  # RSNT
        s2 = AnalysisSession(eng2, views=("spectrum",), axis_points=64)
        for i in range(3):
            s2.feed(np.stack([x, x])[:, :1500], Playhead(steady_clock=1500 * (i + 1)))
            assert s2.tick().spectrum.shape == (2, 1, 64)
        s2.close()
        loaded = sorted(m for m in sys.modules if m.startswith("signalizer_tpu.") or m == "signalizer_tpu")
        print(" ".join(loaded))
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert set(proc.stdout.split()) <= ALLOWED, proc.stdout


def test_kernel_modules_import_without_nvcc_or_triton():
    """Importing the kernel wrappers runs no subprocess, looks for no
    compiler, loads no library and imports no triton: the build happens at
    the first launch on a CUDA tensor."""
    proc = _run(
        """
        import ctypes, shutil, subprocess, sys
        import numpy, numpy.testing, scipy.special, torch  # third-party set-up first
        calls = []
        def trap(name):
            def f(*a, **k):
                calls.append(name)
                raise AssertionError(name)
            return f
        subprocess.run = trap("subprocess.run")
        subprocess.Popen = trap("subprocess.Popen")
        shutil.which = trap("shutil.which")
        ctypes.CDLL = trap("ctypes.CDLL")
        import signalizer_tpu_torch.kernels.window_fft_mag
        import signalizer_tpu_torch.kernels.display_map
        import signalizer_tpu_torch.kernels.banded_resample
        import signalizer_tpu_torch.kernels.spectrum
        import signalizer_tpu_torch.kernels.oscilloscope
        import signalizer_tpu_torch.views.oscilloscope
        import signalizer_tpu_torch.views.vectorscope
        import signalizer_tpu_torch.views.spectrogram
        import signalizer_tpu_torch.kernels.resonator
        import signalizer_tpu_torch.native_bindings as nb
        import signalizer_tpu_torch.stream.audio_stream
        import signalizer_tpu_torch.stream.mix_graph
        import signalizer_tpu_torch.stream.device_history
        import signalizer_tpu_torch.stream.frame_pipeline
        import signalizer_tpu_torch.engine
        import signalizer_tpu_torch.session
        import signalizer_tpu_torch.views.fused_tick
        import signalizer_tpu_torch.views.content
        import signalizer_tpu_torch.state.factory_presets
        import signalizer_tpu_torch.state.sgn_import
        import signalizer_tpu_torch.kernels.peak_hold
        import signalizer_tpu_torch.kernels.colour_track as e
        import signalizer_tpu_torch.kernels.spectral_walk as f
        import signalizer_tpu_torch.kernels.phase_decay_db
        import signalizer_tpu_torch.kernels.resonator_scan
        import signalizer_tpu_torch.stream.pinned
        import signalizer_tpu_torch.parallel.pipeline
        import signalizer_tpu_torch.views.render
        import signalizer_tpu_torch.editor
        import signalizer_tpu_torch.api
        import signalizer_tpu_torch.__main__
        from signalizer_tpu_torch.kernels import _build
        assert calls == [], calls
        assert "triton" not in sys.modules
        assert _build.library.cache_info().currsize == 0
        assert nb._lib is None and nb._build_error is None
        from signalizer_tpu_torch.utils.diagnostics import counter
        launches = ("window_fft_mag.launches", "window_fft_mag.cluster_launches", "window_fft_mag.long_launches",
                    "display_map.launches", "display_map.remap_launches", "display_map.decay_db_launches",
                    "banded_resample.launches", "peak_hold.launches", "colour_track.launches",
                    "spectral_walk.launches", "phase_decay_db.launches", "resonator_scan.launches")
        assert [counter(name) for name in launches] == [0] * 12
        assert signalizer_tpu_torch.stream.pinned._mask_uploads == {}
        assert f.last_passes is None
        assert e._device_table.cache_info().currsize == 0
        print("ok")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: without a CUDA toolkit the build raises and names nvcc."""
    from signalizer_tpu_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_build_names_the_library_by_its_sources():
    """The library's file name is a hash of every csrc file and the flags,
    so an edited kernel never loads a stale build."""
    from signalizer_tpu_torch.kernels import _build

    names = {p.name for p in _build._sources()}
    assert {"window_fft_mag.cu", "window_fft_mag_cluster.cu", "window_fft_mag_long.cu", "window_fft_common.cuh",
            "display_map.cu", "display_decay_db.cu", "banded_resample.cu", "peak_hold.cu", "colour_track.cu",
            "spectral_walk.cu", "phase_decay_db.cu", "resonator_scan.cu", "colormap.cu", "phase_values.cu"} <= names
    assert _build._digest() == _build._digest()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert set(_build.SIGNATURES) == {
        "sig_window_fft_mag", "sig_window_fft_mag_cluster", "sig_window_fft_mag_long", "sig_display_map",
        "sig_display_remap", "sig_display_decay_db", "sig_banded_resample", "sig_banded_resample_affine",
        "sig_peak_hold", "sig_envelope_hold", "sig_colour_split", "sig_colour_track", "sig_spectral_walk",
        "sig_spectral_walk_spectrum", "sig_phase_decay_db", "sig_resonator_scan", "sig_colormap",
        "sig_phase_values",
    }


@pytest.mark.parametrize("accessor", ["raw", "public"])
@pytest.mark.parametrize("current", [0, 1])
def test_launch_appends_the_stream_and_switches_device_only_when_needed(monkeypatch, current, accessor):
    """``_build.launch`` calls the entry with the device's current stream
    last (torch's raw accessor, or the public Stream where torch lacks it),
    makes the device current only when it is not, and raises through
    ``check`` naming the caller."""
    from signalizer_tpu_torch.kernels import _build

    calls, switched, err = [], [], [0]
    lib = SimpleNamespace(sig_fake=lambda *a: calls.append(a) or err[0], sig_error_string=lambda e: b"fake error")
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", lambda index: switched.append(index) or contextlib.nullcontext())
    if accessor == "raw":
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index, raising=False)
    else:
        monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream", raising=False)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda index: SimpleNamespace(cuda_stream=1000 + index))
    _build.launch("sig_fake", torch.device("cuda", 1), 7, None, 2.5, name="fake_kernel")
    assert calls == [(7, None, 2.5, 1001)]
    assert switched == ([] if current == 1 else [1])
    err[0] = 700
    with pytest.raises(RuntimeError, match=r"^fake_kernel failed: cudaError_t 700 \(fake error\)$"):
        _build.launch("sig_fake", torch.device("cuda", 1), name="fake_kernel")
    assert calls[-1] == (1001,)


def test_only_build_calls_the_c_entries():
    """Every kernel launches through ``_build.launch``: no other file of the
    port calls ``library()``, and none of them, chip_smoke.py or the card
    tests reads a stream handle or names a ``sig_*`` entry."""
    import ast

    build = REPO / "signalizer_tpu_torch" / "kernels" / "_build.py"
    port = [p for p in sorted((REPO / "signalizer_tpu_torch").rglob("*.py")) if p != build]
    assert len(port) > 15
    for path in port + [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("cuda_stream", "_cuda_getCurrentRawStream"), f"{path}: {node.attr}"
                assert not node.attr.startswith("sig_"), f"{path}: calls {node.attr} outside _build.launch"
            if path in port and isinstance(node, ast.Call):
                f = node.func
                assert getattr(f, "attr", getattr(f, "id", None)) != "library", f"{path}: calls library()"


def test_cuda_processor_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU refusal is not reachable")
    from signalizer_tpu_torch import SpectrumProcessor

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        SpectrumProcessor.create(pairs=1, device="cuda", axis_points=32, window_size=128)


def test_port_sources_import_nothing_of_the_jax_package():
    """No file of the port, and not chip_smoke.py, has an import statement
    naming jax or the JAX package (docstrings may name the counterpart a
    module was ported from)."""
    import ast

    files = sorted((REPO / "signalizer_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "signalizer_tpu"), f"{path}: imports {name}"


@pytest.mark.parametrize(
    "entry",
    [
        "spectrum_create",
        "oscilloscope_create",
        "make_spectrum_constant",
        "make_oscilloscope_constant",
        "constant_from_arrays",
        "line_graph_state_from_arrays",
        "oscilloscope_state_from_arrays",
        "init_crossover_state",
        "sinc_resample_matrix",
        "vectorscope",
        "spectrogram",
        "resonator_create",
        "meter_state_from_arrays",
        "resonator_state_from_arrays",
        "make_resonator_constant",
        "device_presentation_history",
        "frame_pipeline",
        "signalizer_engine",
        "analysis_session",
        "make_analysis_mesh",
        "sharded_pipeline",
        "editor_shell",
    ],
)
def test_default_device_is_the_gpu_and_raises_without_one(entry):
    """With no ``device`` given every entry point asks for the GPU: without
    one it raises and names torch.cuda.is_available; it never carries on on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU refusal is not reachable")
    import numpy as np

    import signalizer_tpu_torch as st
    from signalizer_tpu_torch.core import constant as tc
    from signalizer_tpu_torch.kernels import filters as tf
    from signalizer_tpu_torch.kernels import oscilloscope as tk
    from signalizer_tpu_torch.kernels import resonator as tres
    from signalizer_tpu_torch.kernels import spectrum as ts
    from signalizer_tpu_torch.kernels import vectorscope as tvs
    from signalizer_tpu_torch.stream import FramePipeline
    from signalizer_tpu_torch.stream.audio_stream import AudioStream, AudioStreamInfo
    from signalizer_tpu_torch.stream.device_history import DevicePresentationHistory
    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.session import AnalysisSession
    from signalizer_tpu_torch.views import oscilloscope as tv
    from signalizer_tpu_torch.editor import EditorShell
    from signalizer_tpu_torch.parallel.mesh import make_analysis_mesh
    from signalizer_tpu_torch.parallel.pipeline import ShardedAnalysisPipeline

    cpu = tc.make_spectrum_constant(axis_points=32, window_size=128, device="cpu")
    static = {name: getattr(cpu, name) for name in tc.STATIC_FIELDS}
    arrays = {name: getattr(cpu, name).numpy() for name in tc.ARRAY_FIELDS}
    osc = tv.OscilloscopeProcessor.create(pairs=1, device="cpu", pixels=32)
    calls = {
        "spectrum_create": lambda: st.SpectrumProcessor.create(pairs=1, axis_points=32, window_size=128),
        "oscilloscope_create": lambda: st.OscilloscopeProcessor.create(pairs=1, pixels=32),
        "make_spectrum_constant": lambda: tc.make_spectrum_constant(axis_points=32, window_size=128),
        "make_oscilloscope_constant": lambda: tv.make_oscilloscope_constant(pixels=32),
        "constant_from_arrays": lambda: tc.constant_from_arrays(static, arrays),
        "line_graph_state_from_arrays": lambda: ts.line_graph_state_from_arrays(
            np.zeros((1, 2, 1, 32), np.float32), np.zeros((1, 2, 32), np.float32)
        ),
        "oscilloscope_state_from_arrays": lambda: tv.oscilloscope_state_from_arrays(osc.state),
        "init_crossover_state": lambda: tf.init_crossover_state((1, 2)),
        "sinc_resample_matrix": lambda: tk.sinc_resample_matrix(64, 0.0, 1.0, 16),
        "vectorscope": lambda: st.VectorscopeProcessor(pairs=1),
        "spectrogram": lambda: st.SpectrogramProcessor(pairs=1, axis_points=32, window_size=128),
        "resonator_create": lambda: st.ResonatorSpectrumProcessor.create(pairs=1, axis_points=32, window_size=128),
        "meter_state_from_arrays": lambda: tvs.meter_state_from_arrays(
            np.zeros((1, 2)), np.zeros((1, 2, 2)), np.zeros((1, 2)), np.ones(1)
        ),
        "resonator_state_from_arrays": lambda: tres.resonator_state_from_arrays(np.zeros((1, 1, 4, 3, 2))),
        "make_resonator_constant": lambda: tres.make_resonator_constant(np.linspace(100.0, 1000.0, 4), 48000.0, 128),
        "device_presentation_history": lambda: DevicePresentationHistory(
            AudioStream.create(False, AudioStreamInfo(channels=2, audio_history_capacity=64))[1]
        ),
        "frame_pipeline": lambda: FramePipeline(lambda s, f: (f, s)),
        "signalizer_engine": lambda: SignalizerEngine("no-gpu"),
        "analysis_session": lambda: AnalysisSession(SignalizerEngine("no-gpu")),
        "make_analysis_mesh": lambda: make_analysis_mesh(),
        "sharded_pipeline": lambda: ShardedAnalysisPipeline(cpu, pairs=1),
        "editor_shell": lambda: EditorShell(AnalysisSession(SignalizerEngine("cpu", device="cpu"),
                                                            views=("spectrum",), axis_points=32, pixels=32)),
    }
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        calls[entry]()
    assert tc.resolve_device("cpu") == torch.device("cpu")


def test_pipeline_cli_editor_and_api_run_with_jax_blocked(tmp_path):
    """With jax blocked the multi-device pipeline runs every view on a CPU
    mesh of one and two shards, the CLI analyses WAV files
    (``analyze-batch`` and ``analyze --npz``), an editor shell ticks and
    serves a payload of every view and the spectrogram PNG, and the api
    facade imports; no module of the JAX package is loaded."""
    proc = _run(
        f"""
        import sys
        sys.modules["jax"] = None
        import json, time, urllib.request
        import numpy as np
        from scipy.io import wavfile
        import signalizer_tpu_torch.api as api
        from signalizer_tpu_torch.core.constant import make_spectrum_constant
        from signalizer_tpu_torch.parallel.pipeline import ShardedAnalysisPipeline
        from signalizer_tpu_torch.__main__ import main
        rng = np.random.default_rng(0)
        c = make_spectrum_constant(device="cpu", axis_points=64, window_size=256)
        for mesh in (["cpu"], ["cpu", "cpu"]):
            for view in ("fused", "spectrum", "spectrogram", "oscilloscope", "vectorscope"):
                pipe = ShardedAnalysisPipeline(c if view in ("fused", "spectrum", "spectrogram") else None,
                                               pairs=2, mesh=mesh, view=view, frames_per_tick=2, pixels=32,
                                               history_samples=1024)
                pipe.push(rng.standard_normal((4, 1024)).astype(np.float32))
                assert pipe.tick() is not None, view
        d = {str(tmp_path)!r}
        for i in range(2):
            wavfile.write(f"{{d}}/in{{i}}.wav", 48000, (0.3 * rng.standard_normal((12000, 2))).astype(np.float32))
        assert main(["--cpu", "analyze-batch", f"{{d}}/in0.wav", f"{{d}}/in1.wav", "--out", f"{{d}}/b",
                     "--axis-points", "64"]) == 0
        assert main(["analyze", f"{{d}}/in0.wav", "--out", f"{{d}}/a", "--axis-points", "64", "--pixels", "64",
                     "--npz", "--cpu"]) == 0
        assert np.load(f"{{d}}/a/in0.arrays.npz")["waveform"].shape[-1] == 64
        eng = api.SignalizerEngine("nojax", device="cpu")
        eng.editor_settings.refresh_rate_ms = 30.0
        sess = api.AnalysisSession(eng, axis_points=64, pixels=64)
        sh = api.EditorShell(sess, source=lambda n: (0.3 * rng.standard_normal((2, n))).astype(np.float32),
                             playhead=api.Playhead(is_playing=True), device="cpu")
        sh.start()
        get = lambda p: urllib.request.urlopen(sh.url.rstrip("/") + p, timeout=30).read()
        deadline = time.time() + 60
        while json.loads(get("/api/state"))["ticks"] < 3 and time.time() < deadline:
            time.sleep(0.05)
        for view in ("spectrum", "oscilloscope", "vectorscope", "spectrogram"):
            assert json.loads(get("/api/frame/" + view))["ready"], view
        assert get("/api/spectrogram.png")[:4] == b"\\x89PNG"
        sh.stop(); sess.close(); eng.close()
        loaded = sorted(m for m in sys.modules if m.startswith("signalizer_tpu.") or m == "signalizer_tpu")
        print("loaded:", *loaded)
        """
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.splitlines()[-1].split()  # the CLI printed before it
    assert last[0] == "loaded:" and set(last[1:]) <= ALLOWED, proc.stdout
