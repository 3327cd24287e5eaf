"""The port's front ends against the JAX package's, on the CPU: the PNG
encoder, the editor's page and widget models, the offline renderers, the
editor server's endpoints (``device="cpu"``), the CLI
(``python -m signalizer_tpu_torch --cpu``) and the api facade.

Copies are held equal to their originals: PNG bytes, the served page, the
widget descriptors and tiers. Computed arrays are held at the per-view
tolerances (none widened): spectrum display values rtol/atol 1e-5
(tests/test_torch_spectrum.py; the CLI's inside the drawn range, see its
test), oscilloscope waveform 2e-6 x max(1, gain)
(tests/test_torch_osc_view.py), vectorscope vertices 2e-6 x gain and bars
2e-6 (tests/test_torch_vectorscope.py), spectrogram bytes within 1 LSB on
at most 0.1% of them (tests/test_torch_spectrogram.py). The editor's JSON
payloads round to 4 decimals, so there the bound is those tolerances plus
one unit of the 4th decimal (1e-4).
"""

import json
import os
import struct
import subprocess
import sys
import time
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FS = 48_000.0


# ---------------------------------------------------------------------------
# copies: PNG, page, widgets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (64, 33)])
def test_png_bytes_equal_the_original(shape):
    from signalizer_tpu.utils.png import encode_png as jpng
    from signalizer_tpu_torch.utils.png import encode_png as tpng

    img = np.random.default_rng(shape[0]).integers(0, 256, shape + (4,), dtype=np.uint8)
    data = tpng(img)
    assert data == jpng(img)
    w, h = struct.unpack(">II", data[16:24])
    idat = data[data.find(b"IDAT") + 4 : data.find(b"IEND") - 4]
    assert (h, w) == shape and len(zlib.decompress(idat)) == h * (1 + w * 4)
    with pytest.raises(ValueError):
        tpng(np.zeros((4, 4, 3), np.uint8))


def test_index_html_equals_the_original():
    from signalizer_tpu.editor.static import INDEX_HTML as jhtml
    from signalizer_tpu_torch.editor.static import INDEX_HTML as thtml

    assert thtml == jhtml


@pytest.mark.parametrize("name", ["SpectrumContent", "OscilloscopeContent", "VectorScopeContent"])
def test_widget_pages_equal_the_original(name):
    """Every page, section and widget descriptor the port's widget models
    serve equals the JAX package's, for a fresh content and after edits."""
    from signalizer_tpu.editor import widgets as jw
    from signalizer_tpu.views import content as jc
    from signalizer_tpu_torch.editor import widgets as tw
    from signalizer_tpu_torch.views import content as tc

    jcontent, tcontent = getattr(jc, name)(), getattr(tc, name)()
    assert tw.describe_pages(tcontent) == jw.describe_pages(jcontent)
    for content in (jcontent, tcontent):
        for i, p in enumerate(list(content.parameter_set)[:12]):
            p.set_normalized((0.17 * (i + 1)) % 1.0)
    assert tw.describe_pages(tcontent) == jw.describe_pages(jcontent)
    assert tw.TIERS == jw.TIERS
    for p in tcontent.parameter_set:
        assert tw.tier_of(tcontent.NAME, p.name) == jw.tier_of(jcontent.NAME, p.name)


# ---------------------------------------------------------------------------
# the renderers
# ---------------------------------------------------------------------------


def _lines(fig):
    return [line.get_xydata() for ax in fig.axes for line in ax.get_lines()]


def test_render_spectrum_and_spectrogram_equal_the_jax_renderers():
    pytest.importorskip("matplotlib")
    from signalizer_tpu.views import render as jr
    from signalizer_tpu_torch.views import render as tr

    f = np.geomspace(10, 24000, 200)
    rows = np.random.default_rng(0).random((2, 200)).astype(np.float32)
    jfig = jr.render_spectrum(rows, f, labels=["a", "b"])
    tfig = tr.render_spectrum(torch.from_numpy(rows), torch.from_numpy(f), labels=["a", "b"])
    for a, b in zip(_lines(tfig), _lines(jfig), strict=True):
        np.testing.assert_array_equal(a, b)
    img = np.random.default_rng(2).integers(0, 255, (5, 8, 4)).astype(np.uint8)
    jimg = jr.render_spectrogram(img).axes[0].get_images()[0].get_array()
    timg = tr.render_spectrogram(torch.from_numpy(img)).axes[0].get_images()[0].get_array()
    np.testing.assert_array_equal(np.asarray(timg), np.asarray(jimg))


def test_render_oscilloscope_and_vectorscope_on_port_frames():
    """Port frames (tensors) and JAX frames of the same histories render the
    same plots: line data within the views' tolerances."""
    pytest.importorskip("matplotlib")
    from signalizer_tpu.views import render as jr
    from signalizer_tpu.views.oscilloscope import OscilloscopeProcessor as JOsc
    from signalizer_tpu.views.vectorscope import VectorscopeProcessor as JVs
    from signalizer_tpu_torch.views import render as tr
    from signalizer_tpu_torch.views.oscilloscope import OscilloscopeProcessor as TOsc
    from signalizer_tpu_torch.views.vectorscope import VectorscopeProcessor as TVs

    hist = (np.random.default_rng(1).standard_normal((2, 2, 4096)) * 0.5).astype(np.float32)
    kw = dict(pairs=2, pixels=64, window_samples=512.0)
    jo, to = JOsc(**kw).process(hist), TOsc.create(device="cpu", **kw).process(hist)
    hints = {"show_legend": True, "primitive_size": 1.0}
    jl, tl = _lines(jr.render_oscilloscope(jo, hints=hints)), _lines(tr.render_oscilloscope(to, hints=hints))
    gain = max(1.0, float(np.abs(np.asarray(jo.gain)).max()))
    assert len(tl) == len(jl) == 2 * 2
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=2e-6 * gain, rtol=0)
    jv, tv = JVs(pairs=2).process(hist[..., :256]), TVs(pairs=2, device="cpu").process(hist[..., :256])
    jfig, tfig = jr.render_vectorscope(jv), tr.render_vectorscope(tv)
    vgain = max(1.0, float(np.abs(np.asarray(jv.gain)).max()))
    joff = [c.get_offsets() for c in jfig.axes[0].collections]
    toff = [c.get_offsets() for c in tfig.axes[0].collections]
    assert len(toff) == len(joff) == 2
    for a, b in zip(toff, joff):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-6 * vgain, rtol=0)
    assert tfig.axes[0].get_title() == jfig.axes[0].get_title()


def test_render_line_graph_frame_equals_the_jax_renderer():
    pytest.importorskip("matplotlib")
    from signalizer_tpu.core.constant import make_spectrum_constant as jconst
    from signalizer_tpu.views import render as jr
    from signalizer_tpu.views.content import SpectrumContent as JContent
    from signalizer_tpu_torch.core.constant import make_spectrum_constant as tconst
    from signalizer_tpu_torch.views import render as tr
    from signalizer_tpu_torch.views.content import SpectrumContent as TContent

    kw = dict(axis_points=128, window_size=512)
    results = np.random.default_rng(0).random((1, 1, 2, 2, 128)).astype(np.float32)
    jframe = JContent().make_render_feed(jconst(**kw), pairs=1).build(results[:, -1])
    tframe = TContent().make_render_feed(tconst(device="cpu", **kw), pairs=1).build(results[:, -1])
    tracker = {"frequency": 1000.0, "dbs": -12.0, "note": "B5"}
    jl = _lines(jr.render_line_graph_frame(jframe, tracker=tracker))
    tl = _lines(tr.render_line_graph_frame(tframe, tracker=tracker))
    assert len(tl) == len(jl) > 0
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the editor server (device="cpu")
# ---------------------------------------------------------------------------


def _tone_source(state):
    def src(n):
        i = np.arange(state["t"], state["t"] + n)
        state["t"] += n
        x = (0.5 * np.sin(2 * np.pi * 1000 * i / FS)).astype(np.float32)
        return np.stack([x, 0.7 * x])

    return src


@pytest.fixture(scope="module")
def shell():
    from signalizer_tpu_torch.editor import EditorShell
    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.session import AnalysisSession
    from signalizer_tpu_torch.stream.audio_stream import Playhead

    eng = SignalizerEngine("ed-main", device="cpu")
    side = SignalizerEngine("ed-side", device="cpu")
    sess = AnalysisSession(eng, axis_points=128, pixels=128, cursor_fraction=0.5)
    sh = EditorShell(sess, source=_tone_source({"t": 0}), playhead=Playhead(bpm=120.0, is_playing=True),
                     device="cpu")
    eng.editor_settings.refresh_rate_ms = 30.0
    sh.start()
    deadline = time.time() + 60
    while time.time() < deadline and _get(sh, "/api/state")["ticks"] < 3:
        time.sleep(0.1)
    yield sh, eng, sess, side
    sh.stop()
    sess.close()
    eng.close()
    side.close()


def _raw(sh, path):
    with urllib.request.urlopen(sh.url.rstrip("/") + path, timeout=30) as r:
        return r.read()


def _get(sh, path):
    return json.loads(_raw(sh, path))


def _post(sh, path, body, headers=None):
    req = urllib.request.Request(
        sh.url.rstrip("/") + path, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_editor_state_page_and_layouts(shell):
    from signalizer_tpu_torch.editor.static import INDEX_HTML

    sh = shell[0]
    s = _get(sh, "/api/state")
    assert s["tabs"] == ["spectrum", "oscilloscope", "vectorscope", "spectrogram", "graph", "global"]
    assert s["engine"] == "ed-main"
    assert _wait(lambda: _get(sh, "/api/state")["ticks"] > s["ticks"])
    assert _raw(sh, "/").decode() == INDEX_HTML
    for view in ("spectrum", "oscilloscope", "vectorscope", "spectrogram"):
        lay = _get(sh, f"/api/layout/{view}")
        assert lay["pages"] and lay["set"] in ("Spectrum", "Oscilloscope", "Vectorscope")


def test_editor_frame_payloads_and_png(shell):
    sh = shell[0]
    assert _wait(lambda: _get(sh, "/api/frame/spectrum").get("strips"))
    f = _get(sh, "/api/frame/spectrum")
    assert len(f["strips"][0]["y"]) == 128 and f["grid"] and f["db_grid"]
    fo = _get(sh, "/api/frame/oscilloscope")
    assert fo["shape"][2] == 128 and "colours_u8" in fo
    fv = _get(sh, "/api/frame/vectorscope")
    assert len(fv["balance"][0]) == 2
    assert _get(sh, "/api/frame/spectrogram")["height"] > 0
    png = _raw(sh, "/api/spectrogram.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", png[16:24])
    idat = png[png.find(b"IDAT") + 4 : png.find(b"IEND") - 4]
    assert w > 0 and h == 128 and len(zlib.decompress(idat)) == h * (1 + w * 4)


def test_editor_param_graph_presets_and_settings(shell, tmp_path, monkeypatch):
    sh, eng, sess, side = shell
    r = _post(sh, "/api/param", {"set": "Spectrum", "name": "Grid.R", "normalized": 0.9})
    assert r["tier"] == "feed" and abs(r["normalized"] - 0.9) < 1e-6
    assert "error" in _post(sh, "/api/param", {"set": "Nope", "name": "x", "normalized": 0.1})
    assert "error" in _post(sh, "/api/param", {"set": "Spectrum", "name": "Nope", "normalized": 0.1})
    g = _get(sh, "/api/graph")
    sid = side.host_graph.node_id.hex()
    assert g["self"] == eng.host_graph.node_id.hex() and any(n["id"] == sid for n in g["nodes"])
    r = _post(sh, "/api/graph/connect", {"src": sid, "src_ch": 0, "dst_ch": 1})
    assert r["ok"] and any(e["src"] == sid for e in r["edges"])
    r = _post(sh, "/api/graph/connect", {"src": sid, "src_ch": 0, "dst_ch": 1, "disconnect": True})
    assert r["ok"] and not any(e["src"] == sid for e in r["edges"])
    assert "renamed" in str(_post(sh, "/api/graph/rename", {"name": "renamed-main"})["nodes"])
    _post(sh, "/api/graph/rename", {"name": "ed-main"})
    with pytest.raises(urllib.error.HTTPError) as err:
        req = urllib.request.Request(sh.url + "api/freeze", data=b"{}", method="POST",
                                     headers={"Content-Type": "text/plain"})
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 415
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(sh, "/api/freeze", {"freeze": True}, headers={"Origin": "http://evil.example"})
    assert err.value.code == 403
    assert _post(sh, "/api/freeze", {"freeze": True})["freeze"] is True
    assert _post(sh, "/api/freeze", {"freeze": False})["freeze"] is False
    s = _post(sh, "/api/settings", {"refresh_rate_ms": 55.0, "hide_tabs": False})
    assert s["refresh_rate_ms"] == 55.0 and s["hide_tabs"] is False
    _post(sh, "/api/settings", {"refresh_rate_ms": 30.0, "hide_tabs": True})
    assert "presets" in _get(sh, "/api/presets")
    assert "tail" in _get(sh, "/api/exceptions")


def test_editor_shell_refuses_a_session_on_another_device():
    from signalizer_tpu_torch.editor import EditorShell
    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.session import AnalysisSession

    eng = SignalizerEngine("ed-dev", device="cpu")
    sess = AnalysisSession(eng, views=("spectrum",), axis_points=64, pixels=64)
    try:
        with pytest.raises((RuntimeError, ValueError)):
            EditorShell(sess)  # None: the GPU (raises without one, or names another device)
    finally:
        sess.close()
        eng.close()


def test_editor_frame_payloads_match_the_jax_editor():
    """The same blocks through a JAX session and a port session, one tick
    each into an unstarted shell: every payload of the four views holds the
    same keys, and its numbers agree within the views' tolerances plus the
    payload's rounding."""
    from signalizer_tpu.editor import EditorShell as JShell
    from signalizer_tpu.engine import SignalizerEngine as JEngine
    from signalizer_tpu.session import AnalysisSession as JSession
    from signalizer_tpu.stream.audio_stream import Playhead as JPlayhead
    from signalizer_tpu_torch.editor import EditorShell as TShell
    from signalizer_tpu_torch.engine import SignalizerEngine as TEngine
    from signalizer_tpu_torch.session import AnalysisSession as TSession
    from signalizer_tpu_torch.stream.audio_stream import Playhead as TPlayhead

    jeng, teng = JEngine("pay"), TEngine("pay", device="cpu")
    kw = dict(axis_points=128, pixels=128)
    jsess, tsess = JSession(jeng, **kw), TSession(teng, **kw)
    jsh, tsh = JShell(jsess), TShell(tsess, device="cpu")
    src = _tone_source({"t": 0})
    try:
        for i in range(6):
            x = src(800)
            jsess.feed(x, JPlayhead(steady_clock=800 * (i + 1), is_playing=True))
            tsess.feed(x, TPlayhead(steady_clock=800 * (i + 1), is_playing=True))
            jf, tf = jsess.tick(), tsh._host_frame(tsess.tick())
        jsh._frame, tsh._frame = jf, tf
        for view in ("spectrum", "oscilloscope", "vectorscope", "spectrogram"):
            jp, tp = jsh._frame_payload(view), tsh._frame_payload(view)
            assert sorted(tp) == sorted(jp), view
            _close(tp, jp, view)
    finally:
        for s in (jsh, tsh):
            s._server.server_close()
        jsess.close()
        tsess.close()
        jeng.close()
        teng.close()


def _close(got, want, where, atol=1e-4 + 2e-6):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}", atol)
    elif isinstance(want, list) and want and isinstance(want[0], (dict, str)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]", atol)
    elif isinstance(want, (list, float, int)) and not isinstance(want, bool):
        np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), atol=atol, rtol=1e-5,
                                   err_msg=where)
    elif where.endswith("colours_u8"):
        a = np.frombuffer(__import__("base64").b64decode(got), np.uint8).astype(int)
        b = np.frombuffer(__import__("base64").b64decode(want), np.uint8).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, where
    else:
        assert got == want, where


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(package, *args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", package, *args], capture_output=True, text=True, cwd=cwd,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    from scipy.io import wavfile

    d = tmp_path_factory.mktemp("wav")
    rng = np.random.default_rng(0)
    t = np.arange(int(FS * 0.5)) / FS
    paths = []
    for i in range(2):
        x = np.stack([0.5 * np.sin(2 * np.pi * 440 * (i + 1) * t), 0.3 * np.sin(2 * np.pi * 660 * (i + 1) * t)])
        x = x + 0.01 * rng.standard_normal(x.shape)
        paths.append(d / f"in{i}.wav")
        wavfile.write(paths[-1], int(FS), x.T.astype(np.float32))
    return d, paths


def test_cli_analyze_npz_matches_the_jax_cli(wavs):
    pytest.importorskip("matplotlib")
    d, paths = wavs
    args = ["analyze", str(paths[0]), "--axis-points", "128", "--pixels", "128", "--npz", "--cpu"]
    out_t = _cli("signalizer_tpu_torch", *args, "--out", "port", cwd=d)
    _cli("signalizer_tpu", *args, "--out", "jax", cwd=d)
    assert "5 outputs" in out_t
    t, j = np.load(d / "port" / "in0.arrays.npz"), np.load(d / "jax" / "in0.arrays.npz")
    assert sorted(t.files) == sorted(j.files) == ["spectrogram", "spectrum", "vertices", "waveform"]
    # the display values inside the drawn range at the spectrum's
    # tolerance; below it (v < 0, drawn clipped at the floor: a null between
    # the tones, where the dB map magnifies another FFT's rounding) both
    # stay below it
    inside = j["spectrum"] >= 0
    np.testing.assert_allclose(t["spectrum"][inside], j["spectrum"][inside], rtol=1e-5, atol=1e-5)
    assert np.array_equal(t["spectrum"] >= 0, inside)
    np.testing.assert_allclose(t["waveform"], j["waveform"], atol=2e-6 * 4.0, rtol=0)
    np.testing.assert_allclose(t["vertices"], j["vertices"], atol=2e-6 * 4.0, rtol=0)
    diff = np.abs(t["spectrogram"].astype(int) - j["spectrogram"].astype(int))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size
    for view in ("spectrum", "oscilloscope", "vectorscope", "spectrogram"):
        assert (d / "port" / f"in0.{view}.png").stat().st_size > 1000


def test_cli_analyze_batch_matches_the_jax_cli(wavs):
    pytest.importorskip("matplotlib")
    d, paths = wavs
    args = ["analyze-batch", *map(str, paths), "--axis-points", "256"]
    out_t = _cli("signalizer_tpu_torch", "--cpu", *args, "--out", "pb", cwd=d)
    out_j = _cli("signalizer_tpu", "--cpu", *args, "--out", "jb", cwd=d)
    assert out_t.splitlines()[1:] == out_j.splitlines()[1:]  # the per-file balance lines
    assert (d / "pb" / "in1.spectrum.png").stat().st_size > 1000


def test_cli_without_matplotlib_writes_arrays_and_says_it_drew_nothing(wavs):
    """Where matplotlib is not installed the CLI still analyses: ``analyze
    --npz`` writes the arrays, ``analyze-batch`` prints the balances, no PNG
    is written, and stderr says why."""
    d, paths = wavs
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "from signalizer_tpu_torch.__main__ import main\n"
        f"assert main(['--cpu', 'analyze', {str(paths[0])!r}, '--out', 'nompl', '--npz', '--axis-points', '64',"
        " '--pixels', '64']) == 0\n"
        f"assert main(['--cpu', 'analyze-batch', {str(paths[0])!r}, {str(paths[1])!r}, '--out', 'nomplb']) == 0\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=d, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stderr.count("matplotlib is not installed") == 2
    assert sorted(p.name for p in (d / "nompl").iterdir()) == ["in0.arrays.npz"]
    assert not (d / "nomplb").exists() or not list((d / "nomplb").glob("*.png"))
    assert "0 renders" in proc.stdout and proc.stdout.count("stereo balance") == 2


def test_cli_presets_and_the_gpu_default():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "signalizer_tpu_torch", "presets"], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0 and "peak trigger.oscilloscope" in out.stdout.splitlines()
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-m", "signalizer_tpu_torch", "analyze-batch", "missing.wav"],
                              capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
        assert proc.returncode != 0


# ---------------------------------------------------------------------------
# the api facade
# ---------------------------------------------------------------------------

EXPECTED = {
    # engine / host integration (ref: AudioProcessor shell)
    "SignalizerEngine", "ConcurrentConfig",
    # configuration enums
    "BinInterpolation", "DisplayMode", "OscChannels", "SpectrumChannels",
    "TransformAlgorithm", "ViewScaling", "WindowType",
    # constants + windows
    "SpectrumConstant", "make_spectrum_constant", "generate_window",
    # view processors + frames
    "SpectrumProcessor", "ResonatorSpectrumProcessor",
    "OscilloscopeProcessor", "OscilloscopeFrame", "SubSampleInterpolation",
    "TriggerMode",
    "VectorscopeProcessor", "VectorscopeFrame", "AutoGain", "OperationalMode",
    "SpectrogramProcessor", "SpectrogramImage",
    # contents (parameter models)
    "SpectrumContent", "OscilloscopeContent", "VectorScopeContent",
    # stream layer
    "AudioStream", "AudioStreamInfo", "Playhead", "HostGraph", "PortPair",
    "MixGraph", "FramePipeline",
    # state / presets
    "PresetManager", "Archive", "SgnPreset", "apply_preset", "load_sgn",
    "save_sgn", "EditorSettings",
    # session / render
    "AnalysisSession", "SessionFrame", "LineGraphFrame", "LineGraphRenderFeed",
    "FrequencyTracker",
    # diagnostics
    "log_exception", "protected_call",
    # editor / layouts
    "EditorShell", "layout_for", "Page", "Section", "Control",
    # multi-chip
    "ShardedAnalysisPipeline", "PipelineOutput",
}


def test_api_exports_every_documented_name_from_the_port():
    import signalizer_tpu.api as japi
    import signalizer_tpu_torch.api as tapi

    assert not sorted(n for n in EXPECTED if not hasattr(tapi, n))
    for n in EXPECTED:
        value = getattr(tapi, n)
        assert value is not None, n
        assert getattr(value, "__module__", "signalizer_tpu_torch").startswith("signalizer_tpu_torch"), n
        assert value is not getattr(japi, n), n
