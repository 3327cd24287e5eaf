"""The port's copies of the jax-free engine modules against their originals,
on the CPU: the parameter layer (ranges, formatters, bundles,
transformatters), the three view contents, the preset corpus and its
generator, the reference ``.sgn`` importer, the axis, colour and legend
helpers, the frequency tracker, the editor layouts and settings, and the
line-graph render feed. Each copy gives the same values, texts and bytes as
its original, in the style of tests/test_torch_port_copies.py."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from signalizer_tpu.core import windows as jwindows
from signalizer_tpu.state.serialize import Archive as JArchive
from signalizer_tpu.views import content as jcontent
from signalizer_tpu_torch.core import windows as twindows
from signalizer_tpu_torch.state.serialize import Archive as TArchive
from signalizer_tpu_torch.views import content as tcontent

REPO = Path(__file__).resolve().parent.parent
GOLDEN = Path(__file__).parent / "golden"
CONTENTS = ("VectorScopeContent", "OscilloscopeContent", "SpectrumContent")
GRID = [0.0, 1e-3, 0.05, 0.1, 0.25, 1 / 3, 0.5, 0.6180339887, 0.75, 0.9, 0.999, 1.0]


def _pair(name):
    return getattr(jcontent, name)(), getattr(tcontent, name)()


@pytest.mark.parametrize("name", CONTENTS)
def test_content_parameters_equal_the_originals(name):
    """Every parameter of the content: the same names, defaults, and over a
    grid of normalized values the same transformed values and texts; the
    text parses back to the same normalized value in both."""
    jc, tc = _pair(name)
    jps, tps = list(jc.parameter_set), list(tc.parameter_set)
    assert len(jps) == len(tps) > 20
    for jp, tp in zip(jps, tps):
        assert (tp.name, tp.exported_name) == (jp.name, jp.exported_name)
        assert tp.get_normalized() == jp.get_normalized(), tp.name
        for n in GRID:
            jp.set_normalized(n)
            tp.set_normalized(n)
            assert tp.get_normalized() == jp.get_normalized(), (tp.name, n)
            assert tp.get_transformed() == jp.get_transformed(), (tp.name, n)
            text = jp.get_display_text()
            assert tp.get_display_text() == text, (tp.name, n)
            assert tp.set_from_text(text) == jp.set_from_text(text), (tp.name, text)
            assert tp.get_normalized() == jp.get_normalized(), (tp.name, text)
        for value in (-1e9, -3.5, 0.0, 0.5, 7.0, 440.0, 1e9):
            jp.set_transformed(value)
            tp.set_transformed(value)
            assert tp.get_normalized() == jp.get_normalized(), (tp.name, value)
    ja, ta = JArchive(), TArchive()
    jc.serialize(ja)
    tc.serialize(ta)
    assert ta.to_bytes() == ja.to_bytes()


@pytest.mark.parametrize("name", CONTENTS)
def test_content_products_equal_the_originals(name):
    """What a content builds for its view from the same knobs: processor
    keywords (the port's enums compare equal), render hints, gradient,
    tracker, window list and effective window."""
    jc, tc = _pair(name)
    rng = np.random.default_rng(len(name))
    for jp, tp in zip(jc.parameter_set, tc.parameter_set):
        n = float(rng.random())
        jp.set_normalized(n)
        tp.set_normalized(n)

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (tuple, list)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b) and a.dtype == np.asarray(b).dtype
        else:
            assert a == b and int(isinstance(a, bool)) == int(isinstance(b, bool)), (a, b)

    same(jc.make_render_hints(), tc.make_render_hints())
    if name == "OscilloscopeContent":
        for bpm, cycles in ((120.0, 0.0), (87.5, 113.25)):
            same(jc.make_processor_kwargs(44_100.0, bpm=bpm, cycle_samples=cycles),
                 tc.make_processor_kwargs(44_100.0, bpm=bpm, cycle_samples=cycles))
            assert tc.effective_window_samples(44_100.0, bpm, cycles) == jc.effective_window_samples(44_100.0, bpm, cycles)
    elif name == "VectorScopeContent":
        same(jc.make_processor_kwargs(44_100.0), tc.make_processor_kwargs(44_100.0))
    else:
        same(jc.make_gradient(), tc.make_gradient())
        assert [int(w) for w in tc.available_windows()] == [int(w) for w in jc.available_windows()]
        for source in range(4):
            jc.frequency_tracker.set_normalized(source / 3)
            tc.frequency_tracker.set_normalized(source / 3)
            jt, tt = jc.make_tracker(44_100.0, frame_rate=30.0), tc.make_tracker(44_100.0, frame_rate=30.0)
            assert (jt is None) == (tt is None)
            if jt is not None:
                same((jt.source, jt.sample_rate, jt.a4_reference), (tt.source, tt.sample_rate, tt.a4_reference))


def test_spectrum_content_constant_equals_the_original():
    """make_constant from the same knobs: the same static fields and the
    same arrays (the port's on the device it is given)."""
    jc, tc = _pair("SpectrumContent")
    rng = np.random.default_rng(1)
    for jp, tp in zip(jc.parameter_set, tc.parameter_set):
        n = float(rng.random())
        jp.set_normalized(n)
        tp.set_normalized(n)
    for content in (jc, tc):
        content.window_size.set_normalized(3000 / 48_000)
        content.algorithm.set_normalized(0.0)
    kw = dict(axis_points=96, sample_rate=44_100.0, frames_per_second=30.0)
    j = jc.make_constant(**kw)
    t = tc.make_constant(device="cpu", **kw)
    for name in ("axis_points", "window_size", "transform_size", "configuration", "bin_interpolation",
                 "view_scaling", "algo", "display_mode", "sample_rate", "num_line_graphs"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("window_kernel", "mapped_frequencies", "slope_map", "decay_poles", "interp_weights"):
        assert np.array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name))), name


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

CORPUS = sorted(p.name for p in (REPO / "signalizer_tpu" / "presets").glob("*.sgz"))


@pytest.mark.parametrize("name", CORPUS)
def test_preset_corpus_is_byte_equal(name):
    """The port ships its own copy of the 20 factory archives, byte for
    byte, and loads each into the same normalized values."""
    from signalizer_tpu.state.presets import PresetManager as JManager
    from signalizer_tpu_torch.state.factory_presets import FACTORY_DIR
    from signalizer_tpu_torch.state.presets import PresetManager as TManager

    assert len(CORPUS) == 20
    assert FACTORY_DIR == REPO / "signalizer_tpu_torch" / "presets"
    assert (FACTORY_DIR / name).read_bytes() == (REPO / "signalizer_tpu" / "presets" / name).read_bytes()
    stem = name[: -len(".sgz")]
    assert TManager().list_presets() == JManager().list_presets()
    assert TManager().load(stem).to_bytes() == JManager().load(stem).to_bytes()


def test_package_data_ships_the_port_corpus():
    """The wheel's package data names the port's preset corpus."""
    import tomllib

    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["signalizer_tpu_torch"]
    shipped = {p.name for g in globs for p in (REPO / "signalizer_tpu_torch").glob(g)}
    assert set(CORPUS) <= shipped


def test_regenerated_factory_archives_are_byte_equal(tmp_path):
    """generate_factory_presets (authored on a CPU port engine) writes the
    same 20 archives, byte for byte, as the original's generator."""
    from signalizer_tpu.state.factory_presets import generate_factory_presets as jgen
    from signalizer_tpu_torch.state.factory_presets import FACTORY_PRESETS
    from signalizer_tpu_torch.state.factory_presets import generate_factory_presets as tgen

    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    assert tgen(tmp_path / "t") == jgen(tmp_path / "j") == len(FACTORY_PRESETS) == 20
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) == CORPUS
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    assert tgen(tmp_path / "t", overwrite=False) == 0


# ---------------------------------------------------------------------------
# the reference's binary .sgn presets
# ---------------------------------------------------------------------------

SGN_GOLDEN = json.loads((GOLDEN / "sgn_presets.json").read_text())


@pytest.mark.parametrize("preset", sorted(SGN_GOLDEN))
def test_sgn_import_against_the_golden(preset, tmp_path):
    """The golden holds every shipped view preset's decoded knobs. Set a
    content to them, export ``.sgn`` bytes with both packages (byte-equal),
    and import those bytes with the port (and the original's bytes with
    the port, the port's with the original): each lands on the golden's
    normalized values."""
    from signalizer_tpu.state import sgn_import as jsgn
    from signalizer_tpu_torch.state import sgn_import as tsgn

    view = preset.split(".")[1]
    cls = {"vectorscope": "VectorScopeContent", "oscilloscope": "OscilloscopeContent", "spectrum": "SpectrumContent"}[view]
    want = SGN_GOLDEN[preset]
    jc, tc = _pair(cls)
    for content in (jc, tc):
        for p in content.parameter_set:
            p.set_normalized(want[p.exported_name])
    assert tsgn.build_view_parameters(tc) == jsgn.build_view_parameters(jc)
    jsgn.save_sgn(tmp_path / "j.sgn", **{view: jc})
    tsgn.save_sgn(tmp_path / "t.sgn", **{view: tc})
    data = (tmp_path / "t.sgn").read_bytes()
    assert data == (tmp_path / "j.sgn").read_bytes()
    for load, make, src in ((tsgn.load_sgn, getattr(tcontent, cls), "t.sgn"),
                            (tsgn.load_sgn, getattr(tcontent, cls), "j.sgn"),
                            (jsgn.load_sgn, getattr(jcontent, cls), "t.sgn")):
        fresh = make()
        sgn = load(tmp_path / src)
        assert sgn.name == view
        applied = (tsgn if load is tsgn.load_sgn else jsgn).apply_preset(sgn, **{view: fresh})
        assert applied == [view]
        for p in fresh.parameter_set:
            assert p.get_normalized() == pytest.approx(want[p.exported_name], abs=1e-9), (preset, p.name)


def test_sgn_parser_refuses_the_same_bytes():
    """Hostile and truncated inputs: the port's parser raises where the
    original raises (its SgnFormatError) and parses what it parses."""
    import random

    from signalizer_tpu.state import sgn_import as jsgn
    from signalizer_tpu_torch.state import sgn_import as tsgn

    good = tsgn.write_sgn("spectrum", {"Parameters": tsgn.build_view_parameters(tcontent.SpectrumContent())})
    assert good == jsgn.write_sgn("spectrum", {"Parameters": jsgn.build_view_parameters(jcontent.SpectrumContent())})
    rng = random.Random(3)
    cases = [bytes(rng.randrange(256) for _ in range(n)) for n in (0, 1, 17, 40, 64, 4096)]
    cases += [good, good[:-3], good[:30], good[:18] + bytes(40)]
    for data in cases:
        try:
            want = jsgn.parse_sgn(data)
        except jsgn.SgnFormatError as e:
            with pytest.raises(tsgn.SgnFormatError) as got:
                tsgn.parse_sgn(data)
            assert str(got.value) == str(e)
        else:
            got = tsgn.parse_sgn(data)
            assert (got.name, got.tree) == (want.name, want.tree)


def test_reference_preset_dir_is_named_by_the_environment(monkeypatch, tmp_path):
    from signalizer_tpu_torch.state.sgn_import import reference_preset_dir

    monkeypatch.delenv("SIGNALIZER_REFERENCE_PRESETS", raising=False)
    assert reference_preset_dir() is None
    monkeypatch.setenv("SIGNALIZER_REFERENCE_PRESETS", str(tmp_path))
    assert reference_preset_dir() == tmp_path
    monkeypatch.setenv("SIGNALIZER_REFERENCE_PRESETS", str(tmp_path / "missing"))
    assert reference_preset_dir() is None


def test_engine_imports_an_exported_main_preset_as_the_original_does(tmp_path):
    """A ``main`` .sgn (all three views and the history capacity) exported
    by the original's engine loads into a port engine and an original
    engine with the same normalized values and capacity."""
    from signalizer_tpu.engine import SignalizerEngine as JEngine
    from signalizer_tpu.state.sgn_import import save_sgn
    from signalizer_tpu_torch.engine import SignalizerEngine as TEngine

    src = JEngine("sgn-src")
    rng = np.random.default_rng(2)
    for i in range(src.num_parameters()):
        src.set_parameter(i, float(rng.random()))
    path = tmp_path / "x.main.sgn"
    save_sgn(path, vectorscope=src.vectorscope, oscilloscope=src.oscilloscope, spectrum=src.spectrum,
             history_capacity=24_000)
    j, t = JEngine("j"), TEngine("t", device="cpu")
    assert t.load_reference_preset(path) == j.load_reference_preset(path)
    assert [t.get_parameter(i) for i in range(201)] == [j.get_parameter(i) for i in range(201)]
    assert t.config.history_capacity == j.config.history_capacity == 24_000
    for e in (src, j, t):
        e.close()


# ---------------------------------------------------------------------------
# parameter layer pieces
# ---------------------------------------------------------------------------


def test_windows_additions_equal_the_originals():
    assert [int(w) for w in twindows.FINITE_DFT_WINDOWS] == [int(w) for w in jwindows.FINITE_DFT_WINDOWS]
    for wtype in jwindows.WindowType:
        kernel, _ = jwindows.generate_window(wtype, 300)
        for off in (0.0, 0.125, 0.5, 1.3):
            assert twindows.window_dtft_gain(kernel, off) == jwindows.window_dtft_gain(kernel, off)


def test_values_and_transformatters_equal_the_originals():
    from signalizer_tpu.params import transformatters as jt
    from signalizer_tpu.params import values as jv
    from signalizer_tpu_torch.params import transformatters as tt
    from signalizer_tpu_torch.params import values as tv

    rng = np.random.default_rng(4)
    for cls in ("ColourValue", "WindowDesignValue", "PowerSlopeValue", "TransformValue"):
        j, t = getattr(jv, cls)("X"), getattr(tv, cls)("X")
        for _ in range(20):
            for jp, tp in zip(j.parameters(), t.parameters()):
                assert tp.exported_name == jp.exported_name
                n = float(rng.random())
                jp.set_normalized(n)
                tp.set_normalized(n)
            if cls == "ColourValue":
                assert t.get_rgba() == j.get_rgba() and np.array_equal(t.get_rgb(), j.get_rgb())
            elif cls == "WindowDesignValue":
                assert int(t.get_window_type()) == int(j.get_window_type())
                (tk, ts), (jk, js) = t.generate_window(257), j.generate_window(257)
                assert np.array_equal(tk, jk) and ts == js
            elif cls == "PowerSlopeValue":
                assert t.derive() == j.derive()
            else:
                assert np.array_equal(t.matrix(), j.matrix()) and np.array_equal(t.translation(), j.translation())
    for mode in jt.AudioHistoryTransformatter.Mode:
        j = jt.AudioHistoryTransformatter(44_100.0, 30_000, mode=mode)
        t = tt.AudioHistoryTransformatter(44_100.0, 30_000, mode=tt.AudioHistoryTransformatter.Mode(int(mode)))
        for n in GRID:
            assert t.transform(n) == j.transform(n) and t.format(t.transform(n)) == j.format(j.transform(n))
        for text in ("100 ms", "4096", "1.5 s", "2048 smps", "x", ""):
            assert t.parse(text) == j.parse(text), text
    for mode in jt.TimeMode:
        j, t = jt.WindowSizeTransformatter(48_000.0, 48_000), tt.WindowSizeTransformatter(48_000.0, 48_000)
        j.time_mode, t.time_mode = mode, tt.TimeMode(int(mode))
        for n in GRID:
            v = j.transform(n)
            assert t.transform(n) == v and t.normalize(v) == j.normalize(v) and t.format(v) == j.format(v)
        for text in ("20 ms", "512 smps", "3 r", "1/4 bars", "2 bars", "bogus"):
            assert t.parse(text) == j.parse(text), (mode, text)
    j, t = jt.LinearHzFormatter(48_000.0), tt.LinearHzFormatter(48_000.0)
    for text in ("A4", "C#3", "440 Hz", "100 smps", "2 ms", "0.5 r", "1 beats", "nonsense", "Gb7"):
        assert t.parse(text) == j.parse(text), text
    for v in (5.0, 440.0, 12_345.678):
        assert t.format(v) == j.format(v)


# ---------------------------------------------------------------------------
# axis, colour, legend, tracker, layouts, editor settings, render feed
# ---------------------------------------------------------------------------


def test_axis_equals_the_original():
    from signalizer_tpu.utils import axis as ja
    from signalizer_tpu_torch.utils import axis as ta

    for rng_, div in ((96.0, 10), (0.0, 5), (1e-3, 7), (23_980.0, 12), (5.5, 0)):
        assert ta.suitable_axis_division(rng_, div) == ja.suitable_axis_division(rng_, div)

    def lines(xs):
        return [dataclasses.astuple(x) for x in xs]

    assert lines(ta.db_meter_axis(-96.0, 0.0)) == lines(ja.db_meter_axis(-96.0, 0.0))
    assert lines(ta.db_meter_axis(-60.0, 12.0, 4)) == lines(ja.db_meter_axis(-60.0, 12.0, 4))
    for f in (np.geomspace(10.0, 24_000.0, 300), np.linspace(0.0, 24_000.0, 128), np.ones(4)):
        assert lines(ta.frequency_axis(f)) == lines(ja.frequency_axis(f))
    for w in (0.001, 0.0213, 1.0):
        assert lines(ta.time_axis(w)) == lines(ja.time_axis(w))
        assert lines(ta.time_axis(w, 6, "s")) == lines(ja.time_axis(w, 6, "s"))
    for centred in (False, True):
        kw = dict(trigger_centered=centred)
        assert ta.cursor_readout(0.25, 0.3, 0.02, 48_000.0, **kw) == ja.cursor_readout(0.25, 0.3, 0.02, 48_000.0, **kw)


def test_colour_and_legend_equal_the_original():
    from signalizer_tpu.utils import colour as jcol
    from signalizer_tpu_torch.utils import colour as tcol

    for base, size, first in (((1.0, 0.0, 0.0), 5, False), ((0.2, 0.6, 0.9, 1.0), 3, True), ((0.5, 0.5, 0.5), 1, False)):
        t, j = tcol.ColourRotation(base, size, first), jcol.ColourRotation(base, size, first)
        assert np.array_equal(t.as_array(), j.as_array()) and np.array_equal(t[7], j[7])
    names = [f"ch {i}" for i in range(7)]
    for second in (None, (1.0, 0.0, 0.0)):
        t = tcol.Legend.for_pairs(names, (0.0, 1.0, 0.0), 4, secondary_colour=second)
        j = jcol.Legend.for_pairs(names, (0.0, 1.0, 0.0), 4, secondary_colour=second)
        assert [(e.name, e.colour) for e in t.entries] == [(e.name, e.colour) for e in j.entries]


def test_tracker_equals_the_original():
    from signalizer_tpu.kernels import tracker as jt
    from signalizer_tpu_torch.kernels import tracker as tt

    rng = np.random.default_rng(6)
    mags = np.abs(rng.standard_normal(2049)).astype(np.float32) * 0.01
    mags[93] = 0.8
    mags[92], mags[94] = 0.5, 0.6
    freqs = np.geomspace(10.0, 24_000.0, 256)
    row = rng.random(256).astype(np.float32) * 0.3
    row[140] = 0.9
    for f in (0.0, 27.5, 440.0, 1234.5, 20_000.0):
        for a4 in (440.0, 432.0):
            assert tt.frequency_to_semitone(f, a4) == jt.frequency_to_semitone(f, a4)
    kernel, _ = jwindows.generate_window(jwindows.WindowType.HANN, 1024)
    for off in (0.0, 0.3, 0.5):
        assert tt.scalloping_loss_at(kernel, off) == jt.scalloping_loss_at(kernel, off)
    for cursor in (0.0, 93 / 2048, 0.0452, 0.5, 1.0):
        got = tt.track_peak(mags, 48_000.0, cursor, inv_size=2e-3)
        assert dataclasses.astuple(got) == dataclasses.astuple(jt.track_peak(mags, 48_000.0, cursor, inv_size=2e-3))
        ti = int(round(cursor * 255))
        got = tt.track_display_peak(row, freqs, ti / 255)
        assert dataclasses.astuple(got) == dataclasses.astuple(jt.track_display_peak(row, freqs, ti / 255))
    for smoothing in (0.0, 80.0):
        for source in ("transform", "graph0"):
            t = tt.FrequencyTracker(48_000.0, smoothing_ms=smoothing, frame_rate=30.0, window_kernel=kernel, source=source)
            j = jt.FrequencyTracker(48_000.0, smoothing_ms=smoothing, frame_rate=30.0, window_kernel=kernel, source=source)
            for k in range(6):
                m = mags * (1.0 + 0.1 * k)
                assert t.update(m, 93 / 2048, inv_size=1e-3) == j.update(m, 93 / 2048, inv_size=1e-3)
                assert t.update_display(row, freqs, 140 / 255) == j.update_display(row, freqs, 140 / 255)


def test_controller_layouts_equal_the_originals():
    from signalizer_tpu.views import controllers as jctl
    from signalizer_tpu_torch.views import controllers as tctl

    for name in CONTENTS:
        jc, tc = _pair(name)
        jl, tl = jctl.layout_for(jc), tctl.layout_for(tc)
        assert [dataclasses.astuple(p) for p in tl] == [dataclasses.astuple(p) for p in jl]
        names = tctl.layout_parameter_names(tl)
        assert names == jctl.layout_parameter_names(jl) and len(names) > 5
        registered = {p.name for p in tc.parameter_set}
        assert all(any(r == n or r.startswith(n) for r in registered) for n in names), name


def test_editor_settings_bytes_equal_the_original():
    from signalizer_tpu.views.editor_settings import EditorSettings as JSettings
    from signalizer_tpu_torch.views.editor_settings import EditorSettings as TSettings

    t, j = TSettings(), JSettings()
    for s in (t, j):
        s.refresh_rate_ms, s.kiosk, s.legend_choice = 33.0, True, 2
        s.colour_scheme = dict(s.colour_scheme, **{next(iter(s.colour_scheme)): (0.1, 0.2, 0.3, 0.4)})
    ta, ja = TArchive(), JArchive()
    t.serialize(ta)
    j.serialize(ja)
    assert ta.to_bytes() == ja.to_bytes()
    back = TSettings()
    back.deserialize(TArchive.from_bytes(ja.to_bytes()))
    assert dataclasses.asdict(back) == dataclasses.asdict(j)


def _line_graph_content(module):
    content = module.SpectrumContent()
    content.channel_configuration.set_normalized(5 / 7)  # separate
    for k in range(2):
        content.lines[k][1].set_rgba((0.1, 0.9, 0.2, 1.0))
        content.lines[k][2].set_rgba((0.9, 0.2, 0.1, 1.0))
    return content


def test_line_graph_feed_equals_the_original_and_the_golden():
    """The render feed of the golden's configuration: on the same results
    the port's feed builds the original's arrays bit for bit; the port's
    whole path (CPU SpectrumProcessor, then the feed) matches
    tests/golden/line_graph_feed.npz at the golden test's atol 1e-6."""
    from signalizer_tpu.core.config import BinInterpolation, SpectrumChannels, ViewScaling
    from signalizer_tpu.views.spectrum import SpectrumProcessor as JProc
    from signalizer_tpu_torch.views.spectrum import SpectrumProcessor as TProc

    kw = dict(pairs=2, axis_points=96, window_size=512, configuration=SpectrumChannels.SEPARATE,
              bin_interpolation=BinInterpolation.LANCZOS, view_scaling=ViewScaling.LOGARITHMIC)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, 2, 512)).astype(np.float32) * 0.4
    jproc, tproc = JProc.create(**kw), TProc.create(device="cpu", **kw)
    jres = np.asarray(jproc.process(x)[:, -1])
    tres = tproc.process(x)[:, -1].numpy()
    jfeed = _line_graph_content(jcontent).make_render_feed(jproc.constant, pairs=2)
    tfeed = _line_graph_content(tcontent).make_render_feed(tproc.constant, pairs=2)

    def arrays(frame):
        return dict(
            strip0=frame.strips[0].vertices,
            strip_last=frame.strips[-1].vertices,
            strip0_colour=frame.strips[0].colour,
            flood0=frame.floods[0].vertices,
            grid_pos=np.asarray([g.position for g in frame.grid]),
            db_pos=np.asarray([g.position for g in frame.db_grid]),
        )

    same_input, theirs = arrays(tfeed.build(jres)), arrays(jfeed.build(jres))
    for key in theirs:
        assert np.array_equal(same_input[key], theirs[key]), key
    got, want = arrays(tfeed.build(tres)), np.load(GOLDEN / "line_graph_feed.npz")
    for key, val in got.items():
        np.testing.assert_allclose(val, want[key], atol=1e-6, err_msg=key)
