"""The port's copies of the JAX package's host stream layer — config
constants, the serializer, diagnostics, the exception log, the native host
runtime, the audio stream, the host graph and the mix graph — against their
originals on the CPU. The same seeded numpy blocks go through both; every
comparison is exact (the copies run the same host arithmetic)."""

import filecmp

import numpy as np
import pytest

from signalizer_tpu import native_bindings as jnative
from signalizer_tpu.core import config as jconfig
from signalizer_tpu.state import serialize as jserialize
from signalizer_tpu.stream import audio_stream as jaudio
from signalizer_tpu.stream import host_graph as jgraph
from signalizer_tpu.stream import mix_graph as jmix
from signalizer_tpu.stream import ring_buffer as jring
from signalizer_tpu.utils import diagnostics as jdiag
from signalizer_tpu.utils import exception_log as jlog
from signalizer_tpu_torch import native_bindings as tnative
from signalizer_tpu_torch.core import config as tconfig
from signalizer_tpu_torch.state import serialize as tserialize
from signalizer_tpu_torch.stream import audio_stream as taudio
from signalizer_tpu_torch.stream import host_graph as tgraph
from signalizer_tpu_torch.stream import mix_graph as tmix
from signalizer_tpu_torch.stream import ring_buffer as tring
from signalizer_tpu_torch.utils import diagnostics as tdiag
from signalizer_tpu_torch.utils import exception_log as tlog

PACKAGES = {"jax": (jaudio, jgraph, jmix), "torch": (taudio, tgraph, tmix)}


@pytest.fixture(autouse=True)
def _clean_registries():
    """Both packages' HostGraph registries start and end empty."""
    yield
    for graph in (jgraph.HostGraph, tgraph.HostGraph):
        for node in graph.live_nodes():
            node.close()
        graph._alias_chains.clear()


class _Sink:
    def __init__(self):
        self.blocks, self.stamps, self.clocks = [], [], []

    def on_stream_audio(self, ctx, block):
        self.blocks.append(block.copy())
        self.stamps.append((ctx.block_end_clock, ctx.ring_generation))
        self.clocks.append(ctx.playhead.steady_clock)

    def on_stream_properties_changed(self, ctx, before):
        pass

    def on_stream_died(self, ctx):
        pass

    def record(self):
        return self.blocks, self.stamps, self.clocks


def _assert_same_record(a, b):
    assert len(a[0]) == len(b[0])
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    assert a[1] == b[1] and a[2] == b[2]


@pytest.mark.parametrize("name", ["MAX_INPUT_CHANNELS", "STREAM_PACKET_SIZE", "DEFAULT_HISTORY_SIZE"])
def test_stream_constants_equal_the_jax_package(name):
    assert getattr(tconfig, name) == getattr(jconfig, name)
    assert type(getattr(tconfig, name)) is type(getattr(jconfig, name))


def _archive(mod):
    rng = np.random.default_rng(3)
    a = mod.Archive(version=4)
    a["name"] = "preset"
    a["gain"] = np.float32(0.25)
    a["count"] = np.int64(7)
    a["blob"] = b"\x00\x01binary"
    a["list"] = [1, 2.5, "x", [True, None]]
    a["array"] = rng.standard_normal((3, 5)).astype(np.float32)
    child = a.child("view")
    child.version = 2
    child["ints"] = np.arange(6, dtype=np.int32).reshape(2, 3)
    child.child("deep")["flag"] = False
    return a


def test_archive_bytes_equal_the_jax_package():
    """The same tree writes the same bytes, and each package reads the
    other's bytes back to the same tree."""
    ours, theirs = _archive(tserialize), _archive(jserialize)
    assert ours.to_bytes() == theirs.to_bytes()
    back = tserialize.Archive.from_bytes(theirs.to_bytes())
    assert back.to_bytes() == theirs.to_bytes()
    np.testing.assert_array_equal(back["array"], theirs["array"])
    assert back.find_child("view").version == 2


def test_archive_takes_a_cpu_tensor():
    import torch

    a = tserialize.Archive()
    a["t"] = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    back = tserialize.Archive.from_bytes(a.to_bytes())
    np.testing.assert_array_equal(back["t"], np.arange(6, dtype=np.float32).reshape(2, 3))


class _Param:
    def __init__(self, name, value):
        self.name, self.value, self.sources = name, value, []

    def get_normalized(self):
        return self.value

    def set_normalized(self, value, source=None):
        self.value = value
        self.sources.append(source)


def test_parameter_set_helpers_equal_the_jax_package():
    """Both packages write a parameter set's normalized values by name to
    the same bytes, and read them back into the same values."""
    pset = [_Param("gain", 0.25), _Param("window", 0.75)]
    ta, ja = tserialize.Archive(), jserialize.Archive()
    tserialize.serialize_parameter_set(pset, ta)
    jserialize.serialize_parameter_set(pset, ja)
    assert ta.to_bytes() == ja.to_bytes()
    ours = [_Param("gain", 0.0), _Param("window", 0.0), _Param("absent", 0.5)]
    theirs = [_Param("gain", 0.0), _Param("window", 0.0), _Param("absent", 0.5)]
    tserialize.deserialize_parameter_set(ours, ta)
    jserialize.deserialize_parameter_set(theirs, ja)
    assert [(p.value, p.sources) for p in ours] == [(p.value, p.sources) for p in theirs]
    assert [p.value for p in ours] == [0.25, 0.75, 0.5]


def test_diagnostics_equal_the_jax_package(monkeypatch):
    """The same frame clock and latencies give the same snapshot; an
    assumption is reported once per distinct message."""
    snaps = []
    for mod in (tdiag, jdiag):
        clock = iter(np.arange(0.0, 10.0, 0.0125))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: float(next(clock)))
        d = mod.Diagnostics(window=8)
        for i in range(20):
            d.tick_frame()
            d.record_latency(0.001 * (i % 7))
            d.bump("ticks")
        snaps.append(d.snapshot())
        mod.reset_assumptions()
        assert mod.assumption(False, "x") is False and mod.assumption(True, "x") is True
        assert mod._seen_assumptions == {hash("x")}
        mod.reset_assumptions()
    assert snaps[0] == snaps[1]
    assert tdiag.SharedBehaviour() == tdiag.SharedBehaviour(**vars(jdiag.SharedBehaviour()))


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """``profile_trace`` runs ``torch.profiler`` and leaves a Chrome trace
    of what ran inside it in ``log_dir``."""
    import json

    import torch

    with tdiag.profile_trace(str(tmp_path / "trace")) as tr:
        torch.fft.rfft(torch.ones(256))
    events = json.loads(tr.path.read_text())["traceEvents"]
    assert tr.path.parent == tmp_path / "trace"
    assert any("fft" in str(e.get("name", "")) for e in events)


def test_protected_call_and_log_equal_the_jax_package(tmp_path, monkeypatch):
    """A failing call returns its fallback and appends one record to the
    log; a log past its size limit is halved to its newest lines."""
    logs = []
    for mod, name in ((tlog, "torch"), (jlog, "jax")):
        monkeypatch.setattr(mod, "_log_path", None)
        mod.set_exception_log_path(tmp_path / name / "exceptions.log")
        assert mod.protected_call(lambda: 1 / 0, fallback=-1, context="test") == -1
        assert mod.protected_call(lambda: 5, fallback=-1) == 5
        text = mod.get_exception_log_path().read_text()
        logs.append([ln.split("] ", 1)[1] for ln in text.splitlines() if ln.startswith("[")])
        mod.get_exception_log_path().write_text("".join(f"line {i}\n" for i in range(4000)))
        assert mod.check_prune_log(max_bytes=1000)
        kept = mod.get_exception_log_path().read_text().splitlines()
        assert kept[0] == "[log pruned]" and kept[-1] == "line 3999"
        logs.append(kept)
    assert logs[0] == logs[2] and logs[1] == logs[3]
    assert logs[0] == ["protected test call failed: ZeroDivisionError: division by zero"]


def test_log_path_defaults_as_the_jax_package(monkeypatch, tmp_path):
    for mod in (tlog, jlog):
        monkeypatch.setattr(mod, "_log_path", None)
        monkeypatch.setenv("SIGNALIZER_TPU_LOG_DIR", str(tmp_path / "logs"))
    assert tlog.get_exception_log_path() == jlog.get_exception_log_path() == tmp_path / "logs" / "exceptions.log"
    assert tlog.MAX_LOG_BYTES == jlog.MAX_LOG_BYTES


# --- native host runtime -----------------------------------------------------


def test_native_source_is_the_jax_packages():
    assert filecmp.cmp(tnative._SRC, jnative._SRC, shallow=False)


def test_native_runtime_builds_into_the_build_directory():
    """``g++`` builds the library on first use under build/ (never beside
    the source), named by the source's hash."""
    assert tnative.native_available(), tnative.native_build_error()
    assert tnative.native_build_error() is None
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "signalizer_tpu_torch" and path.parent.parent.name == "build"
    assert not list(tnative._SRC.parent.glob("*.so"))


def test_make_ring_buffer_returns_the_native_ring():
    assert isinstance(tring.make_ring_buffer(2, 64), tnative.NativeRingBuffer)
    assert isinstance(tring.make_ring_buffer(2, 64, prefer_native=False), tring.RingBuffer)
    assert isinstance(tring.make_ring_buffer(2, 64, dtype=np.float64), tring.RingBuffer)


@pytest.mark.parametrize("capacity", [1, 64, 1000])
def test_native_ring_equals_the_numpy_ring(capacity):
    """Seeded writes (shorter and longer than the ring), seeks and reads:
    the native ring and both packages' numpy rings agree exactly."""
    rng = np.random.default_rng(capacity)
    rings = [tnative.NativeRingBuffer(3, capacity), tring.RingBuffer(3, capacity), jring.RingBuffer(3, capacity)]
    for step in range(60):
        op = rng.integers(0, 4)
        if op == 0:
            block = rng.standard_normal((3, int(rng.integers(1, 2 * capacity + 3)))).astype(np.float32)
            for r in rings:
                r.write(block)
        elif op == 1:
            clock = rings[0].sample_clock + int(rng.integers(0, 2 * capacity + 2))
            for r in rings:
                r.seek_to(clock)
        n = int(rng.integers(1, capacity + 1))
        outs = [r.latest(n) for r in rings]
        for o in outs[1:]:
            np.testing.assert_array_equal(outs[0], o)
        behind = int(rng.integers(0, capacity))
        clock = rings[0].sample_clock - behind
        results = []
        for r in rings:
            try:
                results.append(r.read_at(clock, n))
            except ValueError as e:
                results.append(str(e))
        for x in results[1:]:
            if isinstance(x, str):
                assert x == results[0]
            else:
                np.testing.assert_array_equal(results[0], x)
        assert len({r.sample_clock for r in rings}) == 1 and len({r.valid_samples for r in rings}) == 1


def test_native_frame_gather_and_mix_accumulate_match_numpy():
    rng = np.random.default_rng(11)
    native, plain = tnative.NativeRingBuffer(2, 4096), tring.RingBuffer(2, 4096)
    for _ in range(5):
        block = rng.standard_normal((2, 700)).astype(np.float32)
        native.write(block)
        plain.write(block)
    frames = native.frame_gather(1, 4, 480.5, 1024)
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(f, plain.read_at(int((1 + i) * 480.5 + 0.5) + 1024, 1024))
    row = np.ones(256, np.float32)
    assert native.mix_accumulate(3000, 1, row)
    np.testing.assert_array_equal(row, 1.0 + plain.read_at(3000, 256)[1])
    assert not native.mix_accumulate(3000, 5, np.zeros(256, np.float32))


def test_native_packet_queue_keeps_order_and_stamps():
    q = tnative.NativePacketQueue(2, 256, capacity=4)
    rng = np.random.default_rng(2)
    blocks = [rng.standard_normal((2, n)).astype(np.float32) for n in (256, 10, 256, 1)]
    for i, b in enumerate(blocks):
        assert q.push(b, i, 10 * i, 120.0, i % 2 == 0, end_clock=100 + i, generation=7)
    assert not q.push(blocks[0], 0, 0, 120.0, False)  # full: dropped, not blocked
    assert q.dropped == 1 and q.size == 4
    for i, b in enumerate(blocks):
        chunk, pos, steady, bpm, playing, end, gen = q.pop(timeout_ms=100)
        np.testing.assert_array_equal(chunk, b)
        assert (pos, steady, bpm, playing, end, gen) == (i, 10 * i, 120.0, i % 2 == 0, 100 + i, 7)
    assert q.pop(timeout_ms=10) is None
    q.close()
    with pytest.raises(StopIteration):
        q.pop(timeout_ms=10)


# --- audio stream ------------------------------------------------------------


def _stream(pkg, threaded=False, channels=2, cap=4096):
    audio = PACKAGES[pkg][0]
    info = audio.AudioStreamInfo(channels=channels, sample_rate=48_000.0, audio_history_capacity=cap)
    return audio.AudioStream.create(threaded, info)


@pytest.mark.parametrize("threaded", [False, True], ids=["sync", "threaded"])
def test_audio_stream_equals_the_jax_package(threaded):
    """Ragged pushes (longer than a packet, longer than the ring, a mono
    block into a stereo stream) with playheads: both streams deliver the
    same blocks with the same stamps and playheads, and hold the same
    history, clock and generation, also after a resize."""
    rng = np.random.default_rng(5)
    sizes = [1, 255, 256, 257, 800, 5000, 3, 1024]
    results = {}
    for pkg in ("torch", "jax"):
        audio = PACKAGES[pkg][0]
        inp, out = _stream(pkg, threaded, cap=2048)
        sink = _Sink()
        out.add_listener(sink)
        rng = np.random.default_rng(5)
        hist = []
        for i, n in enumerate(sizes):
            block = rng.standard_normal((1 if i == 6 else 2, n)).astype(np.float32)
            inp.process_incoming_audio(block, audio.Playhead(position_samples=i, steady_clock=1000 * i, is_playing=True))
            assert inp._stream.wait_for_drain(timeout=5.0)
            hist.append((out.get_history(700), out.sample_clock, out.ring_generation))
        out.modify_consumer_info(lambda info: setattr(info, "audio_history_capacity", 1024))
        inp.process_incoming_audio(rng.standard_normal((2, 300)).astype(np.float32))
        assert inp._stream.wait_for_drain(timeout=5.0)
        snap = out.history_snapshot(512)
        hist.append((snap[0], snap[1], snap[2]))
        results[pkg] = (sink.record(), hist, out.get_perf_measures().dropped_frames)
        inp._stream.close()
    _assert_same_record(results["torch"][0], results["jax"][0])
    for (a, ca, ga), (b, cb, gb) in zip(results["torch"][1], results["jax"][1]):
        np.testing.assert_array_equal(a, b)
        assert (ca, ga) == (cb, gb)
    assert results["torch"][2] == results["jax"][2] == 0


def test_threaded_stream_runs_on_the_native_queue_and_ring():
    inp, out = _stream("torch", threaded=True, channels=16, cap=48000)
    try:
        assert isinstance(out._stream._native_queue, tnative.NativePacketQueue)
        assert isinstance(out._stream._history, tnative.NativeRingBuffer)
        block = np.random.default_rng(1).standard_normal((16, 800)).astype(np.float32)
        sink = _Sink()
        out.add_listener(sink)
        inp.process_incoming_audio(block)
        assert inp._stream.wait_for_drain(timeout=5.0)
        # packetized at STREAM_PACKET_SIZE: 800 = 256 + 256 + 256 + 32
        assert [b.shape[1] for b in sink.blocks] == [256, 256, 256, 32]
        np.testing.assert_array_equal(np.concatenate(sink.blocks, axis=1), block)
        assert [s[0] for s in sink.stamps] == [256, 512, 768, 800]
    finally:
        inp._stream.close()


def test_listener_faults_are_contained(tmp_path, monkeypatch):
    """A listener that raises is logged and skipped; the next one still
    gets the block (the reference's Protected.h contract)."""
    monkeypatch.setattr(tlog, "_log_path", tmp_path / "exceptions.log")

    class Bad(_Sink):
        def on_stream_audio(self, ctx, block):
            raise RuntimeError("listener fault")

    inp, out = _stream("torch")
    good = _Sink()
    out.add_listener(Bad())
    out.add_listener(good)
    inp.process_incoming_audio(np.ones((2, 10), np.float32))
    assert len(good.blocks) == 1
    assert "listener fault" in (tmp_path / "exceptions.log").read_text()


# --- host graph and mix graph --------------------------------------------------


def _instance(pkg, name, channels=2, node_id=None):
    audio, graph, _ = PACKAGES[pkg]
    info = audio.AudioStreamInfo(channels=channels, sample_rate=48_000.0, audio_history_capacity=4096)
    inp, out = audio.AudioStream.create(False, info)
    g = graph.HostGraph(name, channels=channels)
    if node_id is not None:
        with graph.HostGraph._registry_lock:
            graph.HostGraph._registry.pop(g.node_id)
            g.node_id = node_id
            graph.HostGraph._registry[node_id] = g
    g.stream_output = out
    return inp, out, g


def _drive(pkg, script):
    """Build instances a and b of ``pkg``, connect b's left into a's right
    over a's self layout, and run ``script(push)``; returns the mixed
    presentation stream's record and the mix's perf counters."""
    audio, graph, mix_mod = PACKAGES[pkg]
    inp_a, out_a, ga = _instance(pkg, "a", node_id=b"a" * 16)
    inp_b, out_b, gb = _instance(pkg, "b", node_id=b"b" * 16)
    mix = mix_mod.MixGraph(ga, out_a)
    sink = _Sink()
    mix.presentation_output.add_listener(sink)
    ga.topology[ga.node_id] = {graph.PortPair(0, 0), graph.PortPair(1, 1)}
    ga.connect(gb.node_id, graph.PortPair(0, 1))

    def push(who, block, clock):
        (inp_a if who == "a" else inp_b).process_incoming_audio(block, audio.Playhead(steady_clock=clock))

    script(push)
    perf = mix.perf
    names = list(mix.presentation_output.info.channel_names)
    mix.close()
    return sink.record(), (perf.latency_samples, perf.synchronized, perf.discontinuities,
                           perf.silence_inserted, perf.samples_dropped), names


def _compare(script):
    ours, theirs = _drive("torch", script), _drive("jax", script)
    _assert_same_record(ours[0], theirs[0])
    assert ours[1:] == theirs[1:]
    assert len(ours[0][0]) > 0
    return ours


def test_mix_graph_aligned_ragged_pushes_equal_the_jax_package():
    """Interleaved ragged blocks on shared clocks (the two-instance mixing
    case of tests/test_mix_graph.py)."""
    rng = np.random.default_rng(7)
    sizes = [128, 64, 300, 1, 128, 517, 256]
    a = [rng.standard_normal((2, n)).astype(np.float32) for n in sizes]
    b = [rng.standard_normal((2, n)).astype(np.float32) for n in sizes]

    def script(push):
        clock = 0
        for x, y in zip(a, b):
            push("b", y, clock)
            push("a", x, clock)
            clock += x.shape[1]

    _compare(script)


def test_mix_graph_clock_offset_equals_the_jax_package():
    """b's clock starts at 10000, a's at 0: the offset aligns them."""
    rng = np.random.default_rng(1)
    b_sig = rng.standard_normal((2, 1024)).astype(np.float32)

    def script(push):
        for i in range(8):
            push("b", b_sig[:, i * 128 : (i + 1) * 128], 10_000 + i * 128)
            push("a", np.zeros((2, 128), np.float32), i * 128)

    _compare(script)


def test_mix_graph_stalled_source_equals_the_jax_package():
    """b delivers once and stalls while a runs on (silence inserted, a
    discontinuity), then returns with a jump in its clock (re-anchored)."""
    ones = np.ones((2, 128), np.float32)

    def script(push):
        push("a", ones, 0)
        push("b", ones * 0.5, 128)
        for i in range(1, 10):
            push("a", ones, i * 128)
        push("b", ones * 0.25, 999_999)
        for i in range(10, 14):
            push("a", ones, i * 128)
            push("b", ones * 0.25, 999_999 + (i - 9) * 128)

    record, perf, _ = _compare(script)
    assert perf[2] >= 1  # discontinuities


def test_mix_graph_mono_source_equals_the_jax_package():
    """A port beyond a mono source's channel count mixes silence."""
    results = []
    for pkg in ("torch", "jax"):
        audio, graph, mix_mod = PACKAGES[pkg]
        inp_a, out_a, ga = _instance(pkg, "a")
        inp_m, out_m, gm = _instance(pkg, "mono", channels=1)
        mix = mix_mod.MixGraph(ga, out_a)
        sink = _Sink()
        mix.presentation_output.add_listener(sink)
        ga.connect(gm.node_id, graph.PortPair(1, 1))  # mono has no channel 1
        ga.connect(gm.node_id, graph.PortPair(0, 0))
        for i in range(4):
            inp_m.process_incoming_audio(np.full((1, 128), 0.5, np.float32), audio.Playhead(steady_clock=i * 128))
            inp_a.process_incoming_audio(np.ones((2, 128), np.float32), audio.Playhead(steady_clock=i * 128))
        results.append(sink.record())
        mix.close()
    _assert_same_record(results[0], results[1])


def test_host_graph_topology_and_serialization_equal_the_jax_package():
    """Edges, toggles, the model and the serialized archive of one node;
    the registries of the two packages are apart."""
    archives, models = [], []
    for pkg in ("torch", "jax"):
        _, graph, _ = PACKAGES[pkg]
        a = graph.HostGraph("a", channels=4)
        b = graph.HostGraph("b", channels=2)
        for g, ident in ((a, b"A" * 16), (b, b"B" * 16)):
            with graph.HostGraph._registry_lock:
                graph.HostGraph._registry.pop(g.node_id)
                g.node_id = ident
                graph.HostGraph._registry[ident] = g
        assert a.connect(b.node_id, graph.PortPair(0, 3))
        assert not a.connect(b.node_id, graph.PortPair(0, 9))
        assert a.toggle_set(b"C" * 16)  # a missing peer: kept as an edge
        assert a.expected_nodes_to_resurrect() == 1
        arch = (tserialize if pkg == "torch" else jserialize).Archive()
        a.serialize(arch)
        archives.append(arch.to_bytes())
        m = a.get_model()
        models.append((sorted(n["id"] for n in m.nodes), [(s, d, (p.source, p.destination)) for s, d, p in m.edges],
                       m.missing))
        assert {n.node_id for n in graph.HostGraph.live_nodes()} == {b"A" * 16, b"B" * 16}
    assert archives[0] == archives[1]
    assert models[0] == models[1]
    assert tgraph.SerializationControl.IGNORE_ALWAYS == jgraph.SerializationControl.IGNORE_ALWAYS


def test_host_graph_alias_resurrection_equals_the_jax_package():
    """A node restored with a live identity becomes an alias and takes the
    identity over when its holder closes."""
    ids = []
    for pkg in ("torch", "jax"):
        _, graph, _ = PACKAGES[pkg]
        ser = tserialize if pkg == "torch" else jserialize
        holder = graph.HostGraph("holder")
        arch = ser.Archive()
        holder.serialize(arch)
        clone = graph.HostGraph("clone")
        clone.deserialize(ser.Archive.from_bytes(arch.to_bytes()))
        assert clone.node_id != holder.node_id
        ident = holder.node_id
        holder.close()
        ids.append((clone.node_id == ident, graph.HostGraph.find(ident) is clone))
    assert ids[0] == ids[1] == (True, True)
