"""The port keeps its own copies of the JAX package's jax-free helpers
(enums, windows, the decay-pole design, ``TimeMode``, the key-colour table,
the host ring buffer, the frame batcher, the device ring's host half and the
resonator bank's numpy design): each copy against its original, on the CPU,
bit for bit."""

import enum

import numpy as np
import pytest

from signalizer_tpu.core import config as jconfig
from signalizer_tpu.core import scaling as jscaling
from signalizer_tpu.core import windows as jwindows
from signalizer_tpu.params import transformatters as jtransformatters
from signalizer_tpu.utils import colour as jcolour
from signalizer_tpu_torch.core import config as tconfig
from signalizer_tpu_torch.core import scaling as tscaling
from signalizer_tpu_torch.core import windows as twindows
from signalizer_tpu_torch.params import transformatters as ttransformatters
from signalizer_tpu_torch.utils import colour as tcolour


def _same_enum(ours, theirs):
    assert issubclass(ours, enum.IntEnum) and ours is not theirs
    # __members__ includes aliases (MID, OFFSET_FOR_MONO)
    assert {k: int(v) for k, v in ours.__members__.items()} == {
        k: int(v) for k, v in theirs.__members__.items()
    }
    for name, member in ours.__members__.items():
        assert member == theirs[name] and hash(member) == hash(theirs[name])


@pytest.mark.parametrize(
    "name",
    ["OscChannels", "SpectrumChannels", "BinInterpolation", "ViewScaling", "DisplayMode", "TransformAlgorithm"],
)
def test_config_enums_equal_the_jax_package(name):
    ours, theirs = getattr(tconfig, name), getattr(jconfig, name)
    _same_enum(ours, theirs)
    for member in ours:
        for prop in ("is_mono", "state_channels"):
            if hasattr(member, prop):
                assert getattr(member, prop) == getattr(theirs(member), prop), (member, prop)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 24, 255, 256, 257, 4096, 20000, 2**20 + 1])
def test_next_pow2_equals_the_jax_package(n):
    assert tconfig.next_pow2(n) == jconfig.next_pow2(n)


@pytest.mark.parametrize("size", [8, 255, 4096])
@pytest.mark.parametrize("wtype", list(jwindows.WindowType), ids=lambda w: w.name)
def test_generate_window_is_bit_equal(wtype, size):
    """Every window type at the keyword variants the constant passes
    (symmetric and periodic, alpha, beta): kernels and scales identical."""
    _same_enum(twindows.WindowType, jwindows.WindowType)
    for kw in (
        {},
        dict(symmetric=False),
        dict(symmetric=True, alpha=2.5, beta=8.0),
        dict(symmetric=False, alpha=1.25, beta=3.0),
    ):
        ours, scale = twindows.generate_window(twindows.WindowType(wtype), size, **kw)
        theirs, jscale = jwindows.generate_window(wtype, size, **kw)
        assert ours.dtype == theirs.dtype == np.float64
        assert np.array_equal(ours, theirs), kw
        assert scale == jscale
        assert twindows.window_scale(twindows.WindowType(wtype), size, **kw) == jscale
    if wtype in jwindows.FINITE_DFT_WINDOWS:
        assert twindows.window_coefficients(twindows.WindowType(wtype)) == jwindows.window_coefficients(wtype)
    else:
        with pytest.raises(KeyError):
            twindows.window_coefficients(twindows.WindowType(wtype))


@pytest.mark.parametrize("fps", [0.0, 30.0, 60.0, 93.75])
@pytest.mark.parametrize("seconds", [-1.0, 0.0, 0.01, 0.1, 1.0, 7.5])
def test_peak_decay_pole_is_bit_equal(seconds, fps):
    assert tscaling.peak_decay_pole(seconds, fps) == jscaling.peak_decay_pole(seconds, fps)
    assert tscaling.peak_decay_pole(seconds, fps, 0.5) == jscaling.peak_decay_pole(seconds, fps, 0.5)


def test_time_mode_equals_the_jax_package():
    _same_enum(ttransformatters.TimeMode, jtransformatters.TimeMode)


@pytest.mark.parametrize("pairs", [0, 1, 2, 5, 16])
@pytest.mark.parametrize(
    "primary,secondary",
    [
        ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0)),
        ((0.9, 0.2, 0.1), (0.1, 0.4, 0.8)),
        ((0.3, 0.3, 0.3, 1.0), (0.0, 1.0, 0.5, 0.5)),
    ],
    ids=["white", "red_blue", "rgba"],
)
def test_pair_key_table_is_bit_equal(primary, secondary, pairs):
    ours = tcolour.pair_key_table(primary, secondary, pairs)
    theirs = jcolour.pair_key_table(primary, secondary, pairs)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape
    assert np.array_equal(ours, theirs)
    assert tcolour.with_rotated_hue(primary, 0.37) == jcolour.with_rotated_hue(primary, 0.37)


# ---------------------------------------------------------------------------
# host stream helpers and the resonator's design (numpy, copied)
# ---------------------------------------------------------------------------


def _push_sizes(rng, n, big):
    """Ragged push sizes: mostly small, now and then a burst of ``big``."""
    sizes = rng.integers(1, 400, n)
    sizes[rng.random(n) < 0.1] = big
    return [int(s) for s in sizes]


@pytest.mark.parametrize("capacity", [64, 1000])
def test_ring_buffer_equals_the_original(capacity):
    """Seeded writes (blocks larger than the ring included), latest,
    read_at (valid, overwritten and future) and seek_to give the same
    arrays, clocks and errors."""
    from signalizer_tpu.stream.ring_buffer import RingBuffer as JRing
    from signalizer_tpu_torch.native_bindings import NativeRingBuffer, native_available
    from signalizer_tpu_torch.stream.ring_buffer import RingBuffer as TRing
    from signalizer_tpu_torch.stream.ring_buffer import make_ring_buffer

    # the factory returns the native ring where g++ built it, as the JAX
    # package's does (tests/test_torch_stream_copies.py holds the two equal)
    assert type(make_ring_buffer(2, 8)) is (NativeRingBuffer if native_available() else TRing)
    assert type(make_ring_buffer(2, 8, prefer_native=False)) is TRing
    rng = np.random.default_rng(capacity)
    ours, theirs = TRing(3, capacity), JRing(3, capacity)
    for n in _push_sizes(rng, 40, capacity + 17):
        block = rng.standard_normal((3, n)).astype(np.float32)
        ours.write(block)
        theirs.write(block)
        assert ours.sample_clock == theirs.sample_clock and ours.valid_samples == theirs.valid_samples
        k = int(rng.integers(1, capacity + 1))
        assert np.array_equal(ours.latest(k), theirs.latest(k))
        back = int(rng.integers(0, capacity))
        try:
            want = theirs.read_at(theirs.sample_clock - back, k)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                ours.read_at(ours.sample_clock - back, k)
        else:
            assert np.array_equal(ours.read_at(ours.sample_clock - back, k), want)
    with pytest.raises(ValueError, match="future"):
        ours.read_at(ours.sample_clock + 1, 4)
    for ring in (ours, theirs):
        ring.seek_to(ring.sample_clock + 10)
    assert np.array_equal(ours.latest(capacity), theirs.latest(capacity)) and ours.sample_clock == theirs.sample_clock
    for ring in (ours, theirs):
        ring.seek_to(ring.sample_clock + 3 * capacity)
    assert not ours.latest(capacity).any() and ours.sample_clock == theirs.sample_clock
    with pytest.raises(ValueError):
        TRing(0, 8)


@pytest.mark.parametrize("hop", [16.0, 33.3, 100.5, 480.0], ids=lambda h: f"hop{h}")
def test_frame_batcher_equals_the_original(hop):
    """Fractional hops (the round-half-up end clock), capped pulls, and
    bursts that overrun the ring (dropped frames): the same frames, counts
    and cursors at every step."""
    from signalizer_tpu.stream.batcher import FrameBatcher as JBatcher
    from signalizer_tpu_torch.stream.batcher import FrameBatcher as TBatcher

    rng = np.random.default_rng(int(hop * 10))
    kw = dict(capacity=600)
    ours, theirs = TBatcher(4, 128, hop, **kw), JBatcher(4, 128, hop, **kw)
    # the original may pick its native ring; the numpy ring is the contract
    from signalizer_tpu.stream.ring_buffer import RingBuffer as JRing
    theirs.ring = JRing(4, 600)
    emitted = 0
    for i, n in enumerate(_push_sizes(rng, 60, 900)):
        block = rng.standard_normal((4, n)).astype(np.float32)
        ours.push(block)
        theirs.push(block)
        assert ours.frames_ready() == theirs.frames_ready()
        cap = None if i % 3 else 2
        got, want = ours.pull(cap), theirs.pull(cap)
        assert got.shape == want.shape and np.array_equal(got, want)
        assert ours.dropped_frames == theirs.dropped_frames and ours._next_frame == theirs._next_frame
        emitted += got.shape[0]
    assert emitted > 0 and ours.dropped_frames > 0
    with pytest.raises(ValueError):
        TBatcher(2, 0, 1.0)


def test_frame_batcher_takes_a_ring_with_frame_gather():
    """The duck-typed bulk path: a ring that offers ``frame_gather`` is
    asked once for all ready frames."""
    from signalizer_tpu_torch.stream.batcher import FrameBatcher

    b = FrameBatcher(2, 16, 8.0)
    calls = []

    class Gathering(type(b.ring)):
        def frame_gather(self, first, count, hop, window):
            calls.append((first, count, hop, window))
            return np.zeros((count - 1, self.channels, window), np.float32)  # one frame lost

    b.ring = Gathering(2, 256)
    b.push(np.zeros((2, 40), np.float32))
    out = b.pull()
    assert calls == [(0, 4, 8.0, 16)] and out.shape == (3, 2, 16)
    assert b.dropped_frames == 1 and b._next_frame == 4


@pytest.mark.parametrize("t_cap,max_pending", [(32, None), (5, None), (4, 6)], ids=["cap32", "cap5", "drops"])
def test_device_frame_source_equals_the_original(t_cap, max_pending):
    """Ragged pushes, capped pulls, non-pow2 t_cap, and (with a pending
    limit) drops followed by a re-prime on the absolute frame grid: the same
    upload units and counters at every step."""
    from signalizer_tpu.stream.device_ring import DeviceFrameSource as JSource
    from signalizer_tpu_torch.stream.device_ring import DeviceFrameSource as TSource
    from signalizer_tpu_torch.stream.device_ring import UploadUnit

    rng = np.random.default_rng(t_cap)
    kw = dict(t_cap=t_cap, max_pending_frames=max_pending)
    ours, theirs = TSource((2, 2), 128, 48, **kw), JSource((2, 2), 128, 48, **kw)
    assert ours.history == theirs.history
    units = 0
    for i, n in enumerate(_push_sizes(rng, 50, 1500)):
        block = rng.standard_normal((2, 2, n)).astype(np.float32)
        ours.push(block)
        theirs.push(block)
        assert ours.frames_ready() == theirs.frames_ready()
        if i % 4 == 3:
            continue  # let the backlog grow
        cap = None if i % 3 else 3
        got, want = ours.pull_uploads(cap), theirs.pull_uploads(cap)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert isinstance(g, UploadUnit)
            assert np.array_equal(g.samples, w.samples) and g.n_valid == w.n_valid
            assert np.array_equal(g.frame_valid, w.frame_valid) and g.t_valid == w.t_valid
        units += len(got)
        for name in ("frames_produced", "dropped_frames", "sample_clock", "_next_frame", "_primed", "_front"):
            assert getattr(ours, name) == getattr(theirs, name), name
    assert units > 0
    assert (ours.dropped_frames > 0) == (max_pending is not None)
    for bad in (dict(hop=1.5), dict(hop=0), dict(window=0), dict(t_cap=0), dict(history=10)):
        args = dict(window=128, hop=48)
        extra = {k: bad[k] for k in bad if k not in args}
        args.update({k: bad[k] for k in bad if k in args})
        with pytest.raises(ValueError):
            TSource((1,), args["window"], args["hop"], **extra)


@pytest.mark.parametrize("free_q", [False, True])
@pytest.mark.parametrize("wtype", ["HANN", "RECTANGULAR", "BLACKMAN_HARRIS", "FLAT_TOP"])
def test_resonator_design_is_bit_equal(wtype, free_q):
    """make_resonator_constant and make_block_plan: the float64 design and
    its float32 roundings equal the JAX package's arrays bit for bit."""
    from signalizer_tpu.kernels import resonator as jres
    from signalizer_tpu_torch.kernels import resonator as tres

    freqs = np.geomspace(20.0, 23000.0, 48)
    jc = jres.make_resonator_constant(freqs, 48000.0, 1024, window_type=jwindows.WindowType[wtype], free_q=free_q)
    tc = tres.make_resonator_constant(
        freqs, 48000.0, 1024, device="cpu", window_type=twindows.WindowType[wtype], free_q=free_q
    )
    assert (tc.num_pixels, tc.vectors) == (jc.num_pixels, jc.vectors)
    assert np.array_equal(tc.host_poles, jc.host_poles.array())
    for name in ("poles", "combine", "gain"):
        ours, theirs = getattr(tc, name).numpy(), np.asarray(getattr(jc, name))
        assert ours.dtype == theirs.dtype == np.float32 and np.array_equal(ours, theirs), name
    for block in (1, 64, 200):
        jp, tp = jres.make_block_plan(jc, block), tres.make_block_plan(tc, block)
        assert tp.block == jp.block == block
        assert np.array_equal(tp.ramp.numpy(), np.asarray(jp.ramp))
        assert np.array_equal(tp.decay.numpy(), np.asarray(jp.decay))
        assert tp.drive_matrix.shape == (tc.num_pixels * tc.vectors * 2, block) and tp.drive_matrix.is_contiguous()
