"""The port's DevicePresentationHistory (``device="cpu"``) against the JAX
package's and against the host ring, in the cases of
tests/test_device_history.py. The same seeded numpy blocks go through a
stream of each package; every window must equal the JAX mirror's window and
``get_history(n)`` bit for bit (tolerance 0: the mirror only moves
samples)."""

import numpy as np
import pytest

from signalizer_tpu.stream import audio_stream as jaudio
from signalizer_tpu.stream.device_history import DevicePresentationHistory as JaxHistory
from signalizer_tpu_torch.stream import audio_stream as taudio
from signalizer_tpu_torch.stream import device_history as tdh
from signalizer_tpu_torch.stream.device_history import DevicePresentationHistory

FS = 48_000.0


class _Pair:
    """One stream of each package fed the same blocks, each with its
    mirror attached."""

    def __init__(self, channels=2, cap=4096, attach=True):
        self.streams = []
        for audio in (taudio, jaudio):
            info = audio.AudioStreamInfo(channels=channels, sample_rate=FS, audio_history_capacity=cap)
            self.streams.append(audio.AudioStream.create(False, info))
        self.dh = self.jdh = None
        if attach:
            self.attach()

    def attach(self):
        self.dh = DevicePresentationHistory(self.out, device="cpu")
        self.jdh = JaxHistory(self.streams[1][1])

    @property
    def out(self):
        return self.streams[0][1]

    def push(self, block):
        for (inp, _), audio in zip(self.streams, (taudio, jaudio)):
            inp.process_incoming_audio(block, audio.Playhead())

    def sync(self):
        self.dh.sync()
        self.jdh.sync()

    def modify(self, fn):
        for _, out in self.streams:
            out.modify_consumer_info(fn)

    def check(self, n, **kw):
        ours = self.dh.window(n, **kw).numpy()
        np.testing.assert_array_equal(ours, np.asarray(self.jdh.window(n, **kw)))
        host = self.out.get_history(n)
        np.testing.assert_array_equal(host, self.streams[1][1].get_history(n))
        return ours, host

    def close(self):
        self.dh.close()
        self.jdh.close()


def _blocks(rng, channels, sizes):
    return [rng.standard_normal((channels, n)).astype(np.float32) for n in sizes]


def test_window_matches_host_ring_ragged():
    rng = np.random.default_rng(0)
    p = _Pair(cap=2048)
    sizes = [1, 7, 128, 300, 1, 64, 512, 2048, 3, 5000, 17, 999]
    for i, b in enumerate(_blocks(rng, 2, sizes)):
        p.push(b)
        if i % 3 == 2:  # sync at an uneven cadence (multiple blocks a tick)
            p.sync()
            for n in (1, 5, 128, 1000, 2048):
                ours, host = p.check(n)
                np.testing.assert_array_equal(ours, host, err_msg=f"push #{i} window {n}")
    # a sync with nothing pending is a no-op
    r0 = p.dh.sync().clone()
    assert p.dh.uploaded_samples == 0
    np.testing.assert_array_equal(p.dh.sync().numpy(), r0.numpy())
    p.close()


def test_each_sync_uploads_only_the_new_samples():
    """After the first sync (a prime of the whole ring) a sync uploads
    exactly the samples that arrived: channels x n x 4 bytes."""
    rng = np.random.default_rng(10)
    p = _Pair(channels=16, cap=4096)
    p.push(_blocks(rng, 16, [900])[0])
    p.sync()
    assert p.dh.reprimes == 1 and p.dh.uploaded_samples == 4096
    for n in (800, 1, 800, 333):
        p.push(_blocks(rng, 16, [n])[0])
        p.sync()
        assert (p.dh.uploaded_samples, p.dh.uploaded_bytes) == (n, 16 * n * 4)
        ours, host = p.check(4096)
        np.testing.assert_array_equal(ours, host)
    assert p.dh.reprimes == 1
    p.close()


def test_prefill_covers_pre_attach_audio():
    rng = np.random.default_rng(1)
    p = _Pair(cap=1024, attach=False)
    for b in _blocks(rng, 2, [400, 700]):  # audio before the ring attaches
        p.push(b)
    p.attach()
    ours, host = p.check(1024)
    np.testing.assert_array_equal(ours, host)
    # and post-attach audio continues seamlessly on top of the prefill
    p.push(_blocks(rng, 2, [333])[0])
    p.sync()
    ours, host = p.check(1024)
    np.testing.assert_array_equal(ours, host)
    p.close()


def test_overrun_reprimes_on_grid():
    """More pending than the whole ring between syncs -> full re-prime,
    still bit-exact with the host ring."""
    rng = np.random.default_rng(2)
    p = _Pair(cap=512)
    for b in _blocks(rng, 2, [100, 512, 512, 300]):  # 1424 samples, H=512
        p.push(b)
    p.sync()
    ours, host = p.check(512)
    np.testing.assert_array_equal(ours, host)
    # pending stays bounded near H even without syncs (freeze semantics)
    for b in _blocks(rng, 2, [512] * 8):
        p.push(b)
    assert p.dh._pending_n == p.jdh._pending_n <= 2 * 512
    p.sync()
    ours, host = p.check(512)
    np.testing.assert_array_equal(ours, host)
    assert p.dh.reprimes == 2
    p.close()


def test_mono_stream_windows():
    rng = np.random.default_rng(3)
    p = _Pair(channels=1, cap=1024)
    p.push(_blocks(rng, 1, [700])[0])
    p.sync()
    w, _ = p.check(256, pad_to=2)
    assert w.shape == (2, 256)
    np.testing.assert_array_equal(w[:1], p.out.get_history(256))
    np.testing.assert_array_equal(w[1], np.zeros(256, np.float32))
    lead, _ = p.check(256, lead=2)
    assert lead.shape == (1, 1, 1, 256)
    p.close()


def test_window_is_a_view_of_the_ring():
    rng = np.random.default_rng(12)
    p = _Pair(channels=4, cap=1024)
    p.push(_blocks(rng, 4, [600])[0])
    p.sync()
    w = p.dh.window(512)
    assert w.data_ptr() == p.dh.ring[:, 1024 - 512 :].data_ptr()
    assert w.stride(0) >= 1024
    with pytest.raises(ValueError, match="exceeds"):
        p.dh.window(1025)
    p.close()


class _StampedCtx:
    """Minimal stamped ListenerContext stand-in for race simulations."""

    def __init__(self, end, gen):
        self.block_end_clock = end
        self.ring_generation = gen


def test_resize_discards_stale_pending():
    """Pending blocks delivered before a capacity change must not leak
    into the re-primed ring."""
    rng = np.random.default_rng(5)
    p = _Pair(cap=2048)
    p.push(_blocks(rng, 2, [600])[0])
    assert p.dh._pending_n == 600
    p.modify(lambda info: setattr(info, "audio_history_capacity", 1024))
    p.sync()
    ours, host = p.check(1024)
    np.testing.assert_array_equal(ours, host)
    assert not ours.any()  # silence, no ghosts
    p.push(_blocks(rng, 2, [300])[0])
    p.sync()
    ours, host = p.check(1024)
    np.testing.assert_array_equal(ours, host)
    p.close()


def test_stale_redelivery_is_dropped():
    """A block whose samples are already inside a snapshot must be dropped
    by the stamp filter, not shifted in twice."""
    rng = np.random.default_rng(6)
    p = _Pair(cap=1024, attach=False)
    stale = _blocks(rng, 2, [200])[0]
    p.push(stale)
    p.attach()
    p.sync()
    assert p.dh._clock == p.jdh._clock == 200
    p.dh.on_stream_audio(_StampedCtx(200, p.out.ring_generation), stale)
    p.jdh.on_stream_audio(_StampedCtx(200, p.streams[1][1].ring_generation), stale)
    p.sync()
    ours, host = p.check(1024)
    np.testing.assert_array_equal(ours, host)
    assert p.dh._clock == 200  # nothing ingested
    p.close()


def test_missed_delivery_gap_reprimes():
    """A delivery the mirror never saw breaks the stamp chain; sync must
    detect the gap and re-prime bit-exact."""
    rng = np.random.default_rng(7)
    p = _Pair(cap=1024)
    p.push(_blocks(rng, 2, [100])[0])
    p.sync()
    p.out.remove_listener(p.dh)
    p.streams[1][1].remove_listener(p.jdh)
    p.push(_blocks(rng, 2, [50])[0])
    p.out.add_listener(p.dh)
    p.streams[1][1].add_listener(p.jdh)
    p.push(_blocks(rng, 2, [75])[0])
    p.sync()
    ours, host = p.check(1024)
    np.testing.assert_array_equal(ours, host)
    assert p.dh._clock == p.jdh._clock == 225
    p.close()


def test_generation_flip_back_reprimes():
    """Two quick reconfigures back to the same shape restart the host clock
    (a new ring generation): pending of the old generation re-primes."""
    rng = np.random.default_rng(8)
    p = _Pair(cap=1024)
    p.push(_blocks(rng, 2, [128])[0])
    p.sync()
    p.push(_blocks(rng, 2, [64])[0])  # old generation
    p.modify(lambda info: setattr(info, "audio_history_capacity", 512))
    p.modify(lambda info: setattr(info, "audio_history_capacity", 1024))
    p.push(_blocks(rng, 2, [32])[0])  # new generation
    p.sync()
    ours, host = p.check(1024)
    np.testing.assert_array_equal(ours, host)
    p.close()


def test_failed_upload_recovers_bit_exact(monkeypatch):
    """If the upload dies mid-sync no samples are lost: the ring re-arms
    from the host ring and the next sync matches."""
    rng = np.random.default_rng(4)
    p = _Pair(cap=1024)
    p.push(_blocks(rng, 2, [500])[0])
    p.sync()
    real = tdh._upload
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        raise RuntimeError("copy failed")

    p.push(_blocks(rng, 2, [321])[0])
    p.jdh.sync()
    monkeypatch.setattr(tdh, "_upload", flaky)
    with pytest.raises(RuntimeError):
        p.dh.sync()
    assert calls["n"] == 1 and p.dh.ring is None
    monkeypatch.setattr(tdh, "_upload", real)
    # more audio arrives while broken; recovery must include both the
    # failed upload's samples and the new ones
    p.push(_blocks(rng, 2, [77])[0])
    p.sync()
    ours, host = p.check(1024)
    np.testing.assert_array_equal(ours, host)
    p.close()


def test_threaded_stream_mirror_equals_get_history():
    """A threaded stream (native packet queue) with the mirror attached:
    after each drained push the windows equal ``get_history``."""
    rng = np.random.default_rng(9)
    info = taudio.AudioStreamInfo(channels=16, sample_rate=FS, audio_history_capacity=4096)
    inp, out = taudio.AudioStream.create(True, info)
    dh = DevicePresentationHistory(out, device="cpu")
    try:
        for n in (800, 800, 257, 5000, 800):
            inp.process_incoming_audio(rng.standard_normal((16, n)).astype(np.float32))
            assert inp._stream.wait_for_drain(timeout=5.0)
            dh.sync()
            for w in (1, 800, 4096):
                np.testing.assert_array_equal(dh.window(w).numpy(), out.get_history(w))
    finally:
        dh.close()
        inp._stream.close()
