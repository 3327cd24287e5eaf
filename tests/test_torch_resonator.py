"""The PyTorch port's resonator bank and ResonatorSpectrumProcessor against
the JAX package on the CPU. Inputs are made with numpy from a seed and
handed to both; both get the same precomputed block plan (held bit-equal in
tests/test_torch_port_copies.py). States are compared at 2e-6 of the state's
peak: the drive is a float32 dot product over the block, summed in another
order by the two libraries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.core.config import SpectrumChannels as JChannels
from signalizer_tpu.core.config import ViewScaling as JScaling
from signalizer_tpu.core.constant import make_spectrum_constant as jax_make
from signalizer_tpu.kernels import resonator as jr
from signalizer_tpu.kernels.spectrum import LineGraphState as JaxState
from signalizer_tpu.views import spectrum as jv
from signalizer_tpu_torch import ResonatorSpectrumProcessor, SpectrumChannels, ViewScaling
from signalizer_tpu_torch.core.constant import make_spectrum_constant
from signalizer_tpu_torch.kernels import display_map as dm
from signalizer_tpu_torch.kernels import resonator as tr
from signalizer_tpu_torch.kernels.spectrum import line_graph_state_from_arrays
from signalizer_tpu_torch.views import spectrum as tv

from test_golden import GOLDEN_DIR

FS = 48_000.0
P = 64
WINDOW = 512


def banks(p=48, window=256, **kw):
    freqs = np.geomspace(30.0, 20000.0, p)
    return (
        jr.make_resonator_constant(freqs, FS, window, **kw),
        tr.make_resonator_constant(freqs, FS, window, device="cpu", **kw),
    )


def assert_state_close(got, want, tol=2e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * float(np.abs(want).max()))


def undb(tc, results):
    """Display values back to linear units (clip_db -> 0)."""
    lower, dyr = (float(v) for v in tc.display_scalars[1:3])
    lin = np.exp(np.asarray(results, np.float64) / dyr) * lower
    return np.where(np.asarray(results) == float(tc.clip_db), 0.0, lin)


@pytest.mark.parametrize("free_q", [False, True])
@pytest.mark.parametrize("w", [1, 64, 200])
def test_resonate_block_matches_jax_with_a_plan(w, free_q):
    jc, tc = banks(free_q=free_q)
    rng = np.random.default_rng(w)
    x = (rng.standard_normal((3, 2, w)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((3, 2, 48, 3, 2)) * 4.0).astype(np.float32)
    t0 = tr.resonator_state_from_arrays(s0, "cpu")
    got = tr.resonate_block(tc, t0, torch.from_numpy(x), tr.make_block_plan(tc, w))
    want = jr.resonate_block(jc, jnp.asarray(s0), jnp.asarray(x), jr.make_block_plan(jc, w))
    assert got.shape == (3, 2, 48, 3, 2) and np.array_equal(t0.numpy(), s0)  # the input state is untouched
    assert_state_close(got, want)
    with pytest.raises(ValueError, match="plan is for block"):
        tr.resonate_block(tc, t0, torch.from_numpy(x), tr.make_block_plan(tc, w + 1))


def test_resonate_block_without_a_plan():
    """Without a plan the ramp is formed on the device from the float32
    poles, angles of up to W * pi radians in float32: 1e-4 of the state's
    peak against JAX's own plan-less form and against the planned one."""
    jc, tc = banks()
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 300)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((2, 48, 3, 2)) * 4.0).astype(np.float32)
    got = tr.resonate_block(tc, torch.from_numpy(s0), torch.from_numpy(x))
    assert_state_close(got, jr.resonate_block(jc, jnp.asarray(s0), jnp.asarray(x)), tol=1e-4)
    planned = tr.resonate_block(tc, torch.from_numpy(s0), torch.from_numpy(x), tr.make_block_plan(tc, 300))
    assert_state_close(got, planned.numpy(), tol=1e-4)


@pytest.mark.parametrize("emit", [False, True], ids=["state", "readouts"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "valid_mask"])
def test_resonate_chunks_matches_jax(masked, emit):
    """T = 6 chunks from a carried state, with padded chunks and with a
    readout per chunk [T, ..., P] (2e-6 of the readouts' peak)."""
    jc, tc = banks()
    rng = np.random.default_rng(7)
    chunks = (rng.standard_normal((2, 2, 6, 96)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((2, 2, 48, 3, 2)) * 2.0).astype(np.float32)
    valid = np.array([True, False, True, True, False, True]) if masked else None
    got = tr.resonate_chunks(
        tc, torch.from_numpy(s0), torch.from_numpy(chunks), valid=valid,
        plan=tr.make_block_plan(tc, 96), emit_readouts=emit,
    )
    want = jr.resonate_chunks(
        jc, jnp.asarray(s0), jnp.asarray(chunks), valid=None if valid is None else jnp.asarray(valid),
        plan=jr.make_block_plan(jc, 96), emit_readouts=emit,
    )
    if emit:
        assert got[1].shape == (6, 2, 2, 48)
        assert_state_close(got[1], want[1])
        got, want = got[0], want[0]
    assert_state_close(got, want)
    if masked:
        # padded chunks are identity steps: what they hold does not matter
        # (bit for bit), and the valid chunks alone give the same state (a
        # matrix product of another height may sum in another order: 1e-6)
        other = chunks.copy()
        other[:, :, ~valid] = 7.0
        again = tr.resonate_chunks(
            tc, torch.from_numpy(s0), torch.from_numpy(other), valid=valid, plan=tr.make_block_plan(tc, 96)
        )
        assert torch.equal(got, again)
        alone = tr.resonate_chunks(
            tc, torch.from_numpy(s0), torch.from_numpy(chunks[:, :, valid]), plan=tr.make_block_plan(tc, 96)
        )
        assert_state_close(got, alone.numpy(), 1e-6)
    with pytest.raises(ValueError, match="valid has"):
        tr.resonate_chunks(tc, torch.from_numpy(s0), torch.from_numpy(chunks), valid=[True] * 5)


def test_chunks_equal_blocks_in_sequence():
    """resonate_chunks is resonate_block chunk after chunk, bit for bit
    (one matrix product for all chunks against one per chunk may differ in
    the last place: 1e-6 of the peak)."""
    _, tc = banks()
    rng = np.random.default_rng(8)
    chunks = torch.from_numpy((rng.standard_normal((2, 5, 64)) * 0.5).astype(np.float32))
    plan = tr.make_block_plan(tc, 64)
    state = tr.init_resonator_state(tc, (2,))
    for i in range(5):
        state = tr.resonate_block(tc, state, chunks[:, i], plan)
    assert_state_close(tr.resonate_chunks(tc, tr.init_resonator_state(tc, (2,)), chunks, plan=plan), state.numpy(), 1e-6)


def test_readouts_match_jax():
    jc, tc = banks(window_type=jr.WindowType.BLACKMAN_HARRIS)
    s = (np.random.default_rng(9).standard_normal((3, 48, 7, 2)) * 3.0).astype(np.float32)
    re, im = tr.resonator_readout_complex(tc, torch.from_numpy(s))
    jre, jim = jr.resonator_readout_complex(jc, jnp.asarray(s))
    scale = float(np.abs(np.asarray(jre)).max())
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(
        tr.resonator_readout(tc, torch.from_numpy(s)).numpy(), np.asarray(jr.resonator_readout(jc, jnp.asarray(s))),
        rtol=0, atol=2e-6 * scale,
    )


@pytest.mark.parametrize("planned", [False, True], ids=["no_plan", "plan"])
def test_golden_two_tone(planned):
    """tests/golden/resonator_two_tone.npz at the JAX test's own tolerance
    (tests/test_golden.py: rtol 1e-4, atol 1e-5), and the two tones peak at
    their pixels."""
    freqs = np.linspace(100.0, 12_000.0, 96)
    tc = tr.make_resonator_constant(freqs, FS, window_size=1024, device="cpu")
    t = np.arange(4096)
    x = (0.7 * np.sin(2 * np.pi * freqs[24] * t / FS) + 0.2 * np.sin(2 * np.pi * freqs[72] * t / FS)).astype(np.float32)
    plan = tr.make_block_plan(tc, 4096) if planned else None
    state = tr.resonate_block(tc, tr.init_resonator_state(tc), torch.from_numpy(x), plan)
    got = tr.resonator_readout(tc, state).numpy()
    want = np.load(GOLDEN_DIR / "resonator_two_tone.npz")["results"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert int(np.argmax(got)) == 24 and int(np.argmax(got[48:])) + 48 == 72
    assert abs(got[24] - 0.7) < 0.01 and abs(got[72] - 0.2) < 0.01


def test_tf32_is_refused_on_a_gpu_and_never_set(monkeypatch):
    """The module reads the TF32 setting and never writes it; for a CUDA
    tensor with TF32 allowed it raises (checked with a stand-in tensor: the
    check looks at the device type only)."""
    before = torch.backends.cuda.matmul.allow_tf32

    class OnCuda:
        device = torch.device("cuda")

    if before:
        with pytest.raises(RuntimeError, match="TF32"):
            tr._full_f32_matmul(OnCuda())
    else:
        tr._full_f32_matmul(OnCuda())
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        with pytest.raises(RuntimeError, match="TF32"):
            tr._full_f32_matmul(OnCuda())
        monkeypatch.undo()
    tr._full_f32_matmul(torch.zeros(1))  # CPU: nothing to refuse
    assert torch.backends.cuda.matmul.allow_tf32 == before


MODES = [SpectrumChannels.LEFT, SpectrumChannels.MIDSIDE, SpectrumChannels.SEPARATE, SpectrumChannels.PHASE,
         SpectrumChannels.MERGE, SpectrumChannels.SIDE, SpectrumChannels.RIGHT]


def processors(mode, pairs=2, **kw):
    ckw = dict(axis_points=P, window_size=WINDOW, sample_rate=FS, **kw)
    jc = jax_make(fft_backend="xla", configuration=JChannels(mode), view_scaling=JScaling.LOGARITHMIC, **ckw)
    tc = make_spectrum_constant(device="cpu", configuration=mode, view_scaling=ViewScaling.LOGARITHMIC, **ckw)
    return jv.ResonatorSpectrumProcessor(jc, pairs=pairs), ResonatorSpectrumProcessor(tc, pairs=pairs)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_mix_matches_jax(mode):
    x = (np.random.default_rng(10).standard_normal((3, 2, 4, 50))).astype(np.float32)
    got = tv._mix_rsnt(mode, torch.from_numpy(x)).numpy()
    want = np.asarray(jv._mix_rsnt(JChannels(mode), jnp.asarray(x)))
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("mode", MODES[:4], ids=lambda m: m.name)
def test_processor_matches_jax_over_a_stream(mode):
    """From a carried-over state: two single-chunk ticks, then a backlog of
    T = 4 chunks with the last invalid. Bank state 2e-6 of its peak; display
    1e-5 (2e-3 in linear units for PHASE's cancellation row: 1 - |l+r| /
    (|l|+|r|) of nearly equal numbers, the bound tests/test_spectrum.py
    holds PHASE values to); graph state rtol 1e-5."""
    jp, tp = processors(mode)
    assert np.array_equal(tp.resonator.host_poles, jp.resonator.host_poles.array())
    rng = np.random.default_rng(30 + int(mode))
    rows = tp.rows
    n = np.arange(3000)
    stream = (rng.standard_normal((2, 2, 3000)) * 0.05).astype(np.float32)
    stream[:, 0] += (0.5 * np.sin(2 * np.pi * 1000.0 * n / FS)).astype(np.float32)
    stream[:, 1] += (0.3 * np.sin(2 * np.pi * 1000.0 * n / FS + 0.4)).astype(np.float32)
    res0 = (rng.standard_normal((2, rows, P, 3, 2)) * 0.5).astype(np.float32)
    mag0 = (rng.random((2, 2, rows, P)) * 0.01).astype(np.float32)
    phase0 = (rng.random((2, 2, P)) * 0.01).astype(np.float32)
    jp._res_state, jp._graph_state = jnp.asarray(res0), JaxState(jnp.asarray(mag0), jnp.asarray(phase0))
    tp.load_state(tr.resonator_state_from_arrays(res0, "cpu"), line_graph_state_from_arrays(mag0, phase0, "cpu"))
    calls = [
        ("process", (stream[..., :400],), {}),
        ("process", (stream[..., 400:800],), {}),
        ("process_chunks", (stream[..., 800:1824].reshape(2, 2, 4, 256),), dict(valid=np.array([True, True, True, False]))),
        ("process_chunks", (stream[..., 1824:2336].reshape(2, 2, 2, 256),), {}),
    ]
    for name, args, kw in calls:
        got = getattr(tp, name)(*args, **kw).numpy()
        want = np.asarray(getattr(jp, name)(*args, **kw))
        assert got.shape == want.shape == (2, 1, 2, rows, P)
        assert_state_close(tp.res_state, jp.res_state)
        if mode == SpectrumChannels.PHASE:
            np.testing.assert_allclose(got[..., 0, :], want[..., 0, :], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(undb(tp.constant, got[..., 1, :]), undb(tp.constant, want[..., 1, :]), atol=2e-3)
            np.testing.assert_allclose(tp.graph_state.phase.numpy(), np.asarray(jp.graph_state.phase), atol=2e-3)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            tp.graph_state.magnitude.numpy(), np.asarray(jp.graph_state.magnitude), rtol=1e-5, atol=1e-7
        )
    assert sorted(tp._plans) == [256, 400]


def test_invalid_chunks_leave_the_bank_untouched():
    """What a backlog's invalid chunks hold does not matter, bit for bit
    (bank, graph state and display), and the valid chunks alone give the
    same bank within 1e-6 of its peak (a matrix product of another height);
    a call with no valid chunk leaves the bank as it was and displays it
    once more."""
    _, a = processors(SpectrumChannels.SEPARATE)
    _, b = processors(SpectrumChannels.SEPARATE)
    _, c = processors(SpectrumChannels.SEPARATE)
    x = torch.from_numpy((np.random.default_rng(11).standard_normal((2, 2, 8, 128)) * 0.3).astype(np.float32))
    valid = np.array([True] * 5 + [False] * 3)
    other = x.clone()
    other[:, :, 5:] = -3.0
    out_a = a.process_chunks(x, valid=valid)
    out_b = b.process_chunks(other, valid=valid)
    assert torch.equal(out_a, out_b) and torch.equal(a.res_state, b.res_state)
    assert torch.equal(a.graph_state.magnitude, b.graph_state.magnitude)
    out_c = c.process_chunks(x[:, :, :5])
    assert_state_close(a.res_state, c.res_state.numpy(), 1e-6)
    torch.testing.assert_close(out_a, out_c, rtol=1e-5, atol=1e-5)
    bank = a.res_state.clone()
    a.process_chunks(x, valid=np.zeros(8, bool))
    assert torch.equal(a.res_state, bank)


def test_display_tail_goes_through_the_decay_db_wrapper(monkeypatch):
    """The magnitude modes end in kernel B's decay-and-dB entry (its plain
    version on the CPU); PHASE ends in the plain PHASE tail."""
    from signalizer_tpu_torch.kernels import spectrum as ts

    seen = []
    real = dm.display_decay_db
    monkeypatch.setattr(ts, "display_decay_db", lambda *a, **k: (seen.append(a[2].shape), real(*a, **k))[1])
    _, tp = processors(SpectrumChannels.SEPARATE)
    tp.process(np.zeros((2, 2, 100), np.float32))
    assert seen == [(2, 1, 2, P)]
    _, ph = processors(SpectrumChannels.PHASE)
    ph.process(np.zeros((2, 2, 100), np.float32))
    assert len(seen) == 1


def test_two_tone_peaks_and_create():
    p = ResonatorSpectrumProcessor.create(
        pairs=1, device="cpu", axis_points=128, window_size=1024, sample_rate=FS,
        configuration=SpectrumChannels.SEPARATE, view_scaling=ViewScaling.LOGARITHMIC,
    )
    f = p.constant.host_frequencies
    n = np.arange(4800)
    x = np.stack([0.7 * np.sin(2 * np.pi * f[60] * n / FS), 0.4 * np.sin(2 * np.pi * f[100] * n / FS)])[None]
    for at in range(0, 4800, 800):
        out = p.process(x[..., at : at + 800].astype(np.float32))
    assert int(out[0, 0, 0, 0].argmax()) == 60 and int(out[0, 0, 0, 1].argmax()) == 100
    p.reset()
    assert not p.res_state.any() and not p.graph_state.magnitude.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            ResonatorSpectrumProcessor.create(pairs=1, axis_points=32, window_size=128)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tr.make_resonator_constant(f, FS, 128)
