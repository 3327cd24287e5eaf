"""Kernel G's plain version (the PHASE display tail: the mid row's peak
decay, the phase smoothing, the dB map of both rows) against the JAX
package's ``post_process`` in PHASE, on the CPU. The values go in directly,
made with numpy from a seed and handed to both.

Tolerances are those tests/test_torch_spectrum.py holds PHASE to: the
magnitude row and the magnitude state at rtol 1e-5 (atol 1e-5 on display
values, 1e-7 on the state: JAX decays by an associative scan, whose pole
products round in another order), the phase row in linear units and the
phase state at atol 2e-3. A float32 loop in numpy (no flush of subnormals,
as XLA's CPU has) holds the states bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.core.config import SpectrumChannels as JChannels
from signalizer_tpu.core.config import ViewScaling as JScaling
from signalizer_tpu.core.constant import make_spectrum_constant as jax_make
from signalizer_tpu.kernels.spectrum import LineGraphState as JaxState
from signalizer_tpu.kernels.spectrum import post_process as jax_post_process
from signalizer_tpu_torch import SpectrumChannels, ViewScaling
from signalizer_tpu_torch.core.constant import make_spectrum_constant
from signalizer_tpu_torch.kernels import phase_decay_db as pd
from signalizer_tpu_torch.kernels import spectrum as ts
from signalizer_tpu_torch.utils.diagnostics import counter

FS = 48_000.0
P = 64
CPU = torch.device("cpu")


def constants(k):
    kw = dict(axis_points=P, window_size=256, sample_rate=FS, num_line_graphs=k)
    return (
        jax_make(fft_backend="xla", configuration=JChannels.PHASE, view_scaling=JScaling.LOGARITHMIC, **kw),
        make_spectrum_constant(device=CPU, configuration=SpectrumChannels.PHASE,
                               view_scaling=ViewScaling.LOGARITHMIC, **kw),
    )


def inputs(rng, pairs, t, k):
    """(vals [pairs, T, 2, P]: mid magnitudes and cancellations in [0, 1];
    magnitude state [pairs, K, 2, P]; phase state [pairs, K, P])."""
    mid = np.abs(rng.standard_normal((pairs, t, P))) * 0.3
    cancel = rng.random((pairs, t, P))
    vals = np.stack([mid, cancel], axis=-2).astype(np.float32)
    mag0 = (rng.random((pairs, k, 2, P)) * 0.05).astype(np.float32)
    phase0 = (rng.random((pairs, k, P)) * 0.05).astype(np.float32)
    return vals, mag0, phase0


def undb(tc, results):
    """Display values back to linear units (clip_db -> 0)."""
    lower, dyr = (float(v) for v in tc.display_scalars[1:3])
    lin = np.exp(np.asarray(results, np.float64) / dyr) * lower
    return np.where(np.asarray(results) == float(tc.clip_db), 0.0, lin)


def both(jc, tc, vals, mag0, phase0, valid=None, state=None, jstate=None):
    """One call of the port's post_process (its PHASE tail is kernel G's
    plain version on the CPU) and of JAX's, from the given or fresh states."""
    state = state or ts.line_graph_state_from_arrays(mag0, phase0, CPU)
    jstate = jstate or JaxState(jnp.asarray(mag0), jnp.asarray(phase0))
    got = ts.post_process(tc, state, torch.from_numpy(vals), valid=valid)
    want = jax_post_process(jc, jstate, jnp.asarray(vals), valid=None if valid is None else jnp.asarray(valid))
    return got, want


def assert_close(tc, got, want):
    res, ref = got.results.numpy(), np.asarray(want.results)
    assert res.shape == ref.shape
    np.testing.assert_allclose(res[..., 0, :], ref[..., 0, :], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(undb(tc, res[..., 1, :]), undb(tc, ref[..., 1, :]), atol=2e-3)
    np.testing.assert_allclose(got.state.magnitude.numpy(), np.asarray(want.state.magnitude), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.state.phase.numpy(), np.asarray(want.state.phase), atol=2e-3)


def float32_loop(tc, vals, mag0, phase0, valid=None):
    """The PHASE recurrence frame by frame in numpy float32, each operation
    rounded on its own: (magnitude row 0 [pairs, K, P], phase [pairs, K, P])."""
    f = np.float32
    poles = tc.decay_poles.numpy()[None, :, None]
    pp = pd.phase_poles(tc).numpy()[None]  # the same torch pow both versions share
    s, ph = mag0[:, :, 0].copy(), phase0.copy()
    for t in range(vals.shape[1]):
        if valid is not None and not valid[t]:
            continue
        m = vals[:, t, 0][:, None] * f(0.5)
        tgt = vals[:, t, 1][:, None] * m
        s = np.maximum(poles * s, m)
        ph = tgt + pp * (ph - tgt)
    return s, ph


@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "valid_mask"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("t", [1, 7, 33])
def test_phase_tail_matches_jax(t, k, masked):
    """2 pairs, T = 1, 7 and 33, K = 1 and 3, with and without a mask (a
    padded frame repeats the last display, and leaves both states)."""
    jc, tc = constants(k)
    rng = np.random.default_rng(1000 + 10 * t + k)
    vals, mag0, phase0 = inputs(rng, 2, t, k)
    valid = None
    if masked:
        valid = rng.random(t) > 0.3
        valid[-1] = False
    got, want = both(jc, tc, vals, mag0, phase0, valid)
    assert tuple(got.results.shape) == (2, t, k, 2, P)
    assert_close(tc, got, want)
    s, ph = float32_loop(tc, vals, mag0, phase0, valid)
    assert np.array_equal(got.state.magnitude.numpy()[:, :, 0], s)
    assert np.array_equal(got.state.phase.numpy(), ph)
    if masked and t > 1:
        assert torch.equal(got.results[:, -1], got.results[:, -2])


def test_three_carried_calls_match_jax():
    """Three calls of T = 5, 1 and 9 (the middle one padded), each from the
    states the last one left, against JAX carrying its own."""
    jc, tc = constants(2)
    rng = np.random.default_rng(77)
    _, mag0, phase0 = inputs(rng, 2, 1, 2)
    state = ts.line_graph_state_from_arrays(mag0, phase0, CPU)
    jstate = JaxState(jnp.asarray(mag0), jnp.asarray(phase0))
    for t, valid in ((5, None), (1, np.array([False])), (9, np.arange(9) % 3 != 1)):
        vals = inputs(rng, 2, t, 2)[0]
        got, want = both(jc, tc, vals, None, None, valid, state, jstate)
        assert got.state is state
        assert_close(tc, got, want)
        jstate = want.state


def test_zero_and_subnormal_values():
    """Silent pixels (exact zeros: clip_db in both packages, the states
    zero) and subnormal values. XLA's CPU flushes subnormals to zero and
    torch keeps them, so against JAX the rows compare in linear units (a
    subnormal's dB is far below the floor, a flushed zero's the clip), and
    the states, kept with every subnormal, equal the float32 loop."""
    jc, tc = constants(2)
    rng = np.random.default_rng(5)
    vals, mag0, phase0 = inputs(rng, 2, 12, 2)
    tiny = np.float32(1e-40)
    vals[0, :, 0, :16] = 0.0  # silent mid
    vals[0, :, 0, 16:32] = tiny * rng.random((12, 16)).astype(np.float32)  # subnormal mid
    vals[0, :, 1, 32:48] = tiny  # subnormal cancellation
    vals[1, :, :, :8] = 0.0
    mag0[0, :, 0, :32] = 0.0
    phase0[0, :, :32] = 0.0
    mag0[1, :, 0, 8:16] = tiny
    phase0[1, :, 8:16] = tiny
    got, want = both(jc, tc, vals, mag0, phase0)
    res, ref = got.results.numpy(), np.asarray(want.results)
    clip = float(tc.clip_db)
    assert (res[0, :, :, :, :16] == clip).all() and (ref[0, :, :, :, :16] == clip).all()
    np.testing.assert_allclose(undb(tc, res), undb(tc, ref), rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(got.state.magnitude.numpy(), np.asarray(want.state.magnitude), rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(got.state.phase.numpy(), np.asarray(want.state.phase), atol=2e-3)
    s, ph = float32_loop(tc, vals, mag0, phase0)
    assert np.array_equal(got.state.magnitude.numpy()[:, :, 0], s)
    assert np.array_equal(got.state.phase.numpy(), ph)
    sub = got.state.magnitude.numpy()[0, :, 0, 16:32]
    assert ((sub > 0) & (sub < np.finfo(np.float32).tiny)).any()  # kept, not flushed


def test_magnitude_row_one_untouched():
    """Only row 0 of the magnitude state is read and written, as the JAX
    package's ``.at[..., 0:1, :].set``: row 1 is what it was, bit for bit
    (here values no decay would leave: negative and NaN)."""
    jc, tc = constants(3)
    rng = np.random.default_rng(11)
    vals, mag0, phase0 = inputs(rng, 2, 7, 3)
    mag0[:, :, 1] = -rng.random((2, 3, P)).astype(np.float32)
    mag0[0, 1, 1, 5] = np.nan
    got, want = both(jc, tc, vals, mag0, phase0, np.arange(7) != 3)
    row1 = got.state.magnitude.numpy()[:, :, 1]
    assert np.array_equal(row1, mag0[:, :, 1], equal_nan=True)
    assert np.array_equal(np.asarray(want.state.magnitude)[:, :, 1], mag0[:, :, 1], equal_nan=True)
    assert not np.array_equal(got.state.magnitude.numpy()[:, :, 0], mag0[:, :, 0])


def test_wrapper_on_the_cpu_is_the_plain_version():
    """On CPU tensors the wrapper is its plain version (bit for bit, the same
    in-place updates) and launches nothing."""
    _, tc = constants(2)
    rng = np.random.default_rng(3)
    vals, mag0, phase0 = inputs(rng, 3, 6, 2)
    valid = [True, True, False, True, False, True]
    a = ts.line_graph_state_from_arrays(mag0, phase0, CPU)
    b = ts.line_graph_state_from_arrays(mag0, phase0, CPU)
    got = pd.phase_decay_db(tc, a, torch.from_numpy(vals), valid)
    want = pd.phase_decay_db_plain(tc, b, torch.from_numpy(vals), valid)
    assert torch.equal(got, want) and torch.equal(a.magnitude, b.magnitude) and torch.equal(a.phase, b.phase)
    assert counter("phase_decay_db.launches") == 0


def test_post_process_dispatches_phase_to_kernel_g(monkeypatch):
    """Off the CPU, post_process in PHASE goes to kernel G's wrapper with the
    state it updates in place, never to the plain loops (checked on the
    meta device, which needs no GPU, with the wrapper replaced by a
    recorder); the wrapper itself refuses a device that is not CUDA."""
    _, tc = constants(2)
    vals = torch.empty((1, 3, 2, P), device="meta")
    state = ts.LineGraphState(torch.empty((1, 2, 2, P), device="meta"), torch.empty((1, 2, P), device="meta"))
    out = torch.empty((1, 3, 2, 2, P), device="meta")
    calls = []

    def stand_in(constant, st, v, valid=None):
        calls.append((st is state, v.device.type, valid))
        return out

    monkeypatch.setattr(ts, "phase_decay_db", stand_in)
    monkeypatch.setattr(pd, "phase_decay_db_plain", lambda *a, **k: pytest.fail("the plain tail ran"))
    got = ts.post_process(tc, state, vals, valid=[True, False, True])
    assert got.results is out and got.state is state and calls == [(True, "meta", [True, False, True])]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="phase_decay_db"):
        pd.phase_decay_db(tc, state, vals)
    assert counter("phase_decay_db.launches") == 0


@pytest.mark.parametrize("sms", [2, 132])
@pytest.mark.parametrize("t", [1, 5, 8, 33, 100, 512])
def test_phase_plan_maps_every_frame_once(t, sms):
    """Kernel G's plan (``phase_plan``), modelled as the kernel lays it
    out: T in chunks of ``frames`` frames, the mapping pass's block of
    chunk c walking frames [c frames, min(T, (c + 1) frames)) and the walk
    pass's blocks frames [0, (chunks - 1) frames) in stages of WALK_FRAMES,
    writing chunk c's start after stage (c frames / WALK_FRAMES) - 1. Every
    frame is mapped by one chunk, every chunk's start is written once (chunk
    0's from the state), and T is split only into whole walk stages, until
    the grid gives two blocks an SM or the chunks would be shorter than a
    stage."""
    for pairs, k, p in ((1, 2, 1024), (16, 2, 1024), (2, 11, 200)):
        frames, chunks = pd.phase_plan(pairs, t, k, p, sms)
        assert chunks == (1 if frames >= t else -(-t // frames))
        mapped = np.zeros(t, int)
        for c in range(chunks):
            mapped[c * frames : min(t, (c + 1) * frames)] += 1
        assert (mapped == 1).all(), (frames, chunks)
        if chunks == 1:
            assert frames == t
            continue
        assert frames % pd.WALK_FRAMES == 0
        written = [0]
        for st in range((chunks - 1) * frames // pd.WALK_FRAMES):
            if (st + 1) * pd.WALK_FRAMES % frames == 0:
                written.append((st + 1) * pd.WALK_FRAMES // frames)
        assert written == list(range(chunks))
        blocks = -(-p // pd.TILE) * -(-k // pd.GROUP) * pairs
        assert blocks * (chunks // 2) < 2 * sms  # split no further than the card needs
