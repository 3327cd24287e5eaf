"""Kernel H's plain version (the resonator bank's chunk recurrence and its
readouts) against the JAX package's ``resonate_chunks`` and
``resonator_readout_complex``, on the CPU: 2 pairs, 64 px, V = 3 (a Hann
window). Inputs are made with numpy from a seed and handed to both, with
the same precomputed block plan. The drives come from the JAX plan's own
einsum on one side and a float32 matrix product on the other, summed in
another order, so states and readouts are compared at 2e-6 of their peak,
as tests/test_torch_resonator.py compares them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.core.windows import WindowType as JWindow
from signalizer_tpu.kernels import resonator as jr
from signalizer_tpu_torch.core.windows import WindowType as TWindow
from signalizer_tpu_torch.kernels import resonator as tr
from signalizer_tpu_torch.kernels import resonator_scan as rs
from signalizer_tpu_torch.utils.diagnostics import counter

FS = 48_000.0
P = 64
W = 128


def banks(window="HANN"):
    freqs = np.geomspace(40.0, 18000.0, P)
    return (
        jr.make_resonator_constant(freqs, FS, 512, window_type=JWindow[window]),
        tr.make_resonator_constant(freqs, FS, 512, device="cpu", window_type=TWindow[window]),
    )


def close(got, want, tol=2e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * float(np.abs(want).max()))


def inputs(rng, t):
    chunks = (rng.standard_normal((2, 2, t, W)) * 0.5).astype(np.float32)  # [pairs, rows, T, W]
    s0 = (rng.standard_normal((2, 2, P, 3, 2)) * 2.0).astype(np.float32)
    return chunks, s0


@pytest.mark.parametrize("emit", [False, True], ids=["state", "readouts"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "valid_mask"])
def test_scan_and_readouts_match_jax(masked, emit):
    """T = 9 chunks from a carried state, with and without padded chunks (the
    last one among them), with and without a readout after every chunk;
    the final state's complex readout and magnitude too."""
    jc, tc = banks()
    assert tc.vectors == 3
    rng = np.random.default_rng(40 + 2 * masked + emit)
    chunks, s0 = inputs(rng, 9)
    valid = np.array([True, False, True, True, True, False, True, True, False]) if masked else None
    got = tr.resonate_and_read(tc, torch.from_numpy(s0), torch.from_numpy(chunks), valid=valid,
                               plan=tr.make_block_plan(tc, W), emit_readouts=emit)
    want = jr.resonate_chunks(jc, jnp.asarray(s0), jnp.asarray(chunks),
                              valid=None if valid is None else jnp.asarray(valid),
                              plan=jr.make_block_plan(jc, W), emit_readouts=emit)
    want_state = want[0] if emit else want
    close(got.state, want_state)
    re, im = jr.resonator_readout_complex(jc, want_state)
    close(got.re, re)
    close(got.im, im)
    close(got.magnitude, jr.resonator_readout(jc, want_state))
    if emit:
        assert tuple(got.readouts.shape) == (9, 2, 2, P)
        close(got.readouts, want[1])
        if masked:  # a padded chunk reads the bank as it stands
            assert torch.equal(got.readouts[1], got.readouts[0])
            assert torch.equal(got.readouts[-1], got.readouts[-2])
    else:
        assert got.readouts is None


def test_plain_scan_is_the_chunk_loop():
    """The plain scan is the per-chunk loop bit for bit: its state after
    each chunk is ``z * c^W + drive`` applied chunk after chunk on the same
    drives, and its readouts are the readout functions'."""
    _, tc = banks()
    rng = np.random.default_rng(9)
    chunks, s0 = inputs(rng, 5)
    plan = tr.make_block_plan(tc, W)
    drives = tr._drive(plan.drive_matrix, torch.from_numpy(chunks), P, 3)
    decay_re, decay_im = plan.decay[..., 0], plan.decay[..., 1]
    got = rs.resonator_scan_plain(torch.from_numpy(s0), drives, decay_re, decay_im, tc.combine, tc.gain,
                                  emit_readouts=True)
    state = torch.from_numpy(s0)
    for i in range(5):
        state = rs._advance(state, drives[..., i, :, :, :], decay_re, decay_im)
        assert torch.equal(got.readouts[i], tr.resonator_readout(tc, state))
    assert torch.equal(got.state, state)
    re, im = tr.resonator_readout_complex(tc, state)
    assert torch.equal(got.re, re) and torch.equal(got.im, im)
    assert torch.equal(got.magnitude, tr.resonator_readout(tc, state))


@pytest.mark.parametrize("window", ["RECTANGULAR", "BLACKMAN", "FLAT_TOP"])
def test_other_vector_counts_match_jax(window):
    """V = 1, 5 and 9 (a rectangular, a Blackman and a flat-top window, the
    counts kernel H is built for), with a mask and readouts."""
    jc, tc = banks(window)
    assert tc.vectors in rs.VECTORS and tc.vectors == jc.vectors
    rng = np.random.default_rng(len(window))
    chunks = (rng.standard_normal((2, 1, 4, W)) * 0.5).astype(np.float32)
    s0 = np.zeros((2, 1, P, tc.vectors, 2), np.float32)
    valid = np.array([True, True, False, True])
    got = tr.resonate_and_read(tc, torch.from_numpy(s0), torch.from_numpy(chunks), valid=valid,
                               plan=tr.make_block_plan(tc, W), emit_readouts=True)
    want_state, want_ys = jr.resonate_chunks(jc, jnp.asarray(s0), jnp.asarray(chunks), valid=jnp.asarray(valid),
                                             plan=jr.make_block_plan(jc, W), emit_readouts=True)
    close(got.state, want_state)
    close(got.readouts, want_ys)
    close(got.magnitude, jr.resonator_readout(jc, want_state))


def test_a_mask_of_the_wrong_length_raises():
    _, tc = banks()
    chunks, s0 = inputs(np.random.default_rng(1), 3)
    with pytest.raises(ValueError, match="valid has 2 entries for T=3"):
        tr.resonate_and_read(tc, torch.from_numpy(s0), torch.from_numpy(chunks), valid=[True, False])


def test_resonate_chunks_dispatches_to_kernel_h(monkeypatch):
    """Off the CPU the recurrence goes to kernel H's wrapper once, with the
    plan's c^W views and the bank's combine and gain, never to the plain
    loop (checked on the meta device, which needs no GPU, with the wrapper
    replaced by a recorder); the wrapper itself refuses a device that is
    not CUDA."""
    _, tc = banks()
    meta = tr.ResonatorConstant(
        num_pixels=P, vectors=3, poles=tc.poles.to("meta"), combine=tc.combine.to("meta"),
        gain=tc.gain.to("meta"), host_poles=tc.host_poles,
    )
    plan = tr.ResonatorBlockPlan(block=W, drive_matrix=torch.empty((P * 6, W), device="meta"),
                                 decay=torch.empty((P, 3, 2), device="meta"))
    state = torch.empty((2, 2, P, 3, 2), device="meta")
    calls = []

    def stand_in(st, drives, decay_re, decay_im, combine, gain, valid=None, emit_readouts=False):
        calls.append((st is state, tuple(drives.shape), decay_re.stride(), combine is meta.combine,
                      gain is meta.gain, valid, emit_readouts))
        return rs.ScanResult(st, None, None, None, "readouts")

    monkeypatch.setattr(tr, "resonator_scan", stand_in)
    monkeypatch.setattr(rs, "resonator_scan_plain", lambda *a, **k: pytest.fail("the plain loop ran"))
    chunks = torch.empty((2, 2, 5, W), device="meta")
    got = tr.resonate_chunks(meta, state, chunks, valid=[True] * 5, plan=plan, emit_readouts=True)
    assert got == (state, "readouts")
    assert calls == [(True, (2, 2, 5, P, 3, 2), (6, 2), True, True, [True] * 5, True)]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="resonator_scan"):
        rs.resonator_scan(state, torch.empty((2, 2, 5, P, 3, 2), device="meta"), plan.decay[..., 0],
                          plan.decay[..., 1], meta.combine, meta.gain)
    assert counter("resonator_scan.launches") == 0
