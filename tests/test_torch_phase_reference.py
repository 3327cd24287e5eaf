"""The port's PHASE Spectrum against the benchmark's plain float64 reference
(``portbench.reference.phase``, written from the source's description and
independent of the port) on the CPU, the reference's PHASE design against
the port's PHASE constant, and the ``phase.values`` span.

The JAX package is the port's reference in ``test_torch_spectrum.py``; here
the benchmark's reference is held to the port, so that the card's check of
the PHASE cell rests on a reference that agrees with the program wherever
float32 allows."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.reference.phase import PhaseReference, first_max_bin, half_spectra, modulus, phase_design
from portbench.reference.spectrum import Tables, db_map
from portbench.spectrum_views import constant_kwargs
from signalizer_tpu_torch import SpectrumProcessor
from signalizer_tpu_torch.core.constant import make_spectrum_constant
from signalizer_tpu_torch.kernels.phase_decay_db import phase_poles
from signalizer_tpu_torch.utils import diagnostics as diag

W, HOP, T, PAIRS = 1024, 256, 16, 2


def _view(interpolation):
    return dict(window_size=W, sample_rate=48000.0, axis_points=256, channels="PHASE",
                interpolation=interpolation, axis="LOGARITHMIC", line_graphs=2)


def _stream(seed: int, calls: int) -> torch.Tensor:
    """[PAIRS, 2, n] float32: pair 0 a sine with the right channel 0.3 rad
    behind and independent noise 40 dB under it; pair 1 a sine in noise,
    the same on both channels (mono: the cancellation is exactly 0)."""
    n = (calls * T - 1) * HOP + W
    g = torch.Generator().manual_seed(seed)
    i = torch.arange(n, dtype=torch.float64)
    x = torch.empty(PAIRS, 2, n, dtype=torch.float64)
    x[0, 0] = 0.5 * torch.sin(2 * math.pi * 1234.5 / 48000.0 * i)
    x[0, 1] = 0.5 * torch.sin(2 * math.pi * 1234.5 / 48000.0 * i - 0.3)
    x[0] += 0.0035 * torch.randn(2, n, generator=g, dtype=torch.float64)
    x[1, 0] = 0.3 * torch.sin(2 * math.pi * 6000.0 / 48000.0 * i) + 0.01 * torch.randn(n, generator=g, dtype=torch.float64)
    x[1, 1] = x[1, 0]
    return x.float()


def _frames(stream, k):
    off = k * T * HOP
    return stream[..., off:off + (T - 1) * HOP + W].unfold(-1, W, HOP).movedim(-2, -3).contiguous()


def _argbins_agree(port, ref: PhaseReference, frames) -> bool:
    """Whether the port's first-maximum bins (float32) are the reference's
    (float64) at every bin-max pixel of ``frames``: where they are, no
    argbin flipped on float32's rounding."""
    from signalizer_tpu_torch.kernels.spectrum import _binmax_argbin, window_fft_mag

    mags = window_fft_mag(port.constant, frames).abs()
    got = _binmax_argbin(torch.maximum(mags[..., 0, :], mags[..., 1, :]), port.constant)
    want = first_max_bin(ref.tables, modulus(*half_spectra(ref.tables, frames.double())).amax(-2))
    live = ~port.constant.interp_mask
    return torch.equal(got[..., live], want[..., live])


@pytest.mark.parametrize("interpolation", ["LINEAR", "LANCZOS"])
def test_the_ports_phase_spectrum_equals_the_float64_reference(interpolation):
    """Two calls of 16 frames, the states carried. Tolerance 1e-4 display
    units (0.0096 dB; the display's 96 dB are 1): float32's rounding of the
    FFT and the cancellation reads ~1e-5 here. The phase row of the first
    frame is left out: from a zero state it is one frame's cancellation
    ``1 - |L + R| / (|L| + |R|)``, whose float32 rounding (~6e-8 absolute)
    can be the whole value where the channels agree in phase, and its
    logarithm then any number. No argbin flips on these frames (checked: the
    port's first-maximum bins are the reference's)."""
    view = _view(interpolation)
    port = SpectrumProcessor.create(pairs=PAIRS, device="cpu", **constant_kwargs(view))
    ref = PhaseReference(phase_design(view), PAIRS, torch.float64, "cpu")
    stream = _stream(7, 2)
    for k in range(2):
        frames = _frames(stream, k)
        assert _argbins_agree(port, ref, frames)
        got, want = port.process(frames).double(), ref.process(frames)
        if k == 0:
            got[:, 0, :, 1], want[:, 0, :, 1] = 0.0, 0.0
        assert (got - want).abs().max() < 1e-4
        assert torch.equal(got[1, :, :, 1], want[1, :, :, 1])  # mono: both clip the phase row
    t = ref.tables
    mag = db_map(t, port.state.magnitude.double()) - db_map(t, ref.state)
    phase = db_map(t, port.state.phase.double()) - db_map(t, ref.phase)
    assert mag.abs().max() < 1e-4 and phase.abs().max() < 1e-4
    assert torch.all(port.state.magnitude[:, :, 1] == 0)  # row 1 of the magnitude state is never written


@pytest.mark.parametrize("interpolation", ["LINEAR", "LANCZOS", "NONE"])
@pytest.mark.parametrize("axis", ["LOGARITHMIC", "LINEAR"])
def test_the_references_phase_design_equals_the_ports_phase_constant(interpolation, axis):
    """Taps, weights, masks, chunks, window, slope and poles; the float64
    design against the port's float32 tables at float32's rounding (rtol
    1e-7 on the weights, the slope, the window and the poles; indices and
    masks exactly)."""
    view = dict(_view(interpolation), axis=axis)
    d = phase_design(view)
    c = make_spectrum_constant(device="cpu", **constant_kwargs(view))
    p = d.plan
    assert d.mode == "PHASE" and d.rows == 2 == c.state_channels
    np.testing.assert_array_equal(p.interp_indices, c.interp_indices.numpy())
    np.testing.assert_allclose(p.interp_weights, c.interp_weights.numpy(), rtol=1e-7, atol=1e-7)
    np.testing.assert_array_equal(p.interp_mask, c.interp_mask.numpy())
    np.testing.assert_array_equal(p.single_bin, c.single_bin.numpy())
    np.testing.assert_array_equal(p.single_mask, c.single_mask.numpy())
    np.testing.assert_array_equal(p.band_len, c.chunk_len.numpy())
    np.testing.assert_array_equal(p.band_lo[p.band_len > 0], c.chunk_lo.numpy()[p.band_len > 0])
    t = Tables(d, torch.float64, "cpu")
    live = t.band_mask.numpy()
    np.testing.assert_array_equal(t.band_idx.numpy()[live], c.band_idx.numpy()[:, : live.shape[1]][live])
    np.testing.assert_allclose(d.window, c.window_kernel.numpy(), rtol=1e-7)
    np.testing.assert_allclose(d.slope, c.slope_map.numpy(), rtol=1e-7)
    np.testing.assert_allclose(d.poles, c.decay_poles.numpy(), rtol=1e-7)
    np.testing.assert_allclose(PhaseReference(d, 1, torch.float64, "cpu").phase_poles.numpy(),
                               phase_poles(c).numpy(), rtol=1e-6)
    assert d.inv_size == pytest.approx(float(c.inv_size), rel=1e-7)
    assert d.transform_size == c.transform_size and p.n_values == c.n_spectrum_values


def _phase_call_spans():
    p = SpectrumProcessor.create(pairs=1, device="cpu", **constant_kwargs(dict(_view("LINEAR"), axis_points=64,
                                                                                window_size=256)))
    frames = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 3, 2, 256)).astype(np.float32))
    diag.reset_spans()
    return p, frames


def test_phase_values_is_a_span_under_the_processor_while_a_profiler_runs():
    p, frames = _phase_call_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        p.process(frames)
    records = diag.spans()
    assert [s.name for s in records] == ["spectrum.process", "ring.frames", "kernel.window_fft_mag",
                                         "phase.values", "kernel.phase_decay_db"]
    assert [s.parent for s in records] == [-1, 0, 0, 0, 0]


def test_phase_values_records_nothing_without_a_profiler():
    p, frames = _phase_call_spans()
    p.process(frames)
    assert diag.spans() == []
