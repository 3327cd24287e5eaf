"""The frozen reference against the program's plain path on the CPU at a
small size, its FFT against numpy's, its plan against the program's, and
its imports."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import guard, harness
from portbench.reference import plan as rplan
from portbench.reference.spectrum import SpectrumReference, Tables, colour_columns, fft

VIEW = dict(window_size=1000, sample_rate=48000.0, axis_points=200, channels="SEPARATE",
            interpolation="LINEAR", axis="LOGARITHMIC")


def _port_kwargs(view):
    from portbench.spectrum_views import constant_kwargs

    return constant_kwargs(view)


@pytest.mark.parametrize("n", [32, 256, 4096])
def test_fft_matches_numpy(n):
    t = Tables(rplan.design(dict(VIEW, window_size=n)), torch.float64, "cpu")
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((3, n)))
    y = torch.from_numpy(np.random.default_rng(n + 1).standard_normal((3, n)))
    re, im = fft(t, x, y)
    want = np.fft.fft(x.numpy() + 1j * y.numpy())
    assert np.abs(re.numpy() + 1j * im.numpy() - want).max() < 1e-10 * np.sqrt(n)


@pytest.mark.parametrize("interp,axis", [("LINEAR", "LOGARITHMIC"), ("LANCZOS", "LINEAR"), ("NONE", "LOGARITHMIC")])
def test_plan_matches_the_programs_builders(interp, axis):
    from signalizer_tpu_torch.core.constant import make_spectrum_constant

    view = dict(VIEW, interpolation=interp, axis=axis)
    d = rplan.design(view)
    c = make_spectrum_constant(device="cpu", **_port_kwargs(view))
    p = d.plan
    np.testing.assert_array_equal(p.interp_indices, c.interp_indices.numpy())
    np.testing.assert_array_equal(p.interp_mask, c.interp_mask.numpy())
    np.testing.assert_array_equal(p.single_bin, c.single_bin.numpy())
    np.testing.assert_array_equal(p.single_mask, c.single_mask.numpy())
    np.testing.assert_array_equal(p.band_lo[p.band_len > 0], c.chunk_lo.numpy()[p.band_len > 0])
    np.testing.assert_array_equal(p.band_len, c.chunk_len.numpy())
    np.testing.assert_allclose(d.window, c.window_kernel.numpy(), rtol=1e-7)
    np.testing.assert_allclose(d.poles, c.decay_poles.numpy(), rtol=1e-7)
    assert d.inv_size == pytest.approx(float(c.inv_size), rel=1e-7)


@pytest.mark.parametrize("mode", ["SEPARATE", "LEFT", "MIDSIDE"])
def test_reference_equals_the_programs_plain_path(mode):
    from signalizer_tpu_torch import SpectrumProcessor

    view = dict(VIEW, channels=mode)
    p = SpectrumProcessor.create(pairs=2, device="cpu", **_port_kwargs(view))
    r = SpectrumReference(rplan.design(view), 2, torch.float64, "cpu")
    g = torch.Generator().manual_seed(3)
    for _ in range(3):  # the state carries across calls
        frames = torch.randn(2, 5, 2, 1000, generator=g) * 0.3
        assert (p.process(frames).double() - r.process(frames)).abs().max() < 1e-5
    rel = (p.state.magnitude.double() - r.state).abs().max() / r.state.abs().max()
    assert rel < 1e-5


def test_colours_equal_the_programs_plain_colour_map():
    from signalizer_tpu_torch.kernels.colormap import normalize_ratios, spectrogram_columns
    from signalizer_tpu_torch.views.spectrogram import DEFAULT_GRADIENT, DEFAULT_RATIOS

    g = torch.Generator().manual_seed(5)
    intensity = torch.rand(2, 40, 64, generator=g, dtype=torch.float64) * 1.4 - 0.2
    colours = torch.from_numpy(np.stack([DEFAULT_GRADIENT, DEFAULT_GRADIENT[::-1]]))
    ratios = torch.from_numpy(normalize_ratios(DEFAULT_RATIOS))
    got = colour_columns(intensity, colours.double(), ratios)
    want = spectrogram_columns(intensity, colours.double(), ratios)
    assert (got.int() - want.int()).abs().max() <= 1


def test_control_is_coarser_than_float32():
    view = dict(VIEW, channels="SEPARATE")
    frames = torch.randn(2, 4, 2, 1000, generator=torch.Generator().manual_seed(9)) * 0.3
    exact = SpectrumReference(rplan.design(view), 2, torch.float64, "cpu").process(frames)
    coarse = SpectrumReference(rplan.design(view), 2, torch.bfloat16, "cpu").process(frames)
    assert (coarse.double() - exact).abs().max() > 1e-3


def test_reference_imports_nothing_of_the_program():
    assert guard.reference_imports(harness.HERE / "reference") == []
    code = ("import sys, portbench.reference.spectrum, portbench.reference.plan; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'signalizer_tpu_torch', 'signalizer_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_import_checks_compare_whole_top_level_names(tmp_path):
    assert guard.loaded_banned(["signalizer_tpu_torch.kernels", "torch", "numpy.linalg"]) == []
    assert guard.loaded_banned(["signalizer_tpu.views", "jaxlib.xla_client"]) == ["jaxlib", "signalizer_tpu"]
    (tmp_path / "bad.py").write_text("import signalizer_tpu_torch.kernels\nfrom portbench.harness import Bench\n")
    (tmp_path / "good.py").write_text("import torch\nfrom portbench.reference.plan import design\nfrom . import plan\n")
    assert guard.reference_imports(tmp_path) == [("bad.py", "signalizer_tpu_torch.kernels"),
                                                 ("bad.py", "portbench.harness")]
