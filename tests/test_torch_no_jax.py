"""The port imports and runs with jax blocked, refuses a missing GPU, and
builds nothing when its kernel modules are imported."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
# the JAX package's jax-free modules the port may load: core.config (enums),
# core.windows, core.scaling, params.transformatters (TimeMode) and
# utils.colour (pair_key_table), with what those two import
ALLOWED = {
    "signalizer_tpu",
    "signalizer_tpu.core",
    "signalizer_tpu.core.config",
    "signalizer_tpu.core.windows",
    "signalizer_tpu.core.scaling",
    "signalizer_tpu.params",
    "signalizer_tpu.params.parameters",
    "signalizer_tpu.params.transformatters",
    "signalizer_tpu.params.values",
    "signalizer_tpu.utils",
    "signalizer_tpu.utils.colour",
    "signalizer_tpu.utils.diagnostics",
}


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )


def test_port_runs_with_jax_blocked():
    """With ``sys.modules['jax'] = None`` any jax import raises; the port
    still imports and a small SpectrumProcessor runs on the CPU. Only
    jax-free modules of the JAX package get loaded."""
    proc = _run(
        """
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import signalizer_tpu_torch as st
        proc = st.SpectrumProcessor.create(
            pairs=2, device="cpu", axis_points=64, window_size=256,
            configuration=st.SpectrumChannels.SEPARATE,
            view_scaling=st.ViewScaling.LOGARITHMIC)
        out = proc.process(np.random.default_rng(0).standard_normal((2, 3, 2, 256)).astype(np.float32))
        assert tuple(out.shape) == (2, 3, 2, 2, 64), out.shape
        loaded = sorted(m for m in sys.modules if m.startswith("signalizer_tpu.") or m == "signalizer_tpu")
        print(" ".join(loaded))
        """
    )
    assert proc.returncode == 0, proc.stderr
    loaded = set(proc.stdout.split())
    assert loaded <= ALLOWED, loaded


def test_oscilloscope_runs_with_jax_blocked():
    """With jax blocked a CPU OscilloscopeProcessor (ZERO_CROSSING trigger,
    colour track) runs, finds each sine's trigger, and loads no JAX-package
    module beyond the jax-free set."""
    proc = _run(
        """
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import signalizer_tpu_torch as st
        p = st.OscilloscopeProcessor.create(
            pairs=2, device="cpu", sample_rate=48000.0, pixels=128,
            channel_mode=st.OscChannels.SEPARATE, trigger_mode=st.TriggerMode.ZERO_CROSSING,
            trigger_threshold=0.1, autogain=st.AutoGain.PEAK_DECAY, colour_enabled=True)
        x = np.sin(2 * np.pi * 440.0 * np.arange(4096) / 48000.0).astype(np.float32)
        f = p.process(np.broadcast_to(x, (2, 2, 4096)).copy())
        assert tuple(f.waveform.shape) == (2, 2, 128) and bool(f.trigger_found.all())
        assert tuple(f.colours.shape) == (2, 2, 128, 3)
        loaded = sorted(m for m in sys.modules if m.startswith("signalizer_tpu.") or m == "signalizer_tpu")
        print(" ".join(loaded))
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert set(proc.stdout.split()) <= ALLOWED, proc.stdout


def test_kernel_modules_import_without_nvcc_or_triton():
    """Importing the kernel wrappers runs no subprocess, looks for no
    compiler, loads no library and imports no triton: the build happens at
    the first launch on a CUDA tensor."""
    proc = _run(
        """
        import ctypes, shutil, subprocess, sys
        import numpy, numpy.testing, scipy.special, torch  # third-party set-up first
        calls = []
        def trap(name):
            def f(*a, **k):
                calls.append(name)
                raise AssertionError(name)
            return f
        subprocess.run = trap("subprocess.run")
        subprocess.Popen = trap("subprocess.Popen")
        shutil.which = trap("shutil.which")
        ctypes.CDLL = trap("ctypes.CDLL")
        import signalizer_tpu_torch.kernels.window_fft_mag as a
        import signalizer_tpu_torch.kernels.display_map as b
        import signalizer_tpu_torch.kernels.banded_resample as c
        import signalizer_tpu_torch.kernels.spectrum
        import signalizer_tpu_torch.kernels.oscilloscope
        import signalizer_tpu_torch.views.oscilloscope
        from signalizer_tpu_torch.kernels import _build
        assert calls == [], calls
        assert "triton" not in sys.modules
        assert _build.library.cache_info().currsize == 0
        assert (a.launches, b.launches, c.launches) == (0, 0, 0)
        print("ok")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: without a CUDA toolkit the build raises and names nvcc."""
    from signalizer_tpu_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_build_names_the_library_by_its_sources():
    """The library's file name is a hash of every csrc file and the flags,
    so an edited kernel never loads a stale build."""
    from signalizer_tpu_torch.kernels import _build

    names = {p.name for p in _build._sources()}
    assert {"window_fft_mag.cu", "display_map.cu", "banded_resample.cu"} <= names
    assert _build._digest() == _build._digest()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert set(_build.SIGNATURES) == {"sig_window_fft_mag", "sig_display_map", "sig_banded_resample"}


def test_cuda_processor_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU refusal is not reachable")
    from signalizer_tpu_torch import SpectrumProcessor

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        SpectrumProcessor.create(pairs=1, device="cuda", axis_points=32, window_size=128)
