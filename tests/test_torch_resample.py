"""Kernel C's plain version and the port's resample functions against the
JAX package on the CPU: the per-tap gathers (``_sinc_gather`` and the
linear and nearest gathers), the per-tap numpy oracle of
``tests/test_pallas_resample.py``, and the Pallas kernel itself in
interpret mode. Inputs are made with numpy from a seed and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.kernels import oscilloscope as jk
from signalizer_tpu.kernels.pallas_resample import fused_banded_resample
from signalizer_tpu_torch.kernels import banded_resample as br
from signalizer_tpu_torch.kernels import oscilloscope as tk

from test_pallas_resample import _mk, _oracle


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _positions(start, step, p):
    """start + k*step in f32, as eager JAX forms it (no FMA)."""
    return (np.float32(start) + np.arange(p, dtype=np.float32) * np.float32(step)).astype(np.float32)


@pytest.mark.parametrize("a", [10, 5, 1])
@pytest.mark.parametrize("step", [0.125, 0.8, 1.0, 16.0])
def test_lanczos_plain_matches_sinc_gather(step, a):
    """The plain Lanczos is JAX's ``_sinc_gather`` per tap: the same sinc
    products and clamped indices, summed over 2a taps in another order
    (atol 1e-6 on unit-variance rows). P = 160, positions off both edges."""
    rng = np.random.default_rng(int(step * 8) + a)
    x = rng.standard_normal((3, 2, 4096)).astype(np.float32)
    pos = np.stack([
        _positions(-(a + 0.7), step, 160),
        _positions(4095.0 - step * 80, step, 160),
        _positions(rng.uniform(0, 4095 - step * 160), step, 160),
    ])
    pos = np.clip(pos, -(a + 1.0), 4095.0 + a).astype(np.float32)
    got = br.banded_resample_plain(_t(x), _t(pos), a=a, kind="lanczos").numpy()
    want = np.asarray(jk._sinc_gather(jnp.asarray(x), jnp.asarray(pos)[:, None, :], a))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["linear", "nearest"])
@pytest.mark.parametrize("step", [0.125, 1.0, 16.0])
def test_linear_and_nearest_plain_match_jax_gathers(kind, step):
    """Linear is JAX's 2-tap gather formula (atol 1e-6), nearest its
    ``floor(pos + 0.5)`` pick (exact). The JAX functions run eagerly on the
    CPU, where they take the gathers; the positions are formed alike."""
    rng = np.random.default_rng(int(step * 8))
    x = rng.standard_normal((2, 2, 4096)).astype(np.float32)
    start = np.array([[-1.7], [4095.0 - 100 * step]], np.float32)
    lo, hi = (-2.0, 4096.0) if kind == "linear" else (-1.0, 4096.0)
    pos = np.clip(start + np.arange(256, dtype=np.float32) * np.float32(step), lo, hi).astype(np.float32)
    fn = jk.linear_resample if kind == "linear" else jk.nearest_resample
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(start), jnp.float32(step), 256))
    got = br.banded_resample_plain(_t(x), _t(pos), a=1, kind=kind).numpy()
    if kind == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind,a", [("lanczos", 10), ("lanczos", 5), ("linear", 1), ("nearest", 1)])
def test_plain_matches_the_per_tap_oracle(kind, a):
    """Against ``tests/test_pallas_resample.py``'s float64 per-tap oracle,
    interior and off both edges: atol 2e-4, that file's edge bound (f32
    sin(pi t) near integer t carries ~1e-6 absolute noise per tap)."""
    x, pos = _mk(step=0.55, seed=4)
    rng = np.random.default_rng(3)
    xe = rng.standard_normal((1, 2, 1024)).astype(np.float32)
    edge = np.stack([
        np.clip(_positions(-(a + 0.5), 0.4, 256), -(a + 1.0), 1023.0 + a),
        np.clip(_positions(1023.0 - 0.4 * 128, 0.4, 256), -(a + 1.0), 1023.0 + a),
    ]).astype(np.float32)
    for xx, pp in ((x, pos), (np.repeat(xe, 2, axis=0), edge)):
        got = br.banded_resample_plain(_t(xx), _t(pp), a=a, kind=kind).numpy()
        np.testing.assert_allclose(got, _oracle(xx, pp, a, kind), rtol=0, atol=2e-4)


@pytest.mark.parametrize("kind,a", [("lanczos", 10), ("lanczos", 5), ("linear", 1), ("nearest", 1)])
def test_plain_matches_the_pallas_kernel_in_interpret_mode(kind, a):
    """Against ``fused_banded_resample(..., interpret=True)`` at a small size
    (2 pairs, 2 rows, 2048 samples, 256 px), within the bound
    ``tests/test_pallas_resample.py:86`` holds that kernel to against the
    oracle: max(5e-4, 1.2 x the XLA banded path's oracle error)."""
    step = 0.63 if a <= 5 else 0.55
    x, pos = _mk(step=step)
    got = br.banded_resample_plain(_t(x), _t(pos), a=a, kind=kind).numpy()
    pallas = np.asarray(fused_banded_resample(jnp.asarray(x), jnp.asarray(pos), a=a, kind=kind, interpret=True))
    want = _oracle(x, pos, a, kind)
    xla = np.asarray(jk._banded_resample(jnp.asarray(x), jnp.asarray(pos)[:, None, :], a, 256, kind))
    tol = max(5e-4, 1.2 * float(np.max(np.abs(xla - want))))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol)
    if kind == "nearest":
        np.testing.assert_array_equal(got, pallas)


def test_with_nearest_matches_the_pallas_dual_output():
    """The dual output: the Lanczos wave as the single call gives it, and
    the nearest pick equal to the Pallas kernel's second output."""
    x, pos = _mk(step=0.55)
    wave, near = br.banded_resample_plain(_t(x), _t(pos), a=10, kind="lanczos", with_nearest=True)
    assert torch.equal(wave, br.banded_resample_plain(_t(x), _t(pos), a=10, kind="lanczos"))
    pw, pn = fused_banded_resample(
        jnp.asarray(x), jnp.asarray(pos), a=10, kind="lanczos", with_nearest=True, interpret=True
    )
    np.testing.assert_array_equal(near.numpy(), np.asarray(pn))
    np.testing.assert_allclose(wave.numpy(), np.asarray(pw), rtol=0, atol=5e-4)


def test_wrapper_takes_the_plain_path_for_cpu_tensors():
    x, pos = _mk(step=0.3)
    before = br.launches
    for kind in br.KINDS:
        got = br.banded_resample(_t(x), _t(pos), a=3, kind=kind, with_nearest=True)
        want = br.banded_resample_plain(_t(x), _t(pos), a=3, kind=kind, with_nearest=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert br.launches == before
    with pytest.raises(ValueError, match="unknown kind"):
        br.banded_resample(_t(x), _t(pos), a=3, kind="cubic")


def test_wrapper_refuses_a_device_it_has_no_kernel_for():
    """Neither CPU nor CUDA: the wrapper raises (checked on the meta
    device, which needs no GPU)."""
    x = torch.empty((1, 2, 64), device="meta")
    pos = torch.empty((1, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        br.banded_resample(x, pos, a=10, kind="lanczos")


def test_block_span_decides_the_kernels_two_forms():
    """cfg3 (8x upsample, 2 rows) and the colour track (6 rows at 1:1)
    stage their taps in shared memory; a 16384-sample window over 1024 px
    (step 16) and step 128 read them from global memory."""
    assert br.stages_in_shared_memory(2, 1023 / 8191, 10)
    assert br.stages_in_shared_memory(6, 1.0, 1)
    assert not br.stages_in_shared_memory(2, 16383 / 1023, 10)
    assert not br.stages_in_shared_memory(2, 128.0, 10)
    # the bound covers every 128-px block of evenly spaced positions
    for step in (0.125, 0.8, 1.0, 3.7, 16.0):
        pos = np.float32(12.3) + np.arange(1024, dtype=np.float32) * np.float32(step)
        i0 = np.floor(pos).reshape(-1, 128)
        spans = i0.max(1) - i0.min(1) + 2 * 10  # [min - a + 1, max + a]
        assert spans.max() <= br.block_span(step, 10)


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


@pytest.mark.parametrize("num_out", [256, 160])
def test_resample_functions_match_jax(num_out):
    """sinc_resample, sinc_resample_with_nearest, linear_resample and
    nearest_resample against the JAX functions under ``jit`` (the JAX
    processor's path, where XLA rounds ``start + p * step`` once as an
    FMA; the port rounds it once too), on the oscilloscope step's shapes
    [pairs, rows, H] with per-pair starts [pairs, 1]. Waves atol 1e-6,
    nearest picks exact."""
    rng = np.random.default_rng(num_out)
    x = (rng.standard_normal((3, 2, 4096)) * 0.5).astype(np.float32)
    start = np.array([[-3.3], [1000.37], [3900.21]], np.float32)
    step = np.float32(699.0) * np.float32(1.0 / (num_out - 1))
    xs, ss, st = jnp.asarray(x), jnp.asarray(start), jnp.full((3, 1), step, jnp.float32)
    tx, ts = _t(x), _t(start)
    wave = tk.sinc_resample(tx, ts, float(step), num_out, 10).numpy()
    jwave = np.asarray(_jit(jk.sinc_resample, 3, 4)(xs, ss, st, num_out, 10))
    np.testing.assert_allclose(wave, jwave, rtol=0, atol=1e-6)
    w2, near = tk.sinc_resample_with_nearest(tx, ts, float(step), num_out, 10)
    assert torch.equal(w2, torch.from_numpy(wave))
    lin = tk.linear_resample(tx, ts, float(step), num_out).numpy()
    np.testing.assert_allclose(lin, np.asarray(_jit(jk.linear_resample, 3)(xs, ss, st, num_out)), rtol=0, atol=1e-6)
    nr = tk.nearest_resample(tx, ts, float(step), num_out).numpy()
    np.testing.assert_array_equal(nr, np.asarray(_jit(jk.nearest_resample, 3)(xs, ss, st, num_out)))
    # the dual output's pick uses the Lanczos clip range, which only
    # differs from nearest_resample's off the frame's left edge
    np.testing.assert_array_equal(near.numpy()[1:], nr[1:])


def test_resample_functions_take_any_batch_shape():
    """Unshared positions (pos [..., P] varying along every batch axis)
    run as one kernel-C pair per row; scalar start and step broadcast."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 512)).astype(np.float32)
    start = np.array([[1.5, 7.25, 100.0], [3.0, 0.0, 50.5]], np.float32)
    got = tk.sinc_resample(_t(x), _t(start), 0.5, 128).numpy()
    want = np.asarray(jk.sinc_resample(jnp.asarray(x), jnp.asarray(start), jnp.float32(0.5), 128))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    one = tk.nearest_resample(_t(x[0, 0]), 10.0, 1.5, 64).numpy()
    np.testing.assert_array_equal(one, x[0, 0, np.floor(10.0 + np.arange(64) * 1.5 + 0.5).astype(int)])


@pytest.mark.parametrize("w", [1024, 1000])
def test_minmax_decimate_matches_jax(w):
    x = np.random.default_rng(w).standard_normal((2, 3, w)).astype(np.float32)
    lo, hi = tk.minmax_decimate(_t(x), 128)
    jlo, jhi = jk.minmax_decimate(jnp.asarray(x), 128)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_sinc_resample_matrix_and_static_match_jax():
    m = tk.sinc_resample_matrix(512, 3.25, 0.75, 200, device="cpu")
    jm = np.asarray(jk.sinc_resample_matrix(512, 3.25, 0.75, 200))
    np.testing.assert_array_equal(m.numpy(), jm)
    x = np.random.default_rng(1).standard_normal((2, 512)).astype(np.float32)
    got = tk.sinc_resample_static(_t(x), m).numpy()
    np.testing.assert_allclose(got, np.asarray(jk.sinc_resample_static(jnp.asarray(x), jnp.asarray(jm))), rtol=0, atol=1e-5)
