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
from signalizer_tpu_torch.utils.diagnostics import counter

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
    before = counter("banded_resample.launches")
    for kind in br.KINDS:
        got = br.banded_resample(_t(x), _t(pos), a=3, kind=kind, with_nearest=True)
        want = br.banded_resample_plain(_t(x), _t(pos), a=3, kind=kind, with_nearest=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert counter("banded_resample.launches") == before
    with pytest.raises(ValueError, match="unknown kind"):
        br.banded_resample(_t(x), _t(pos), a=3, kind="cubic")


def test_wrapper_refuses_a_device_it_has_no_kernel_for():
    """Neither CPU nor CUDA: the wrapper raises (checked on the meta
    device, which needs no GPU)."""
    x = torch.empty((1, 2, 64), device="meta")
    pos = torch.empty((1, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        br.banded_resample(x, pos, a=10, kind="lanczos")


def _affine_case(kind, a, where, w=4096, p=160):
    """x [3, 2, w], per-pair starts and steps whose positions lie inside the
    frame, hang off its left edge or run off its right edge, and the kind's
    clip range."""
    rng = np.random.default_rng(len(kind) + a + len(where))
    x = rng.standard_normal((3, 2, w)).astype(np.float32)
    lo, hi = {"lanczos": (-(a + 1.0), w - 1.0 + a), "linear": (-2.0, float(w)), "nearest": (-1.0, float(w))}[kind]
    steps = np.array([0.1249, 0.8, 3.7], np.float32)
    if where == "inside":
        start = rng.uniform(20.0, w - 20.0 - steps * p).astype(np.float32)
    elif where == "left":
        start = (lo - np.array([3.3, 0.5, 40.0])).astype(np.float32)
    else:
        start = (hi - steps * (p // 2) + 0.21).astype(np.float32)
    return x, start, steps, lo, hi


@pytest.mark.parametrize("where", ["inside", "left", "right"])
@pytest.mark.parametrize("step_form", ["host", "tensor"])
@pytest.mark.parametrize("kind,a", [("lanczos", 10), ("linear", 1), ("nearest", 1)])
def test_affine_entry_is_the_plain_version_at_the_positions_tensor(kind, a, step_form, where):
    """On the CPU ``banded_resample_affine`` is ``banded_resample_plain`` at
    ``affine_positions``' tensor, bit for bit: a host step for every pair
    or a step per pair, inside the frame and off both edges, and those
    positions are ``start + p * step`` rounded once and clipped."""
    x, start, steps, lo, hi = _affine_case(kind, a, where)
    step = float(steps[1]) if step_form == "host" else _t(steps)
    before = counter("banded_resample.launches")
    got = br.banded_resample_affine(_t(x), _t(start), step, 160, lo, hi, a=a, kind=kind, with_nearest=True)
    pos = br.affine_positions(_t(x), _t(start), step, 160, lo, hi)
    want = br.banded_resample_plain(_t(x), pos, a=a, kind=kind, with_nearest=True)
    assert counter("banded_resample.launches") == before
    assert pos.shape == (3, 160) and pos.dtype == torch.float32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    exact = start.astype(np.float64)[:, None] + np.arange(160.0) * (
        np.float64(steps[1]) if step_form == "host" else steps.astype(np.float64)[:, None]
    )
    np.testing.assert_array_equal(pos.numpy(), np.clip(exact.astype(np.float32), lo, hi).astype(np.float32))
    if where != "inside":
        assert bool((pos == (lo if where == "left" else hi)).any())  # the clip acts


def _fma_f32(p: int, step: np.float32, start: np.float32) -> np.float32:
    """``p * step + start`` rounded to f32 once, by exact rational
    arithmetic: what ``fmaf`` returns."""
    from fractions import Fraction

    exact = Fraction(p) * Fraction(float(step)) + Fraction(float(start))
    near = np.float32(float(exact))
    best = min(
        (near, np.nextafter(near, np.float32(-np.inf)), np.nextafter(near, np.float32(np.inf))),
        key=lambda c: abs(Fraction(float(c)) - exact),
    )
    return np.float32(best)


def test_affine_positions_are_the_fused_multiply_add_on_a_seeded_grid():
    """``affine_positions`` rounds a float64 sum to f32; the kernel's
    ``fmaf`` rounds the exact value. The two differ only in a
    double-rounding tie: none on this seeded grid (3 pairs x 1024 px at the
    8x upsample step), and never by more than one ulp."""
    rng = np.random.default_rng(7)
    start = rng.uniform(0.0, 15000.0, 3).astype(np.float32)
    step = np.float32(1023.0) * np.float32(1.0 / 8191)
    x = torch.zeros((3, 1, 8))
    pos = br.affine_positions(x, _t(start), float(step), 1024, -1e9, 1e9).numpy()
    want = np.array([[_fma_f32(p, step, s) for p in range(1024)] for s in start], np.float32)
    ulps = np.abs(pos.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= 1
    assert int((ulps > 0).sum()) == 0


def test_affine_wrapper_refuses_what_it_cannot_take():
    x, start, steps, lo, hi = _affine_case("lanczos", 10, "inside")
    with pytest.raises(ValueError, match="unknown kind"):
        br.banded_resample_affine(_t(x), _t(start), 0.5, 16, lo, hi, a=10, kind="cubic")
    meta = torch.empty((3, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        br.banded_resample_affine(meta, torch.empty((3,), device="meta"), 0.5, 16, lo, hi, a=10, kind="lanczos")
    # the checks a CUDA call makes, run here on CPU tensors
    br._check_x(_t(x), 10, "lanczos")
    br._check_rows(_t(x), _t(start), "start", 1)
    with pytest.raises(ValueError, match="outside"):
        br._check_x(_t(x), 17, "lanczos")
    with pytest.raises(TypeError, match="float32"):
        br._check_x(_t(x).double(), 10, "lanczos")
    with pytest.raises(ValueError, match="contiguous"):
        br._check_x(_t(x)[..., ::2], 10, "lanczos")
    with pytest.raises(ValueError, match=r"start must be \[B\]"):
        br._check_rows(_t(x), _t(start[:2]), "start", 1)
    with pytest.raises(ValueError, match=r"pos must be \[B, P\]"):
        br._check_rows(_t(x), _t(start), "pos", 2)
    with pytest.raises(TypeError, match="step must be float32"):
        br._check_rows(_t(x), _t(steps).double(), "step", 1)


@pytest.mark.parametrize(
    "fn,extra",
    [("sinc_resample", (10,)), ("sinc_resample_with_nearest", (10,)), ("linear_resample", ()), ("nearest_resample", ())],
)
def test_resample_functions_choose_the_entry_by_the_broadcast(monkeypatch, fn, extra):
    """Positions shared by x's last batch axis (start [pairs, 1], a host
    step or a step [pairs, 1]) take the affine entry with that axis as R;
    any other broadcast takes the ``pos`` entry with R = 1. Both give the
    plain version at the same positions."""
    calls = []

    def spy(name, real):
        def wrapped(x, *args, **kw):
            calls.append((name, tuple(x.shape)))
            return real(x, *args, **kw)
        return wrapped

    monkeypatch.setattr(tk, "banded_resample", spy("pos", br.banded_resample))
    monkeypatch.setattr(tk, "banded_resample_affine", spy("affine", br.banded_resample_affine))
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((2, 3, 256)).astype(np.float32))
    shared = _t(np.array([[1.5], [100.25]], np.float32))
    own = _t(np.array([[1.5, 1.5, 1.5], [100.25, 100.25, 100.25]], np.float32))
    f = getattr(tk, fn)
    first = lambda r: r[0] if isinstance(r, tuple) else r
    a_host = first(f(x, shared, 0.37, 64, *extra))
    a_tensor = first(f(x, shared, torch.full((2, 1), 0.37), 64, *extra))
    b = first(f(x, own, 0.37, 64, *extra))
    assert calls == [("affine", (2, 3, 256)), ("affine", (2, 3, 256)), ("pos", (6, 1, 256))]
    assert a_host.shape == b.shape == (2, 3, 64)
    assert torch.equal(a_host, b) and torch.equal(a_tensor, b)


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
