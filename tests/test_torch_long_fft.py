"""Kernel A on rows longer than one block's shared memory, on the CPU.

* The plain path at N = 65536 and 131072 against the JAX package's
  ``analyze_frames`` (XLA's FFT on the CPU) and its stage 1: display values
  to rtol/atol 1e-5, as tests/test_torch_spectrum.py holds the 4096-point
  step, and magnitudes to 1e-5 of each row's peak (two float32 FFTs of a
  row of 2^16-2^17 points).
* The two-pass form's arithmetic rehearsed in torch: the four-step
  decomposition of ``csrc/window_fft_mag_long.cu`` — the columns'
  transforms, the twiddles w_L^(n2 k1) read from the constant's
  ``fft_twiddles`` with their sign, the rows' transforms and the real
  split with partner rows in one block — in float32 with the kernel's
  indices, against ``torch.fft``. Bound: 5e-6 of each row's peak, the
  bound the kernel is held to on the card.
* Its second pass block by block as the kernel runs it: R consecutive rows
  of the scratch and their mirrors a block, the split in place, and the
  stores in the kernel's transposed order, for every channel mode through
  the port's packing and R = 8, 16 and 32: every bin stored once, in runs
  of at least R consecutive bins (32 bytes or more), and the sectors a
  warp's stores touch at most 1.5 times the bytes stored over 32 (the
  earlier pass 2 stored one 4-byte value a sector: 8 times).
* Kernel B's grouping of line graphs beyond one launch's eight, rehearsed
  with the plain decay: equal bit for bit to all line graphs at once.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.core.config import BinInterpolation, SpectrumChannels, ViewScaling
from signalizer_tpu.core.constant import make_spectrum_constant as jax_make
from signalizer_tpu.kernels.spectrum import LineGraphState as JaxState
from signalizer_tpu.kernels.spectrum import analyze_frames as jax_analyze
from signalizer_tpu.kernels.spectrum import _half_spectrum as jax_half_spectrum
from signalizer_tpu.kernels.spectrum import _pack_channels as jax_pack_channels
from signalizer_tpu_torch.core.constant import fft_twiddles, make_spectrum_constant
from signalizer_tpu_torch.kernels import display_map as dm
from signalizer_tpu_torch.kernels import window_fft_mag as wfm
from signalizer_tpu_torch.kernels.spectrum import analyze_frames, line_graph_state_from_arrays

FS = 48_000.0
CPU = torch.device("cpu")


def _pair(**kw):
    kw.setdefault("sample_rate", FS)
    return jax_make(fft_backend="xla", **kw), make_spectrum_constant(device=CPU, **kw)


@pytest.mark.parametrize("window", [48_000, 100_000], ids=["n65536", "n131072"])
@pytest.mark.parametrize("mode", [SpectrumChannels.SEPARATE, SpectrumChannels.MIDSIDE, SpectrumChannels.COMPLEX],
                         ids=lambda m: m.name)
def test_long_rows_match_jax_analyze_frames(mode, window):
    jc, tc = _pair(
        axis_points=256, window_size=window, configuration=mode,
        bin_interpolation=BinInterpolation.LINEAR, view_scaling=ViewScaling.LOGARITHMIC,
    )
    assert tc.transform_size == jc.transform_size == 1 << (window - 1).bit_length()
    assert wfm.form(tc) != "block"
    rng = np.random.default_rng(window + int(mode))
    frames = (rng.standard_normal((1, 2, 2, window)) * 0.3).astype(np.float32)
    mag0 = (rng.random((1, 2, tc.state_channels, 256)) * 0.05).astype(np.float32)
    phase0 = np.zeros((1, 2, 256), np.float32)
    state = line_graph_state_from_arrays(mag0, phase0, CPU)
    got = analyze_frames(tc, state, torch.from_numpy(frames)).results.numpy()
    want = jax_analyze(jc, JaxState(jnp.asarray(mag0), jnp.asarray(phase0)), jnp.asarray(frames),
                       decay_domain="linear")
    np.testing.assert_allclose(got, np.asarray(want.results), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.magnitude.numpy(), np.asarray(want.state.magnitude), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("window", [48_000, 65_536, 100_000, 131_072])
def test_long_rows_stage_one_matches_jax(window):
    """The plain kernel-A function's magnitudes against JAX's packing and
    half spectrum on the same frames, PHASE's complex cells included."""
    for mode in (SpectrumChannels.SEPARATE, SpectrumChannels.PHASE):
        jc, tc = _pair(axis_points=64, window_size=window, configuration=mode)
        frames = (np.random.default_rng(window).standard_normal((2, 2, window)) * 0.3).astype(np.float32)
        got = wfm.window_fft_mag_plain(tc, torch.from_numpy(frames)).numpy()
        want = np.asarray(jax_half_spectrum(jc, jax_pack_channels(jc, jnp.asarray(frames))))
        if mode != SpectrumChannels.PHASE:
            want = np.abs(want)
        err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
        assert err.max() <= 1e-5, err.max()


# --- the two-pass form's arithmetic --------------------------------------------


def _cmul(a, b):
    return torch.complex(a.real * b.real - a.imag * b.imag, a.real * b.imag + a.imag * b.real)


def _twiddles(n: int) -> torch.Tensor:
    t = torch.from_numpy(fft_twiddles(n))
    return torch.complex(t[:, 0], t[:, 1])


def pass_one(z: torch.Tensor, n: int):
    """The two-pass form's first pass on rows ``z`` [rows, L] complex64:
    the scratch Y[k1][n2] [rows, L1, L2] (column n2 holds z[L2 n1 + n2],
    transformed over n1 and twiddled by w_L^(n2 k1)), L1 and L2."""
    rows, length = z.shape
    log2l = length.bit_length() - 1
    l1 = 1 << (log2l >> 1)
    l2 = length // l1
    tw = _twiddles(n)
    cols = torch.fft.fft(z.reshape(rows, l1, l2), dim=1)  # [rows, k1, n2]
    k1 = torch.arange(l1)[:, None]
    n2 = torch.arange(l2)[None, :]
    j = (n2 * k1) & (length - 1)
    w = tw[length // 2 + (j & (length // 2 - 1))]
    w = torch.where(j & (length // 2) != 0, -w, w)
    return _cmul(cols, w), l1, l2


def four_step(z: torch.Tensor, n: int, real: bool) -> torch.Tensor:
    """The two-pass form on rows ``z`` [rows, L] complex64 (the packed z[m] =
    x[2m] + i x[2m+1] of a real row, or a COMPLEX row), with the kernel's
    indices: real rows give X[0..L] (halved DC and Nyquist), COMPLEX rows
    |Z|. The L1- and L2-point transforms are torch's; what is rehearsed is
    the kernel's own arithmetic around them."""
    rows, length = z.shape
    tw = _twiddles(n)
    y, l1, l2 = pass_one(z, n)  # the scratch: Y[k1][n2]
    # pass 2: rows k1 of Y transformed over n2: Z[k1 + l1 k2] = R[k1, k2]
    r = torch.fft.fft(y, dim=2)
    if not real:
        return r.transpose(1, 2).reshape(rows, length).abs()
    out = torch.full((rows, length + 1), complex(float("nan"), 0.0), dtype=torch.complex64)
    for jj in range(l1 // 2 + 1):
        pair = [jj] if jj in (0, l1 // 2) else [jj, l1 - jj]
        n_out = l2 // 2 + 1 if jj == 0 else (l2 if len(pair) == 2 else l2 // 2)
        k2 = torch.arange(n_out)
        k2m = (l2 - k2) & (l2 - 1) if jj == 0 else l2 - 1 - k2
        k = jj + l1 * k2
        km = length - k
        zk = r[:, pair[0], k2]
        zm = r[:, pair[-1], k2m]
        swap = k > length // 2
        k, km = torch.where(swap, km, k), torch.where(swap, k, km)
        zk, zm = torch.where(swap, zm, zk), torch.where(swap, zk, zm)
        wk = tw[length + k]
        er, ei = 0.5 * (zk.real + zm.real), 0.5 * (zk.imag - zm.imag)
        dr, di = 0.5 * (zk.real - zm.real), 0.5 * (zk.imag + zm.imag)
        p = wk.real * di + wk.imag * dr
        q = wk.real * dr - wk.imag * di
        scale = torch.where(k == 0, 0.5, 1.0)
        assert out[:, k].isnan().all() and out[:, km[km != k]].isnan().all()  # each bin once
        out[:, k] = torch.complex(er + p, ei - q) * scale
        out[:, km[km != k]] = (torch.complex(er - p, -ei - q) * scale)[:, km != k]
    assert not out.isnan().any()
    return out


@pytest.mark.parametrize("n", [2048, 4096, 65536])
def test_four_step_real_rows_match_rfft(n):
    """A zero-padded real row (W < N) and a silent row through the
    rehearsal: X[k] within 5e-6 of the row's peak, DC and Nyquist halved,
    the silent row exactly 0."""
    rng = np.random.default_rng(n)
    x = torch.zeros(2, n)
    x[0, : n - 37] = torch.from_numpy(rng.standard_normal(n - 37).astype(np.float32))
    z = torch.complex(x[:, 0::2], x[:, 1::2])
    got = four_step(z, n, real=True)
    want = torch.fft.rfft(x.double(), dim=-1)
    want[:, 0] *= 0.5
    want[:, -1] *= 0.5
    err = (got.cdouble() - want).abs().amax(-1)[0] / want.abs().amax(-1)[0]
    assert float(err) <= 5e-6
    assert bool((got[1] == 0).all())


@pytest.mark.parametrize("n", [1024, 8192, 32768])
def test_four_step_complex_rows_match_fft(n):
    rng = np.random.default_rng(n + 1)
    z = torch.from_numpy((rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64))
    got = four_step(z, n, real=False)
    want = torch.fft.fft(z.cdouble(), dim=-1).abs()
    assert float(((got.double() - want).abs().amax(-1) / want.amax(-1)).max()) <= 5e-6


def pass_two_blocks(y: torch.Tensor, l1: int, l2: int, n: int, r: int, mode: SpectrumChannels):
    """The second pass of ``csrc/window_fft_mag_long.cu`` block by block on
    the scratch ``y`` [rows, L1, L2], as the kernel runs it: block g holds
    the run of R rows from g R and their mirrors L1 - k1 (row L1/2 added to
    the last block's; COMPLEX holds the 2R rows from 2 g R), transforms
    them, splits in place (X[k] where Z[k] was, X[L] in row 0's padding)
    and stores its bins in the kernel's order: k2, then the held row.

    Returns ``(out, times, runs, sectors)``: the output rows (real modes
    [rows, L+1] f32 magnitudes, PHASE [rows, L+1] complex64, COMPLEX
    [rows, L] f32 |Z|), how often each bin was stored, the lengths of the
    runs of consecutive bins in each block's store order, and the 32-byte
    sectors the stores of 32 consecutive threads touch, summed over warps
    and rows (with each row's own offset in the output)."""
    rows = y.shape[0]
    length = l1 * l2
    tw = _twiddles(n)
    cplx = mode == SpectrumChannels.COMPLEX
    phase = mode == SpectrumChannels.PHASE
    rt = torch.fft.fft(y, dim=2)  # the held rows' L2-point transforms
    width = length if cplx else length + 1
    item = 8 if phase else 4
    out = torch.zeros((rows, width), dtype=torch.complex64 if phase else torch.float32)
    times = torch.zeros(width, dtype=torch.int64)
    runs, sectors = [], 0
    groups = l1 // (2 * r)
    for g in range(groups):
        if cplx:
            a0 = 2 * g * r
            p_lo, p_hi = a0 + r, a0 + 2 * r - 1
        else:
            a0 = g * r
            p_lo = l1 // 2 if g == groups - 1 else l1 - a0 - r + 1
            p_hi = l1 - 1 if g == 0 else l1 - a0
        k1s = torch.tensor(list(range(a0, a0 + r)) + list(range(p_lo, p_hi + 1)))
        held = k1s.numel()
        buf = torch.zeros((rows, held, l2 + 1), dtype=torch.complex64)  # [.., L2] is the padding
        buf[:, :, :l2] = rt[:, k1s, :]
        if not cplx:
            # the pairs as the kernel's threads take them
            j = torch.arange(l2)
            ha, hb, k2, k2m = [], [], [], []
            for i in range(r):
                k1 = a0 + i
                if k1 == 0:
                    jj = j[: l2 // 2 + 1]
                    ha.append(torch.full_like(jj, i))
                    hb.append(torch.full_like(jj, i))
                    k2m.append((l2 - jj) % l2)
                else:
                    jj = j
                    ha.append(torch.full_like(jj, i))
                    hb.append(torch.full_like(jj, r + (l1 - k1) - p_lo))
                    k2m.append(l2 - 1 - jj)
                k2.append(jj)
            if g == groups - 1:
                jj = j[: l2 // 2]
                ha.append(torch.full_like(jj, r))
                hb.append(torch.full_like(jj, r))
                k2.append(jj)
                k2m.append(l2 - 1 - jj)
            ha, hb, k2, k2m = (torch.cat(v) for v in (ha, hb, k2, k2m))
            k = k1s[ha] + l1 * k2
            km = length - k
            zk, zm = buf[:, ha, k2], buf[:, hb, k2m]
            swap = k > length // 2
            hk, pk = torch.where(swap, hb, ha), torch.where(swap, k2m, k2)
            hm, pm = torch.where(swap, ha, hb), torch.where(swap, k2, k2m)
            k, km = torch.where(swap, km, k), torch.where(swap, k, km)
            zk, zm = torch.where(swap, zm, zk), torch.where(swap, zk, zm)
            wk = tw[length + k]
            er, ei = 0.5 * (zk.real + zm.real), 0.5 * (zk.imag - zm.imag)
            dr, di = 0.5 * (zk.real - zm.real), 0.5 * (zk.imag + zm.imag)
            p = wk.real * di + wk.imag * dr
            q = wk.real * dr - wk.imag * di
            scale = torch.where(k == 0, 0.5, 1.0)
            xk, xm = torch.complex(er + p, ei - q), torch.complex(er - p, -ei - q)
            if phase:
                vk, vm = xk * scale, xm * scale
            else:
                vk = torch.complex(xk.abs() * scale, torch.zeros_like(scale))
                vm = torch.complex(xm.abs() * scale, torch.zeros_like(scale))
            nyquist = km == length
            hm, pm = torch.where(nyquist, 0, hm), torch.where(nyquist, l2, pm)
            second = km != k
            slots = torch.cat([hk * (l2 + 1) + pk, (hm * (l2 + 1) + pm)[second]])
            assert slots.unique().numel() == slots.numel()  # no two threads write one slot
            assert bool(nyquist.any()) == (g == 0)
            buf[:, hk, pk] = vk
            buf[:, hm[second], pm[second]] = vm[:, second]
        stored = held * l2 + (1 if g == 0 and not cplx else 0)
        qs = torch.arange(stored)
        k2 = qs // held
        h = torch.where(k2 == l2, 0, qs % held)
        bins = k1s[h] + l1 * k2
        vals = buf[:, h, k2]  # k2 == L2: row 0's padding
        out[:, bins] = vals.abs() if cplx else (vals if phase else vals.real)
        times.index_add_(0, bins, torch.ones_like(bins))
        breaks = torch.nonzero(bins[1:] != bins[:-1] + 1).flatten() + 1
        edges = torch.cat([torch.tensor([0]), breaks, torch.tensor([stored])])
        runs += (edges[1:] - edges[:-1]).tolist()
        for row in range(rows):
            addr = (row * width + bins) * item
            for w0 in range(0, stored, 32):
                sectors += (addr[w0 : w0 + 32] // 32).unique().numel()
    return out, times, runs, sectors


def _pass_two_cases():
    """(L, R) with the kernel's constraint 2R <= L1, L = 2^10 .. 2^13."""
    for log2l in range(10, 14):
        l1 = 1 << (log2l >> 1)
        for r in (8, 16, 32):
            if 2 * r <= l1:
                yield 1 << log2l, r


@pytest.mark.parametrize("length,r", list(_pass_two_cases()), ids=lambda v: str(v))
@pytest.mark.parametrize("mode", list(SpectrumChannels)[:8], ids=lambda m: m.name)
def test_pass_two_by_blocks_matches_the_plain_path(mode, length, r):
    """Every channel mode, frames packed and windowed by the port's own
    ``_pack_channels``, the first pass as the kernel's and the second block
    by block: within 5e-6 of each row's peak of ``window_fft_mag_plain``
    (5e-6 is the kernel's bound on the card), a silent row exactly 0, each
    bin stored once, runs of at least R bins (32 bytes or more) and at most
    1 + 8/R sectors a 32 bytes stored (rows of N/2 + 1 bins start off a
    sector's edge; the earlier pass 2: 8)."""
    cplx = mode == SpectrumChannels.COMPLEX
    n = length if cplx else 2 * length
    window = n - 37
    c = make_spectrum_constant(axis_points=32, window_size=window, configuration=mode, device=CPU)
    assert c.transform_size == n
    rng = np.random.default_rng(length + r + int(mode))
    frames = torch.from_numpy((rng.standard_normal((2, 2, window)) * 0.3).astype(np.float32))
    frames[0, 1] = 0.0  # a silent right channel beside a loud left one
    packed = wfm._pack_channels(c, frames)
    if cplx:
        z = torch.zeros((2, n), dtype=torch.complex64)
        z[:, :window] = packed
    else:
        x = torch.zeros(packed.shape[:-1] + (n,))
        x[..., :window] = packed
        z = torch.complex(x[..., 0::2], x[..., 1::2]).reshape(-1, length)
    y, l1, l2 = pass_one(z, n)
    got, times, runs, sectors = pass_two_blocks(y, l1, l2, n, r, mode)
    want = wfm.window_fft_mag_plain(c, frames).reshape(got.shape)
    assert bool((times == 1).all())
    err = (got - want).abs().amax(-1) / want.abs().amax(-1).clamp(min=1e-30)
    assert float(err.max()) <= 5e-6
    silent = (want == 0).all(-1)
    if mode in (SpectrumChannels.SEPARATE, SpectrumChannels.PHASE, SpectrumChannels.RIGHT):
        assert bool(silent.any())
    assert bool((got[silent] == 0).all())
    item = 8 if mode == SpectrumChannels.PHASE else 4
    assert min(runs) >= r and min(runs) * item >= 32
    assert sectors <= (1 + 8 / r) * got.numel() * item / 32


def test_long_form_limits():
    """The wrapper's bounds: the one-block form to 32768 (COMPLEX 16384),
    the cluster form to 131072 (65536), the two-pass form to a core of
    2^20 complex points."""
    assert (wfm.MAX_TRANSFORM_SIZE, wfm.MAX_COMPLEX_TRANSFORM_SIZE) == (32768, 16384)
    assert (wfm.MAX_LONG_TRANSFORM_SIZE, wfm.MAX_LONG_COMPLEX_TRANSFORM_SIZE) == (1 << 21, 1 << 20)
    for window, mode, route in [
        (32768, SpectrumChannels.SEPARATE, "block"),
        (32769, SpectrumChannels.SEPARATE, "cluster"),
        (131073, SpectrumChannels.SEPARATE, "two_pass"),
        (16384, SpectrumChannels.COMPLEX, "block"),
        (16385, SpectrumChannels.COMPLEX, "cluster"),
        (65537, SpectrumChannels.COMPLEX, "two_pass"),
    ]:
        c = make_spectrum_constant(axis_points=32, window_size=window, configuration=mode, device=CPU)
        assert wfm.form(c) == route


# --- kernel B's line-graph groups -------------------------------------------


@pytest.mark.parametrize("graphs", [8, 9, 17])
def test_line_graph_groups_cover_every_line_graph(graphs):
    """``_line_graph_groups`` hands out groups of at most eight line graphs
    whose state and output are written back where they belong: the plain
    decay run group by group equals all line graphs at once bit for bit."""
    c = make_spectrum_constant(axis_points=48, window_size=256, configuration=SpectrumChannels.SEPARATE,
                               num_line_graphs=graphs, decay_seconds=(0.05, 0.2, 0.0, 1.0), device=CPU)
    rng = np.random.default_rng(graphs)
    vals = torch.from_numpy(rng.random((3, 5, 2, 48)).astype(np.float32))
    state = torch.from_numpy(rng.random((3, graphs, 2, 48)).astype(np.float32))
    s_all, s_groups = state.clone(), state.clone()
    want = dm.decay_db(c, s_all, vals)
    out = torch.empty_like(want)
    sizes = []
    for poles, st, o, k in dm._line_graph_groups(c, s_groups, out):
        sizes.append(k)
        o.copy_(dm.decay_db(dataclasses.replace(c, decay_poles=poles), st, vals))
    assert sizes == [min(8, graphs - i) for i in range(0, graphs, 8)]
    assert torch.equal(out, want) and torch.equal(s_groups, s_all)
