"""Kernel A's cluster form rehearsed in torch on the CPU, and the choice of
form by transform size.

``cluster_fft`` follows ``csrc/window_fft_mag_cluster.cu`` index for index:
the L-point core is cut into 8 virtual blocks of L/8 points, virtual block
k holding the transform of the decimated input z[8n + bitrev_8(k)]; block c
of a cluster of S holds virtual blocks c + S t (t < V = 8/S) at local
offsets t L/8, filled from the runs z[8n + V bitrev_S(c) + (0 .. V-1)] and
swizzled by ``slot``; the last 3 stages run as one radix-8 pass on work
units that read element i of every virtual block through its owner's
``slot`` (unit u takes elements u and L/8 - u, unit 0 elements 0 and
L/16), with the stage twiddles read from the constant's ``fft_twiddles``;
the real split pairs each radix-8 output with its partner from the same
unit and writes both bins. The local L/8-point transforms are torch's
(they are the one-block form's passes, held against ``torch.fft`` on the
card); what is rehearsed is the kernel's own arithmetic around them, in
float32 with the kernel's formulas. Bound: 5e-6 of each row's peak against
float64 ``torch.fft``, the bound the kernel is held to on the card; a
silent row exactly 0; every output bin written exactly once, by the block
that owns its unit.
"""

import numpy as np
import pytest
import torch

from signalizer_tpu_torch.core.config import SpectrumChannels
from signalizer_tpu_torch.core.constant import fft_twiddles, make_spectrum_constant
from signalizer_tpu_torch.kernels import window_fft_mag as wfm

CPU = torch.device("cpu")


def _bit_reverse(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _slot(i: torch.Tensor, log2l: int) -> torch.Tensor:
    """window_fft_common.cuh's shared-memory swizzle."""
    x = i ^ ((i >> 4) & 15)
    if log2l > 8:
        x = x ^ ((i >> (log2l - 4)) & 15)
    return x


def _cmul(a, b):
    return torch.complex(a.real * b.real - a.imag * b.imag, a.real * b.imag + a.imag * b.real)


def cluster_fft(z: torch.Tensor, n: int, real: bool, s: int):
    """The cluster form on rows ``z`` [rows, L] complex64 (the packed
    z[m] = x[2m] + i x[2m+1] of a real row, or a COMPLEX row) with S = ``s``
    blocks: real rows give X[0..L] (DC and Nyquist halved), COMPLEX rows
    |Z[0..L)|. Also returns, for each output bin, the block that wrote it."""
    rows, length = z.shape
    log2s = s.bit_length() - 1
    log2v = 3 - log2s
    lb, lh = length // s, length // 8  # a block's share, a virtual block
    log2b, log2h = lb.bit_length() - 1, lh.bit_length() - 1
    t = torch.from_numpy(fft_twiddles(n))
    tw = torch.complex(t[:, 0], t[:, 1])

    # block c's shared memory: local element e = V n + t' holds the run
    # sample z[8n + V bitrev_S(c) + t'] at position bitrev(e), so virtual
    # block c + S bitrev_V(t') (local offset bitrev_V(t') L/8) holds the
    # decimated input z[8n + bitrev_8(c + S bitrev_V(t'))] bit-reversed;
    # after the local passes, each virtual block its transform
    shared = []
    for c in range(s):
        e = torch.arange(lb)
        m = (e >> log2v) * 8 + (_bit_reverse(c, log2s) << log2v) + (e & ((1 << log2v) - 1))
        pos = torch.tensor([_bit_reverse(int(x), log2b) for x in e])
        held = torch.empty_like(z[:, :lb])
        held[:, pos] = z[:, m]  # the prologue's scatter, bit-reversed
        local = torch.empty_like(held)
        for tv in range(1 << log2v):
            k = c + s * tv
            run = held[:, tv * lh : (tv + 1) * lh]  # virtual block k, bit-reversed
            assert torch.equal(run[:, [_bit_reverse(i, log2h) for i in range(lh)]],
                               z[:, _bit_reverse(k, 3) :: 8])
            local[:, tv * lh : (tv + 1) * lh] = torch.fft.fft(z[:, _bit_reverse(k, 3) :: 8], dim=-1)
        buf = torch.empty_like(local)
        buf[:, _slot(torch.arange(lb), log2b)] = local
        shared.append(buf)

    # units: u < L/16 takes elements ia = u and ib = L/8 - u (u = 0: L/16)
    per = lh >> (log2s + 1)
    u = torch.arange(lh // 2)
    ia = u
    ib = torch.where(u > 0, lh - u, lh // 2)
    block_of_unit = u // per
    elements = torch.cat([ia, ib])
    assert torch.equal(elements.sort().values, torch.arange(lh))  # each element in one unit
    assert torch.equal(torch.bincount(block_of_unit), torch.full((s,), per))

    def radix(idx):
        # element idx of virtual block k: block k mod S, offset (k / S) L/8,
        # read through the owner's slot
        v = [shared[k % s][:, _slot((k // s) * lh + idx, log2b)] for k in range(8)]
        for q in range(3):
            half = lh << q
            for j in range(8):
                if j & (1 << q):
                    continue
                j1 = j | (1 << q)
                w = tw[half + idx + (j & ((1 << q) - 1)) * lh]
                tr = _cmul(w.expand_as(v[j1]), v[j1])
                v[j1], v[j] = v[j] - tr, v[j] + tr
        return v  # v[k] = Z[idx + k L/8]

    va, vb = radix(ia), radix(ib)
    if not real:
        out = torch.full((rows, length), float("nan"))
        owner = torch.full((length,), -1)
        for k in range(8):
            for idx, v in ((ia, va[k]), (ib, vb[k])):
                bins = idx + k * lh
                assert out[:, bins].isnan().all()  # each bin once
                out[:, bins] = v.abs()
                owner[bins] = block_of_unit
        assert not out.isnan().any()
        return out, owner

    out = torch.full((rows, length + 1), complex(float("nan"), 0.0), dtype=torch.complex64)
    owner = torch.full((length + 1,), -1)

    def split_store(k, zk, zm, units):
        """X[k] and X[L - k] (k <= L/2) from Z[k] and Z[L - k]."""
        assert bool((k <= length // 2).all())
        km = length - k
        wk = tw[length + k]
        er, ei = 0.5 * (zk.real + zm.real), 0.5 * (zk.imag - zm.imag)
        dr, di = 0.5 * (zk.real - zm.real), 0.5 * (zk.imag + zm.imag)
        p = wk.real * di + wk.imag * dr
        q = wk.real * dr - wk.imag * di
        scale = torch.where(k == 0, 0.5, 1.0)
        other = km != k
        assert out[:, k].isnan().all() and out[:, km[other]].isnan().all()  # each bin once
        out[:, k] = torch.complex(er + p, ei - q) * scale
        out[:, km[other]] = (torch.complex(er - p, -ei - q) * scale)[:, other]
        owner[k] = block_of_unit[units]
        owner[km[other]] = block_of_unit[units][other]

    g = u > 0  # the general units: bin ia + k L/8 pairs with ib + (7-k) L/8
    for k in range(4):
        split_store(ia[g] + k * lh, va[k][:, g], vb[7 - k][:, g], g)
        split_store(ib[g] + k * lh, vb[k][:, g], va[7 - k][:, g], g)
    # unit 0: bins k L/8 with (8 - k) L/8, and L/16 + k L/8 with L/16 + (7-k) L/8
    zero = u == 0
    for k in range(5):
        split_store(ia[zero] + k * lh, va[k][:, zero], va[(8 - k) & 7][:, zero], zero)
    for k in range(4):
        split_store(ib[zero] + k * lh, vb[k][:, zero], vb[7 - k][:, zero], zero)
    assert not out.isnan().any()
    return out, owner


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("n", [2048, 4096, 65536, 131072])
def test_cluster_fft_real_rows_match_rfft(n, s):
    """A zero-padded real row (W < N, odd W) and a silent row through the
    rehearsal: X[k] within 5e-6 of the row's peak, DC and Nyquist halved,
    the silent row exactly 0; the bins a block writes are its units'."""
    rng = np.random.default_rng(n + s)
    x = torch.zeros(2, n)
    x[0, : n - 37] = torch.from_numpy(rng.standard_normal(n - 37).astype(np.float32))
    z = torch.complex(x[:, 0::2], x[:, 1::2])
    got, owner = cluster_fft(z, n, real=True, s=s)
    want = torch.fft.rfft(x.double(), dim=-1)
    want[:, 0] *= 0.5
    want[:, -1] *= 0.5
    err = (got.cdouble() - want).abs().amax(-1)[0] / want.abs().amax(-1)[0]
    assert float(err) <= 5e-6
    assert bool((got[1] == 0).all())
    assert bool((owner >= 0).all()) and bool((owner < s).all())


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("n", [1024, 32768, 65536])
def test_cluster_fft_complex_rows_match_fft(n, s):
    rng = np.random.default_rng(n + s + 1)
    z = torch.from_numpy((rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64))
    z[1] = 0
    got, owner = cluster_fft(z, n, real=False, s=s)
    want = torch.fft.fft(z[:1].cdouble(), dim=-1).abs()
    assert float(((got[:1].double() - want).abs().amax(-1) / want.amax(-1)).max()) <= 5e-6
    assert bool((got[1] == 0).all())
    assert bool((owner >= 0).all())


@pytest.mark.parametrize("s", [2, 8])
def test_cluster_units_store_coalesced(s):
    """A warp's 32 consecutive units of one block write, for each radix-8
    output k, 32 consecutive bins (ascending from ia, descending from ib):
    each store instruction fills 128 contiguous bytes."""
    lh = 32768 // 8
    per = lh // (2 * s)
    for c in range(s):
        for u0 in range(c * per, (c + 1) * per, 32):
            u = np.arange(u0, min(u0 + 32, (c + 1) * per))
            u = u[u > 0]  # unit 0 takes elements 0 and L/16
            for k in range(8):
                assert np.all(np.diff(u + k * lh) == 1)
                assert np.all(np.diff(lh - u + k * lh) == -1)


@pytest.mark.parametrize("s", [2, 4, 8])
def test_cluster_prologue_reads_runs(s):
    """Block c's samples are runs of V = 8/S consecutive points (a 16-byte
    load of two packed real points; four make a 32-byte sector), and the S
    blocks' runs tile the row."""
    v = 8 // s
    seen = []
    for c in range(s):
        m0 = np.arange(64) * 8 + _bit_reverse(c, s.bit_length() - 1) * v
        seen.append((m0[:, None] + np.arange(v)).ravel())
    assert np.array_equal(np.sort(np.concatenate(seen)), np.arange(512))


@pytest.mark.parametrize(
    "window,mode,route",
    [
        (32768, SpectrumChannels.SEPARATE, "block"),
        (32769, SpectrumChannels.SEPARATE, "cluster"),
        (48000, SpectrumChannels.PHASE, "cluster"),
        (65536, SpectrumChannels.LEFT, "cluster"),
        (131072, SpectrumChannels.MIDSIDE, "cluster"),
        (131073, SpectrumChannels.SEPARATE, "two_pass"),
        (1 << 21, SpectrumChannels.SEPARATE, "two_pass"),
        (16384, SpectrumChannels.COMPLEX, "block"),
        (16385, SpectrumChannels.COMPLEX, "cluster"),
        (65536, SpectrumChannels.COMPLEX, "cluster"),
        (65537, SpectrumChannels.COMPLEX, "two_pass"),
        (1 << 20, SpectrumChannels.COMPLEX, "two_pass"),
    ],
    ids=lambda v: v.name if isinstance(v, SpectrumChannels) else str(v),
)
def test_form_by_transform_size(window, mode, route):
    """One block to 32768 points (COMPLEX 16384), a cluster to 131072
    (65536), two passes above."""
    c = make_spectrum_constant(axis_points=32, window_size=window, configuration=mode, device=CPU)
    assert wfm.form(c) == route


def test_cluster_limits():
    assert (wfm.MAX_CLUSTER_TRANSFORM_SIZE, wfm.MAX_CLUSTER_COMPLEX_TRANSFORM_SIZE) == (1 << 17, 1 << 16)
    # a real row of N points is an N/2-point core: the two limits are one core
    assert wfm.MAX_CLUSTER_TRANSFORM_SIZE // 2 == wfm.MAX_CLUSTER_COMPLEX_TRANSFORM_SIZE
    # 4 blocks of 64 KB for the 32768-point core, 8 for the longest
    for window, mode, blocks in [
        (32769, SpectrumChannels.SEPARATE, 4),
        (65536, SpectrumChannels.SEPARATE, 4),
        (65537, SpectrumChannels.MIDSIDE, 8),
        (131072, SpectrumChannels.PHASE, 8),
        (16385, SpectrumChannels.COMPLEX, 4),
        (65536, SpectrumChannels.COMPLEX, 8),
    ]:
        c = make_spectrum_constant(axis_points=32, window_size=window, configuration=mode, device=CPU)
        assert wfm.form(c) == "cluster" and wfm.cluster_size(c) == blocks
        core = c.transform_size // (1 if mode == SpectrumChannels.COMPLEX else 2)
        assert 8 * core // blocks <= wfm.CLUSTER_SHARE_BYTES <= 227 * 1024
