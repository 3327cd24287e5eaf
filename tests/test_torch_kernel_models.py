"""The arithmetic of the redesigned CUDA kernels, rehearsed in torch on the
CPU: the display kernel's split of the peak-decay recurrence over groups of
frames (bit-equal to the sequential loop), and the FFT kernel's packed real
transform (bit-reversed radix-2 stages from the stage-ordered twiddle table,
then the split into the real row's bins). The kernels themselves are held
against their plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

from signalizer_tpu_torch.core.constant import fft_twiddles
from signalizer_tpu_torch.kernels.peak_decay import peak_decay_scan


def split_decay(state0, v, pole, valid, group, groups_per_chunk=8):
    """``s_t = max(pole * s_{t-1}, v_t)`` at valid frames, evaluated as the
    display kernel does: T is cut into chunks of ``groups_per_chunk`` groups
    of ``group`` frames. Each group scans its frames from an empty state
    (-inf) to its end value; the state a group starts from is the chunk's
    start state folded in order through the groups before it (one multiply
    by the pole per valid frame of that group, then the max with its end
    value); each group then runs the recurrence from that state. v [T, ...],
    state0 [...], pole broadcastable, valid [T] bool. Returns (s [T, ...],
    final state)."""
    t_total = v.shape[0]
    out = torch.empty_like(v)
    chunk_start = state0.clone()
    neg_inf = torch.full_like(state0, -torch.inf)
    for c0 in range(0, t_total, group * groups_per_chunk):
        bounds = [
            (min(c0 + g * group, t_total), min(c0 + (g + 1) * group, t_total))
            for g in range(groups_per_chunk)
        ]
        ends = []
        for lo, hi in bounds:  # every group at once on the card
            l = neg_inf
            for t in range(lo, hi):
                if valid[t]:
                    # fmaxf drops the NaN of 0 * -inf; torch.fmax does too
                    l = torch.fmax(pole * l, v[t])
            ends.append(l)
        for g, (lo, hi) in enumerate(bounds):
            s = chunk_start
            for h in range(g):
                for t in range(*bounds[h]):
                    if valid[t]:
                        s = pole * s
                s = torch.fmax(s, ends[h])
            for t in range(lo, hi):
                if valid[t]:
                    s = torch.fmax(pole * s, v[t])
                out[t] = s
        chunk_start = s  # the last group ends on the chunk's end state
    return out, chunk_start


@pytest.mark.parametrize("group", [1, 16, 128])
@pytest.mark.parametrize("t_total", [1, 7, 127, 128, 300])
@pytest.mark.parametrize("mask", ["all", "random", "none"])
def test_split_decay_is_bit_equal_to_the_sequential_scan(t_total, group, mask):
    rng = np.random.default_rng(1000 * t_total + group)
    v = torch.from_numpy((np.abs(rng.standard_normal((t_total, 3, 37))) * 10.0 ** rng.uniform(-6, 2)).astype(np.float32))
    v[rng.random(v.shape) < 0.1] = 0.0
    state0 = torch.from_numpy((rng.random((3, 37)) * 5.0).astype(np.float32))
    # poles in (0, 1), one nearly 1, one tiny, and the 0 a zero decay time gives
    pole = torch.tensor([[0.9261187], [0.99998], [0.0]], dtype=torch.float32)
    if group == 1:
        pole[1] = 1e-3
    valid = {
        "all": np.ones(t_total, bool),
        "random": rng.random(t_total) > 0.35,
        "none": np.zeros(t_total, bool),
    }[mask]
    want, want_state = peak_decay_scan(state0, v, pole, time_axis=0, valid=torch.from_numpy(valid))
    got, got_state = split_decay(state0, v, pole, valid, group)
    assert torch.equal(got, want)
    assert torch.equal(got_state, want_state)
    if mask == "none":
        assert torch.equal(got_state, state0)


def packed_real_spectrum(x: torch.Tensor, n: int) -> torch.Tensor:
    """rFFT bins [rows, n/2 + 1] complex64 of real rows x [rows, W <= n], as
    the FFT kernel computes them: zero-pad, pack z[m] = x[2m] + i x[2m+1],
    an n/2-point radix-2 decimation-in-time transform over the bit-reversed
    row with stage ``half``'s twiddles at ``table[half + pos]``, then
    ``X[k] = (Z[k] + conj Z[n/2-k])/2 - (i/2) e^{-2 pi i k/n} (Z[k] - conj Z[n/2-k])``
    for the pair (k, n/2 - k), in float32 throughout."""
    rows, w = x.shape
    l = n // 2
    log2l = l.bit_length() - 1
    table = torch.view_as_complex(torch.from_numpy(fft_twiddles(n)))
    padded = torch.zeros((rows, n), dtype=torch.float32)
    padded[:, :w] = x
    z = torch.complex(padded[:, 0::2], padded[:, 1::2])
    m = np.arange(l)
    rev = np.zeros(l, np.int64)
    for bit in range(log2l):
        rev |= ((m >> bit) & 1) << (log2l - 1 - bit)
    buf = torch.empty_like(z)
    buf[:, rev] = z  # the prologue's scatter
    half = 1
    while half < l:
        b = buf.reshape(rows, l // (2 * half), 2, half)
        tw = table[half : 2 * half]
        lo, hi = b[:, :, 0, :], b[:, :, 1, :] * tw
        buf = torch.stack([lo + hi, lo - hi], dim=2).reshape(rows, l)
        half *= 2
    k = torch.arange(l // 2 + 1)
    zk, zm = buf[:, k], buf[:, (l - k) % l]
    wk = table[l + k]
    er, ei = 0.5 * (zk.real + zm.real), 0.5 * (zk.imag - zm.imag)
    dr, di = 0.5 * (zk.real - zm.real), 0.5 * (zk.imag + zm.imag)
    p = wk.real * di + wk.imag * dr
    q = wk.real * dr - wk.imag * di
    out = torch.empty((rows, l + 1), dtype=torch.complex64)
    out[:, k] = torch.complex(er + p, ei - q)
    out[:, l - k[:-1]] = torch.complex(er - p, -ei - q)[:, :-1]  # k = l/2 is its own partner
    return out


@pytest.mark.parametrize("n,w", [(32, 32), (32, 21), (4096, 4096), (4096, 3001), (16384, 16384), (16384, 9000)])
def test_packed_real_split_matches_rfft(n, w):
    """Bound: 2e-6 of each row's largest bin (float32 butterflies against
    torch's float32 rfft); a silent row gives exact zeros whatever its
    neighbour holds."""
    rng = np.random.default_rng(n + w)
    x = (rng.standard_normal((4, w)) * 0.3).astype(np.float32)
    x[1] = 0.0  # silent, beside loud rows
    x[2] = 0.5 * np.sin(2 * np.pi * 5 * np.arange(w) / n)  # an exact bin
    x = torch.from_numpy(x)
    got = packed_real_spectrum(x, n)
    want = torch.fft.rfft(x, n=n, dim=-1)
    assert got.shape == want.shape == (4, n // 2 + 1)
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp(min=1e-30)
    assert float((err / scale).max()) <= 2e-6
    assert bool((got[1] == 0).all())
    assert float(got[:, 0].imag.abs().max()) == 0.0  # DC and Nyquist are real
    assert float(got[:, -1].imag.abs().max()) == 0.0
