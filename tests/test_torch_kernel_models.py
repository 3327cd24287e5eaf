"""The arithmetic of the redesigned CUDA kernels, rehearsed in torch on the
CPU: the display kernel's split of the peak-decay recurrence over groups of
frames (bit-equal to the sequential loop), the decay-and-dB kernel's grid
(groups of frames in a block, chunks of them across blocks, the chunks'
end values folded in order: bit-equal to ``decay_db``), the FFT kernel's packed real
transform (bit-reversed radix-2 stages from the stage-ordered twiddle table,
then the split into the real row's bins), and the resample kernel's Lanczos
weights from three trigonometric values a pixel and a rotation table, and
the colour track kernel's chunked scans split across a thread-block
cluster (a numpy model, held to a float64 oracle within twice the plain
doubling scans' own error), and the PHASE tail kernel's walk-then-map plan
(bit-equal to its plain loops), and the PHASE values kernel's walk (a
numpy model, bit-equal to ``_binmax_argbin`` and the plain path's
gathers). The
kernels themselves are held against their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from phase_cases import phase_spectra
from signalizer_tpu_torch.core.config import BinInterpolation, SpectrumChannels, ViewScaling
from signalizer_tpu_torch.core.constant import fft_twiddles, make_spectrum_constant
from signalizer_tpu_torch.kernels import banded_resample as br
from signalizer_tpu_torch.kernels import colour_track as ct
from signalizer_tpu_torch.kernels import display_map as dm
from signalizer_tpu_torch.kernels import filters as tf
from signalizer_tpu_torch.kernels import phase_decay_db as pd
from signalizer_tpu_torch.kernels import spectrum as ts
from signalizer_tpu_torch.kernels.display_map import _db_map
from signalizer_tpu_torch.kernels.peak_decay import peak_decay_scan


def _fold(s, pole, n, end):
    """One link of the fold: ``n`` valid frames decay ``s``, then the max
    with ``end``, the end value those frames reach from an empty state."""
    for _ in range(n):
        s = pole * s
    # fmaxf drops the NaN of 0 * -inf; torch.fmax does too
    return torch.fmax(s, end)


def split_decay(state0, v, pole, valid, group, groups_per_chunk=8, blocks=1):
    """``s_t = max(pole * s_{t-1}, v_t)`` at valid frames, evaluated as the
    display kernel does: T is cut into chunks of ``groups_per_chunk`` groups
    of ``group`` frames (fewer groups where a block's frames fill fewer).
    Each group scans its frames from an empty state (-inf) to its end value;
    the state a group starts from is the chunk's start state folded in order
    through the groups before it (one multiply by the pole per valid frame
    of that group, then the max with its end value); each group then runs
    the recurrence from that state. With ``blocks`` > 1, as the kernel
    splits a tile's frames across a cluster: block b takes frames [b T /
    blocks, (b + 1) T / blocks) and first folds its groups' end values from
    an empty state into its span's end value (with its count of valid
    frames); its start state is ``state0`` folded, in rank order, through
    the spans before it, and it walks its frames from there. v [T, ...],
    state0 [...], pole broadcastable, valid [T] bool. Returns (s [T, ...],
    final state)."""
    t_total = v.shape[0]
    out = torch.empty_like(v)
    neg_inf = torch.full_like(state0, -torch.inf)
    groups = min(groups_per_chunk, -(-(-(-t_total // blocks)) // group))
    spans = [(t_total * b // blocks, t_total * (b + 1) // blocks) for b in range(blocks)]

    def chunks(lo, hi):
        """Each chunk of [lo, hi): its groups' (frames, end value, count)."""
        for c0 in range(lo, hi, group * groups):
            bounds = [(min(c0 + g * group, hi), min(c0 + (g + 1) * group, hi)) for g in range(groups)]
            ends = []
            for a, b in bounds:  # every group at once on the card
                l = neg_inf
                for t in range(a, b):
                    if valid[t]:
                        l = torch.fmax(pole * l, v[t])
                ends.append(l)
            yield [(range(a, b), e, int(sum(valid[a:b]))) for (a, b), e in zip(bounds, ends)]

    def walk(lo, hi, chunk_start):
        for chunk in chunks(lo, hi):
            for g, (frames, _, _) in enumerate(chunk):
                s = chunk_start
                for _, end, n in chunk[:g]:
                    s = _fold(s, pole, n, end)
                for t in frames:
                    if valid[t]:
                        s = torch.fmax(pole * s, v[t])
                    out[t] = s
            chunk_start = s  # the last group ends on the chunk's end state
        return chunk_start

    if blocks == 1:
        return out, walk(0, t_total, state0)
    span_ends = []  # every block's first walk at once on the card
    for lo, hi in spans:
        l = neg_inf
        for chunk in chunks(lo, hi):
            for _, end, n in chunk:
                l = _fold(l, pole, n, end)
        span_ends.append((l, int(sum(valid[lo:hi]))))
    for b, (lo, hi) in enumerate(spans):
        s = state0
        for end, n in span_ends[:b]:
            s = _fold(s, pole, n, end)
        final = walk(lo, hi, s)
    return out, final


def _decay_case(t_total, seed):
    """Display values [T, 3, 37] over eight decades with zeros among them, a
    state, and poles: one in (0, 1), one nearly 1, and the 0 a zero decay
    time gives."""
    rng = np.random.default_rng(seed)
    v = torch.from_numpy((np.abs(rng.standard_normal((t_total, 3, 37))) * 10.0 ** rng.uniform(-6, 2)).astype(np.float32))
    v[rng.random(v.shape) < 0.1] = 0.0
    state0 = torch.from_numpy((rng.random((3, 37)) * 5.0).astype(np.float32))
    pole = torch.tensor([[0.9261187], [0.99998], [0.0]], dtype=torch.float32)
    return rng, v, state0, pole


@pytest.mark.parametrize("group", [1, 16, 128])
@pytest.mark.parametrize("t_total", [1, 7, 127, 128, 300])
@pytest.mark.parametrize("mask", ["all", "random", "none"])
def test_split_decay_is_bit_equal_to_the_sequential_scan(t_total, group, mask):
    rng, v, state0, pole = _decay_case(t_total, 1000 * t_total + group)
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


@pytest.mark.parametrize("blocks", [2, 8, 16])
@pytest.mark.parametrize("t_total", [65, 509, 512, 513])
@pytest.mark.parametrize("mask", ["random", "block_invalid", "all"])
def test_cluster_split_decay_is_bit_equal_to_the_sequential_scan(t_total, blocks, mask):
    """The fused entry's split of T across a cluster's blocks (8 frames a
    group, up to 8 groups a chunk, spans of about T / blocks frames: one
    chunk at T = 512 and 8 blocks, several at 2) against the sequential
    scan, state and every frame bit for bit: random masks, one block's whole
    span invalid (an empty span end, no decay: the next block starts from
    the state before it), every frame valid; a zero pole among the poles."""
    rng, v, state0, pole = _decay_case(t_total, 7 * t_total + blocks)
    valid = rng.random(t_total) > 0.35 if mask != "all" else np.ones(t_total, bool)
    if mask == "block_invalid":
        b = blocks // 2
        valid[t_total * b // blocks : t_total * (b + 1) // blocks] = False
    want, want_state = peak_decay_scan(state0, v, pole, time_axis=0, valid=torch.from_numpy(valid))
    got, got_state = split_decay(state0, v, pole, valid, 8, blocks=blocks)
    assert torch.equal(got, want)
    assert torch.equal(got_state, want_state)


def decay_db_grid(constant, state, vals, valid, plan):
    """``display_decay_db`` as ``csrc/display_decay_db.cu`` runs it, for one
    launch's line graphs (at most 8), in torch: ``vals`` [pairs, T, rows,
    P], ``state`` [pairs, K, rows, P] updated in place, ``plan`` =
    ``decay_db_plan``'s (frames a group, groups a fold block, chunks). With
    more than one chunk a first launch writes each chunk's end value from
    an empty state and a copy of the state; fold block (chunk c) starts
    from the copy folded through chunks 0..c-1 in order, takes each group's
    end value from -inf and walks the groups in order (the group's start
    state, then one multiply by the pole per valid frame and the max with
    its end value); the output pass runs each group's recurrence from its
    start state and the dB map. Returns [pairs, T, K, rows, P]."""
    frames, groups, chunks = plan
    t_total = vals.shape[1]
    pole = constant.decay_poles[None, :, None, None]  # against [pairs, K, rows, P]
    valid = torch.ones(t_total, dtype=torch.bool) if valid is None else torch.as_tensor(valid)
    chunk_frames = groups * frames
    x = vals[:, :, None]  # [pairs, T, 1, rows, P]
    neg_inf = torch.full_like(state, -torch.inf)

    def group_end(t0, t1):
        l = neg_inf
        for t in range(t0, t1):
            if valid[t]:
                l = torch.fmax(pole * l, x[:, t])
        return l, int(valid[t0:t1].sum())

    def walk(s, c):
        """Each group's start state in chunk c from s, and the chunk's end."""
        starts = []
        for g in range(groups):
            t0 = min(c * chunk_frames + g * frames, t_total)
            l, n = group_end(t0, min(t0 + frames, t_total))
            starts.append(s)
            for _ in range(n):
                s = pole * s
            s = torch.fmax(s, l)
        return starts, s

    # the first launch: the chunks' end values from an empty state, the copy
    ends = [walk(neg_inf, c)[1] for c in range(chunks - 1)]
    copy = state.clone()
    out = torch.empty(vals.shape[:2] + state.shape[1:2] + vals.shape[2:])
    for c in range(chunks):
        s = copy
        for e in range(c):
            for _ in range(int(valid[e * chunk_frames : (e + 1) * chunk_frames].sum())):
                s = pole * s
            s = torch.fmax(s, ends[e])
        starts, end = walk(s, c)
        for g, s in enumerate(starts):
            t0 = c * chunk_frames + g * frames
            for t in range(t0, min(t0 + frames, t_total)):
                if valid[t]:
                    s = torch.fmax(pole * s, x[:, t])
                out[:, t] = s
        if c == chunks - 1:
            state.copy_(end)
    return dm._db_map(constant, out)


DECAY_MASKS = ["all", "ragged", "one_invalid", "none"]


@pytest.mark.parametrize("mask", DECAY_MASKS)
@pytest.mark.parametrize("graphs", [1, 2, 8, 11])
@pytest.mark.parametrize("t_total,sms", [(1, 132), (7, 132), (128, 2), (128, 132), (300, 132)],
                         ids=["t1", "t7", "t128_one_chunk", "t128_chunks", "t300_chunks"])
def test_decay_db_grid_is_bit_equal_to_decay_db(t_total, sms, graphs, mask):
    """The kernel's grid, as ``decay_db_plan`` lays it out for 2 pairs x 2
    rows x 300 px (3 warps of pixels), against the sequential ``decay_db``:
    state and display bit for bit, for all-valid, ragged, one-invalid and
    no valid frames, one chunk and many (a card of 2 multiprocessors keeps
    T = 128 in one chunk for up to 4 line graphs a launch), and more line graphs
    than one launch takes (the wrapper's groups of 8)."""
    c = make_spectrum_constant(
        axis_points=300, window_size=1024, configuration=SpectrumChannels.SEPARATE,
        view_scaling=ViewScaling.LOGARITHMIC, num_line_graphs=graphs,
        decay_seconds=(0.1, 0.0, 1.0, 0.02), device=torch.device("cpu"),
    )
    rng = np.random.default_rng(t_total * 100 + graphs)
    vals = torch.from_numpy((np.abs(rng.standard_normal((2, t_total, 2, 300))) * 0.3).astype(np.float32))
    vals[:, :, :, ::17] = 0.0
    state = torch.from_numpy((rng.random((2, graphs, 2, 300)) * 0.5).astype(np.float32))
    valid = {
        "all": None,
        "ragged": rng.random(t_total) > 0.3,
        "one_invalid": np.arange(t_total) != t_total // 2,
        "none": np.zeros(t_total, bool),
    }[mask]
    s_grid, s_plain = state.clone(), state.clone()
    want = dm.decay_db(c, s_plain, vals, valid)
    got = torch.empty_like(want)
    plans = []
    for poles, st, o, k in dm._line_graph_groups(c, s_grid, got):
        plan = dm.decay_db_plan(2, t_total, k, 2, 300, sms)
        plans.append(plan)
        o.copy_(decay_db_grid(dataclasses.replace(c, decay_poles=poles), st, vals, valid, plan))
    assert torch.equal(got, want)
    assert torch.equal(s_grid, s_plain)
    if mask == "none":
        assert torch.equal(s_grid, state)
    chunks = {p[2] for p in plans}
    if t_total == 1:
        assert chunks == {1}
    elif sms == 2:  # more than 4 line graphs a launch take at most 8 groups a fold block
        assert [p[2] for p in plans] == [1 if k <= 4 else 2 for k in (min(8, graphs - i) for i in range(0, graphs, 8))]
    else:  # 12 blocks of pixels do not cover 132 multiprocessors: T is split
        assert min(chunks) > 1


def test_decay_db_plan_covers_the_card():
    """The headline (16 pairs x 128 frames x 2 rows x 1024 px, K = 2) is one
    chunk of 16 groups of 8 frames, 256 fold blocks; the spectrogram's 1 x
    512 frames x 1 row takes 2 groups a fold block and 32 chunks so that 256
    blocks cover 132 multiprocessors; T <= 8 takes a frame a group; shared
    memory bounds groups x line graphs."""
    assert dm.decay_db_plan(16, 128, 2, 2, 1024, 132) == (8, 16, 1)
    assert dm.decay_db_plan(1, 512, 2, 1, 1024, 132) == (8, 2, 32)
    assert dm.decay_db_plan(16, 1, 2, 2, 1024, 132) == (1, 1, 1)
    assert dm.decay_db_plan(16, 8, 8, 2, 1024, 132) == (1, 8, 1)
    frames, groups, chunks = dm.decay_db_plan(16, 128, 8, 2, 1024, 132)
    assert (frames, groups, chunks) == (8, 8, 2) and groups * 8 <= dm.DECAY_MAX_GROUPS_K



def test_display_map_plan_covers_the_card():
    """The fused entry's blocks a tile: one at the headline (16 pairs x 2
    rows x 1024 px, T = 256: 1024 tiles cover 132 multiprocessors) and
    wherever T fits one chunk (T <= 64); the spectrogram's 1 pair x 1 row x
    1024 px at T = 512 or 509 (32 tiles) splits T across a power-of-two
    cluster of at most 16 blocks that gives 132 blocks or more (16: 512 of
    the card's 528 block slots, one wave); a block keeps a group of 8
    frames (T = 65: 8 blocks, not 16); more tiles take fewer blocks."""
    assert dm.display_map_plan(16, 256, 2, 2, 1024, 132) == 1
    for t in (1, 8, 9, 33, 64):
        assert dm.display_map_plan(1, t, 2, 1, 1024, 132) == 1
    for t in (509, 512):
        cluster = dm.display_map_plan(1, t, 2, 1, 1024, 132)
        assert 32 * cluster >= 132 and cluster & (cluster - 1) == 0 and cluster <= 16
        assert cluster == 16
    assert dm.display_map_plan(1, 65, 2, 1, 1024, 132) == 8
    assert dm.display_map_plan(1, 9000, 8, 1, 1024, 132) == 16
    assert dm.display_map_plan(2, 512, 2, 2, 1024, 132) == 4  # 128 tiles: 512 blocks
    assert dm.display_map_plan(1, 512, 2, 1, 4000, 132) == 4  # 125 tiles: 500 blocks
    assert dm.display_map_plan(1, 512, 2, 1, 4224, 132) == 1  # 132 tiles cover the card


@pytest.mark.parametrize(
    "python_name,kernel_value",
    [("DECAY_FRAMES", "kFrames"), ("DECAY_WARP_PIXELS", "4 * kWarp"), ("DECAY_MAX_GROUPS", "kMaxGroups"),
     ("DECAY_MAX_GROUPS_K", "kMaxGroupsK"), ("MAX_LINE_GRAPHS", "kMaxK")],
)
def test_decay_db_plan_constants_are_the_kernels(python_name, kernel_value):
    """The wrapper plans the decay-and-dB layout from copies of the kernel's
    constants: each copy equals its constant in csrc/display_decay_db.cu."""
    import re
    from pathlib import Path

    source = (Path(dm.__file__).resolve().parent.parent / "csrc" / "display_decay_db.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", source)}
    factor, _, name = kernel_value.rpartition(" * ")
    assert getattr(dm, python_name) == int(factor or 1) * consts[name]


@pytest.mark.parametrize(
    "python_name,kernel_value",
    [("MAP_TILE_PIXELS", "kWarp"), ("MAP_GROUP_FRAMES", "kGroup"), ("MAP_CHUNK_FRAMES", "kGroup * kMaxGroups"),
     ("MAP_BLOCKS_AN_SM", "kMinBlocks"), ("MAP_MAX_CLUSTER", "kMaxCluster"), ("MAX_TAPS", "kMaxTaps"),
     ("MAX_LINE_GRAPHS", "kMaxK")],
)
def test_display_map_plan_constants_are_the_kernels(python_name, kernel_value):
    """The wrapper plans the fused entry's cluster from copies of the
    kernel's constants: each copy equals its constants' product in
    csrc/display_map.cu."""
    import re
    from pathlib import Path

    source = (Path(dm.__file__).resolve().parent.parent / "csrc" / "display_map.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", source)}
    assert getattr(dm, python_name) == int(np.prod([consts[name] for name in kernel_value.split(" * ")]))


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


# fractions of a sample at which the rotated weights are most at risk: on a
# sample, a hair either side of it, around the 1e-6 switch to weight 1, at
# the half sample where the nearest sample changes, and just below the next
FRACTIONS = [0.0, 1e-7, -1e-7, 9e-7, 1.1e-6, -1e-6, 1e-5, -1e-5, 0.25, 0.5 - 1e-7, 0.5, 0.5 + 1e-7,
             1.0 - 1e-5, 1.0 - 1e-7, 1.0 - 6e-8]


def _weight_positions():
    """f32 positions: 4001 evenly spaced fractions and FRACTIONS, about
    samples from the left clip range to the end of a 16384-sample row."""
    frac = np.concatenate([np.linspace(0.0, 1.0, 4001), FRACTIONS])
    base = np.array([-11.0, -1.0, 0.0, 3.0, 100.0, 1023.0, 16383.0])
    return torch.from_numpy((base[:, None] + frac[None, :]).astype(np.float32).reshape(-1))


def _weights_three_ways(pos, a):
    """The kernel's weights, the plain version's, and float64's, [N, 2a]."""
    taps = br._tap_positions(pos, a)
    t64 = pos.double()[:, None] - taps.double()
    exact = torch.where(t64.abs() < a, torch.sinc(t64) * torch.sinc(t64 / a), 0.0)
    return br.kernel_lanczos_weights(pos, a), br.plain_lanczos_weights(pos[:, None] - taps, a), exact


@pytest.mark.parametrize("a", [1, 5, 10, 16])
def test_kernel_lanczos_weights_match_the_plain_sinc_products(a):
    """Bound: 5e-7 absolute against the plain version's f32
    ``sinc(t) sinc(t / a)`` (each side is within ~2.5e-7 of the float64
    value: weights reach 1, where an f32 ulp is 1.2e-7, and the rotation's
    ~1e-7 absolute error enters relative to sines of at least
    sin(pi / 2a)). The weight is exactly 1 on a sample, exactly 0 where the
    plain one is (|t| >= a), and no value is NaN."""
    pos = _weight_positions()
    got, plain, exact = _weights_three_ways(pos, a)
    assert got.shape == plain.shape == (pos.numel(), 2 * a) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert float((got - plain).abs().max()) <= 5e-7
    assert float((got.double() - exact).abs().max()) <= 4e-7
    outside = (pos[:, None] - br._tap_positions(pos, a)).abs() >= a
    assert bool(outside.any()) and bool((got[outside] == 0).all())
    on_sample = pos == torch.floor(pos)
    assert bool((got[on_sample, a - 1] == 1).all())
    assert bool((got[on_sample].sum(-1) == 1).all())  # every other tap is exactly 0 there


def test_kernel_lanczos_weights_hold_at_any_position():
    """Any sample, any f32 fraction, any a <= 16: 5e-7 against the plain
    weights and 4e-7 against float64's. A hypothesis property (the package
    is imported here, so the file's other tests need not have it)."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=300, deadline=None, derandomize=True, database=None)
    @hypothesis.given(
        sample=st.integers(min_value=-17, max_value=16400),
        frac=st.floats(min_value=0.0, max_value=1.0, allow_nan=False, width=32),
        a=st.integers(min_value=1, max_value=16),
    )
    def holds(sample, frac, a):
        pos = torch.tensor([np.float32(sample) + np.float32(frac)], dtype=torch.float32)
        got, plain, exact = _weights_three_ways(pos, a)
        assert float((got - plain).abs().max()) <= 5e-7
        assert float((got.double() - exact).abs().max()) <= 4e-7

    holds()


@pytest.mark.parametrize("a", [1, 5, 10, 16])
def test_kernel_lanczos_resample_matches_plain(a):
    """The resample built from the kernel's weights against
    ``banded_resample_plain``: 1e-6 of max|x|, inside the row and off both
    edges (2a weights, each within 5e-7, on samples of random sign)."""
    rng = np.random.default_rng(a)
    x = torch.from_numpy((rng.standard_normal((3, 2, 2048)) * 0.4).astype(np.float32))
    p = np.arange(512, dtype=np.float32)
    pos = np.stack([100.3137 + p * np.float32(0.1249), -(a + 3.3) + p * np.float32(0.8), 2047.0 + a - p * np.float32(0.37)])
    pos = torch.from_numpy(np.clip(pos, -(a + 1.0), 2047.0 + a).astype(np.float32))
    got = br.kernel_lanczos_resample(x, pos, a)
    want = br.banded_resample_plain(x, pos, a=a, kind="lanczos")
    assert got.shape == want.shape == (3, 2, 512)
    assert float((got - want).abs().max()) <= 1e-6 * float(x.abs().max())


@pytest.mark.parametrize("a", [1, 10, 16])
def test_rotation_table_is_float64_rounded_once(a):
    table = br.rotation_table(a)
    assert table.dtype == np.float32 and table.shape == (2 * (a + 1),) and not table.flags.writeable
    assert br.rotation_table(a) is table  # one host array per a, kept alive for the launches
    m = np.arange(a + 1)
    np.testing.assert_array_equal(table[: a + 1], np.cos(np.pi * m / a).astype(np.float32))
    np.testing.assert_array_equal(table[a + 1 :], np.sin(np.pi * m / a).astype(np.float32))
    assert table[0] == 1.0 and table[a + 1] == 0.0 and table[a] == -1.0


# ---------------------------------------------------------------------------
# kernel D (csrc/peak_hold.cu): the walker's states, the helpers' fall and
# rise words, hold scan and fire words, the function entry's stores and the
# fused entry's newest fires, sorting networks and window start, in numpy
# float32 on the CPU
# ---------------------------------------------------------------------------

KD_TILE, KD_QUEUE = 768, 8
F32 = np.float32


def _kd_max(a, b):
    """max.NaN.f32."""
    return F32(np.nan) if np.isnan(a) or np.isnan(b) else max(a, b)


def _kd_walk(x, thr2, st, first):
    """The walker: st over the consumed span, and the st each sample
    starts from; in each tile, the full words two samples at a time
    (``st_pair``: L(L(x)) as max(thr2, (x * decay) * decay)), a tail word's
    samples one at a time. ``falling`` is ``s < st`` (the plain loop takes
    ``s - st < 0``)."""
    decay = F32(0.9999)
    sq = [F32(v) * F32(v) for v in x[first:]]
    before = []
    for base in range(0, len(sq), KD_TILE):
        n = min(KD_TILE, len(sq) - base)
        full = base + 32 * (n // 32)
        for i in range(base, full, 2):
            s0, s1 = sq[i], sq[i + 1]
            m = st * decay
            l1 = _kd_max(thr2, m)
            ll = _kd_max(thr2, m * decay)
            q = _kd_max(thr2, s0 * decay) if bool(s1 < s0) else s1
            st1 = l1 if bool(s0 < st) else s0
            st2 = ((ll if bool(s1 < l1) else s1) if bool(s0 < st) else q)
            before += [st, st1]
            st = st2
        for i in range(full, base + n):
            before.append(st)
            st = _kd_max(thr2, st * decay) if bool(sq[i] < st) else sq[i]
    return st, before


def _kd_fires(x, before, hyst, hold, first):
    """The helpers, a tile at a time: each word's falls and arming rises as
    bit masks, the hold before each word by the last event of the words
    before it, each sample's fire (a fall with the hold before it set: the
    highest event bit below it, else the word's hold), the sample-0 clamp;
    the bools the function entry writes (out[i - 1] = fire[i], then out[W -
    1]) and the newest 8 fire positions the fused entry keeps."""
    w = len(x)
    consumed = w - first
    out = np.ones(w, bool)  # every position must be written
    out[: max(first - 1, 0)] = False
    pos, fire0 = [], 0
    for base in range(0, consumed, KD_TILE):
        n = min(KD_TILE, consumed - base)
        words = (n + 31) // 32
        fall, rise = [0] * words, [0] * words
        for r in range(n):
            s = F32(x[first + base + r]) * F32(x[first + base + r])
            sp = before[base + r]
            falling = bool(s < sp)
            if falling:
                fall[r >> 5] |= 1 << (r & 31)
            elif (s - sp) > hyst * sp:
                rise[r >> 5] |= 1 << (r & 31)
        hold_in = []
        for k in range(words):
            hold_in.append(hold)
            ev = fall[k] | rise[k]
            if ev:
                hold = bool((rise[k] >> (ev.bit_length() - 1)) & 1)
        tile = []
        for k in range(words):
            word = 0
            for lane in range(32):
                below = (fall[k] | rise[k]) & ((1 << lane) - 1)
                held = bool((rise[k] >> (below.bit_length() - 1)) & 1) if below else hold_in[k]
                if (fall[k] >> lane) & 1 and held:
                    word |= 1 << lane
            r = base + 32 * k
            if first == 0 and r == 0:
                fire0 = word & 1
                word = (word & ~1) | ((word & 1) << 1)
            for lane in range(32):
                i = first + r + lane
                if i >= 1 and 32 * k + lane < n:
                    out[i - 1] = bool((word >> lane) & 1)
            tile += [r + b for b in range(32) if (word >> b) & 1]
        pos = (sorted(tile, reverse=True) + pos)[:KD_QUEUE]
    out[w - 1] = w == 1 and first == 0 and bool(fire0)
    return out, hold, pos


def _kd_before(a, b):
    return a < b or (np.isnan(b) and not np.isnan(a))


def _kd_order(v, i, j):
    if _kd_before(v[j], v[i]):
        v[i], v[j] = v[j], v[i]


SORT8 = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7), (1, 2), (5, 6),
         (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5), (1, 2), (3, 4), (5, 6)]
BITONIC8 = [(0, 4), (1, 5), (2, 6), (3, 7), (0, 2), (1, 3), (4, 6), (5, 7), (0, 1), (2, 3), (4, 5), (6, 7)]


def _kd_queue(pos, consumed, ages_in, ns, window, hf):
    """The fused entry's epilogue: the newest fires' ages, the carried ages
    sorted by Batcher's network, the bitonic merge, the window start."""
    fresh = [F32(consumed - p) for p in pos] + [F32(1e9)] * (KD_QUEUE - len(pos))
    old = [a + ns for a in ages_in]
    old = [a if np.isnan(a) else min(a, F32(1e9)) for a in old]
    for i, j in SORT8:
        _kd_order(old, i, j)
    v = [old[7 - q] if _kd_before(old[7 - q], fresh[q]) else fresh[q] for q in range(KD_QUEUE)]
    for i, j in BITONIC8:
        _kd_order(v, i, j)
    half_m1, hf_m1 = window * F32(0.5) - F32(1.0), hf - F32(1.0)
    sel = min([a if (a >= half_m1) & (a < hf) else F32(1e9) for a in v])
    found = sel < F32(1e9)
    start = min(max(hf_m1 - (sel if found else F32(0.0)) - (window - F32(1.0)) * F32(0.5), F32(0.0)), hf - window)
    return v, found, start if found else hf - window


def _kd_rows(rows, w, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(w)
    env = 0.55 + 0.45 * np.sin(2 * np.pi * t / max(w / 3.0, 7.0) + rng.uniform(0, 6.3, (rows, 1)))
    return (env * rng.standard_normal((rows, w))).astype(np.float32)


@pytest.mark.parametrize(
    "w,consumed,ns,hyst,case",
    [
        (2048, 1600, 1600.0, 0.5, "tick"),
        (3100, 3100, 3100.0, 0.0, "five tiles"),
        (3100, 1537, 1536.5, 0.3, "fractional"),
        (1600, 1600, 5000.0, 0.0, "more than the chunk"),
        (1600, 1, 1.0, 0.0, "one sample"),
        (1600, 0, 0.0, 0.5, "none"),
        (33, 33, 33.0, 0.0, "33"),
        (1, 1, 1.0, 0.0, "w1"),
        (2048, 1600, 1600.0, 0.5, "nan"),
        (1600, 1600, 800.0, 0.0, "fall at 0"),
        (1600, 1600, 800.0, 0.5, "quiet"),
    ],
)
def test_peak_hold_words_and_queue_are_the_plain_trigger(w, consumed, ns, hyst, case):
    """Kernel D's walk, fire words, stores and epilogue, modelled as the
    kernel runs them, bit-equal to ``peak_hold_triggers_plain`` (fires, state, holding)
    and ``envelope_hold_trigger_plain`` (ages, found, start), over 3 rows
    and two calls with the state carried: more than 8 fires in a row, no
    fire, a NaN sample, carried ages out of order and full of 1e9, ages that
    pass the history's length."""
    from signalizer_tpu_torch.kernels import peak_hold as ph

    thr, window, hf = 0.1, F32(700.0), F32(3000.0)
    first = w - consumed
    state = torch.full((3,), F32(thr * thr))
    holding = torch.zeros(3, dtype=torch.bool)
    ages = torch.tensor([[1e9] * 8, [2990.0, 5.0, 1e9, 40.0, 1e9, 1e9, 700.0, 1e9], [1e9] * 8], dtype=torch.float32)
    for call in range(2):
        x = _kd_rows(3, w, 40 + call)
        if case == "nan":
            x[1, 1900] = np.nan
        if case == "fall at 0":
            x[:, 0] = 0.01
            state, holding = torch.full((3,), 4.0), torch.ones(3, dtype=torch.bool)
        if case == "quiet":
            x *= 0.01
        if case == "five tiles":
            x[:, 50::100] = 4.0  # a spike every 100 samples rises above the decayed peak and fires
        xt = torch.from_numpy(x)
        fires, st_want, hold_want = ph.peak_hold_triggers_plain(xt, thr, hyst, state, holding, first=first)
        want = ph.envelope_hold_trigger_plain(xt, thr, hyst, state, holding, ages, first=first,
                                              new_samples=ns, window=window, hf=hf)
        for r in range(3):
            st, before = _kd_walk(x[r], F32(thr * thr), F32(state[r]), first)
            out, hold, pos = _kd_fires(x[r], before, F32(hyst), bool(holding[r]), first)
            np.testing.assert_array_equal(out, fires[r].numpy())
            np.testing.assert_array_equal(np.float32(st), st_want[r].numpy())
            assert hold == bool(hold_want[r])
            v, found, start = _kd_queue(pos, consumed, list(ages[r].numpy()), F32(ns), window, hf)
            np.testing.assert_array_equal(np.array(v, np.float32), want[2][r].numpy())
            assert found == bool(want[3][r])
            np.testing.assert_array_equal(np.float32(start), want[4][r].numpy())
        state, holding, ages = want[0], want[1], want[2]
    n_fires = int(fires.sum())
    if case == "five tiles":
        assert int(fires.sum(-1).max()) > 8
    if case == "quiet":
        assert n_fires == 0


def test_peak_hold_pair_step_is_two_steps():
    """``st_pair`` (csrc/peak_hold.cu) against two single steps, bit for
    bit, over 2^20 random states, sample pairs and floors spanning
    denormals to 1e30, with zeros, infinities and NaNs mixed in."""
    rng = np.random.default_rng(12)
    n = 1 << 20
    decay = np.float32(0.9999)

    def draw():
        v = (10.0 ** rng.uniform(-40, 30, n)).astype(np.float32)
        special = rng.random(n)
        v[special < 0.01] = 0.0
        v[(special >= 0.01) & (special < 0.015)] = np.inf
        v[(special >= 0.015) & (special < 0.02)] = np.nan
        return v

    x, s0, s1, thr2 = draw(), draw(), draw(), draw()
    thr2[rng.random(n) < 0.3] = np.float32(0.01)
    near = rng.random(n) < 0.3  # states and samples close together, floors near the decayed state
    s0[near] = x[near] * np.float32(0.99995)
    s1[near] = x[near] * np.float32(0.9998)
    thr2[near] = x[near] * np.float32(0.99985)

    def maxnan(a, b):
        return np.where(np.isnan(a) | np.isnan(b), np.float32(np.nan), np.maximum(a, b))

    def step(st, s):
        return np.where(s < st, maxnan(thr2, st * decay), s)

    with np.errstate(invalid="ignore", over="ignore"):
        want1 = step(x, s0)
        want2 = step(want1, s1)
        m = x * decay
        l1 = maxnan(thr2, m)
        ll = maxnan(thr2, m * decay)
        q = np.where(s1 < s0, maxnan(thr2, s0 * decay), s1)
        st1 = np.where(s0 < x, l1, s0)
        st2 = np.where(s0 < x, np.where(s1 < l1, ll, s1), q)
    np.testing.assert_array_equal(st1, want1)
    np.testing.assert_array_equal(st2, want2)


# ---------------------------------------------------------------------------
# kernel E (csrc/colour_track.cu): the colour track's chunked scans
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """float32 fused multiply-add: the product is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _madd(m, o, v):
    """v + M o in float32 FMAs as csrc/colour_track.cu's madd orders them;
    m [..., d, d], o and v [..., d], d = 2 (a biquad) or 1 (a one-pole)."""
    if v.shape[-1] == 1:
        return _fma(m[..., 0, 0], o[..., 0], v[..., 0])[..., None]
    return np.stack([_fma(m[..., 0, 0], o[..., 0], _fma(m[..., 0, 1], o[..., 1], v[..., 0])),
                     _fma(m[..., 1, 0], o[..., 0], _fma(m[..., 1, 1], o[..., 1], v[..., 1]))], -1)


class KernelE:
    """numpy model of kernel E's arithmetic for ``chunk`` samples a thread,
    ``threads`` threads a block and a row split across ``cluster`` blocks
    (at most 32 warps in all), reading the table the wrapper builds for that
    chunk (every power formed in float64, rounded once): each thread runs
    its chunk from a zero state (the tile's first thread from its carry);
    the chunks' end states are scanned over lanes with A^(chunk d), then the
    ends of the cluster's warps, block after block, with A^(32 chunk 2^k);
    each sample is fixed up with A^j (A^(j + 1) for the one-pole's output
    and every end state) times the state its chunk starts from; tiles of
    cluster x segment samples carry each recurrence's state."""

    def __init__(self, fs, pole, chunk, threads, cluster=1):
        self.chunk, self.threads, self.cluster = chunk, threads, cluster
        self.warps = threads // 32
        assert cluster * self.warps <= ct.CLUSTER_WARPS
        table = ct.host_table(fs, pole=pole, chunk=chunk)
        n = len(ct.exponents(chunk))
        self.sets = []
        for i in range(4):
            blk = table[i * (8 + 4 * n) : (i + 1) * (8 + 4 * n)]
            self.sets.append((blk[:8],) + self._split(blk[8:].reshape(-1, 2, 2)))
        p = table[4 * (8 + 4 * n) :]
        self.pole = (p[:4],) + self._split(p[4:].reshape(-1, 1, 1))

    def _split(self, mats):
        """(fix-ups, lanes, steps)"""
        c = self.chunk
        return mats[:c], mats[c : c + 32], mats[c + 32 :]

    def scan(self, e, lanes, steps):
        """e [B, cluster x threads, d]: each chunk's end from its own start
        -> the state each chunk starts from, and the tile's end state."""
        b, t, d = e.shape
        n = self.cluster * self.warps
        e = e.reshape(b, n, 32, d)
        for k in range(5):
            s = 1 << k
            e = np.concatenate([e[:, :, :s], _madd(lanes[s], e[:, :, :-s], e[:, :, s:])], 2)
        q = e[:, :, 31]  # [B, cluster's warps, d]
        for k in range(int(np.ceil(np.log2(n)))):
            s = 1 << k
            q = np.concatenate([q[:, :s], _madd(steps[k], q[:, :-s], q[:, s:])], 1)
        prefix = np.concatenate([np.zeros_like(q[:, :1]), q[:, :-1]], 1)  # entering each warp
        c = np.concatenate([np.zeros_like(e[:, :, :1]), e[:, :, :-1]], 2)
        c = _madd(lanes[None, None], prefix[:, :, None], c)
        return c.reshape(b, t, d), q[:, -1]

    def section(self, v, which, carry, je):
        """A biquad on the tile v [B, threads, chunk] in place; returns the
        tile's end state and the row's end state (None outside its tile)."""
        coef, pw, lanes, steps = self.sets[which]
        a00, a10, bv0, bv1, b0 = coef[0], coef[2], coef[4], coef[5], coef[6]
        s0 = np.zeros(v.shape[:2], np.float32)
        s1 = np.zeros_like(s0)
        s0[:, 0], s1[:, 0] = carry[:, 0], carry[:, 1]
        ends = np.zeros(v.shape[:2] + (2,), np.float32)
        for j in range(self.chunk):
            x = v[:, :, j].copy()
            v[:, :, j] = _fma(b0, x, s0)
            s0, s1 = _fma(a00, s0, _fma(bv0, x, s1)), _fma(a10, s0, bv1 * x)
            ends[:, je == j] = np.stack([s0, s1], -1)[:, je == j]
        c, tile_end = self.scan(np.stack([s0, s1], -1), lanes, steps)
        v[:, :, 0] = v[:, :, 0] + c[..., 0]
        for j in range(1, self.chunk):
            v[:, :, j] = _fma(pw[j - 1, 0, 0], c[..., 0], _fma(pw[j - 1, 0, 1], c[..., 1], v[:, :, j]))
        end = None
        holds = (je >= 0) & (je < self.chunk)
        if holds.any():
            t = int(np.argmax(holds))
            end = _madd(pw[je[t]], c[:, t], ends[:, t])
        return tile_end, end

    def smooth(self, v, carry, je):
        """The one-pole on v's squares in place; as :meth:`section`."""
        coef, pw, lanes, steps = self.pole
        p, q = coef[0], coef[1]
        s = np.zeros(v.shape[:2], np.float32)
        s[:, 0] = carry
        for j in range(self.chunk):
            s = _fma(p, s, (v[:, :, j] * v[:, :, j]) * q)
            v[:, :, j] = s
        c, tile_end = self.scan(s[..., None], lanes, steps)
        for j in range(self.chunk):
            v[:, :, j] = _fma(pw[j, 0, 0], c[..., 0], v[:, :, j])
        holds = (je >= 0) & (je < self.chunk)
        end = v[:, int(np.argmax(holds)), je[np.argmax(holds)]] if holds.any() else None
        return tile_end[..., 0], end

    def run(self, x, z, s):
        """x [B, W], z [B, 8, 2], s [B, 3] -> bands [B, 3, W], smoothed
        band energies [B, 3, W], z and s out."""
        b, w = x.shape
        threads = self.cluster * self.threads  # the tile's threads, block after block
        tile = self.chunk * threads
        carry, scarry = z.astype(np.float32).copy(), s.astype(np.float32).copy()
        z_out, s_out = np.zeros_like(carry), np.zeros_like(scarry)
        n = -(-w // tile) * tile
        bands, smoothed = np.zeros((b, 3, n), np.float32), np.zeros((b, 3, n), np.float32)
        xp = np.zeros((b, n), np.float32)
        xp[:, :w] = x
        for base in range(0, w, tile):
            je = (w - 1 - base) - np.arange(threads) * self.chunk
            xt = xp[:, base : base + tile].reshape(b, threads, self.chunk).copy()
            lo = xt.copy()
            mid = None
            for sec, v in ((0, lo), (1, lo), (2, xt), (3, xt), (4, None), (5, None), (6, xt), (7, xt)):
                if sec == 4:
                    mid = xt.copy()
                v = mid if v is None else v
                carry[:, sec], end = self.section(v, sec // 2, carry[:, sec], je)
                if end is not None:
                    z_out[:, sec] = end
            for k, v in enumerate((lo, mid, xt)):
                bands[:, k, base : base + tile] = v.reshape(b, -1)
                scarry[:, k], end = self.smooth(v, scarry[:, k], je)
                smoothed[:, k, base : base + tile] = v.reshape(b, -1)
                if end is not None:
                    s_out[:, k] = end
        return bands[..., :w], smoothed[..., :w], z_out, s_out


def _colour_model_against_the_oracle(fs, chunk, threads, w, cluster=1):
    """Kernel E's model on three rows (tones and noise, a silent one) from
    carried states: bands, smoothed energies and every end state within 2x
    the plain doubling scans' own distance from the float64 chain (each
    measured here on the same input); the silent row exactly zero."""
    rng = np.random.default_rng(w + chunk + cluster)
    n = np.arange(w)
    x = np.stack([0.4 * np.sin(2 * np.pi * f * n / fs) + 0.05 * rng.standard_normal(w)
                  for f in (110.0, 1300.0, 7000.0)]).astype(np.float32)
    x[2] = 0.0  # a silent row
    z = (rng.standard_normal((3, 8, 2)) * 0.01).astype(np.float32)
    z[2] = 0.0
    s = (rng.random((3, 3)) * 0.01).astype(np.float32)
    s[2] = 0.0
    pole = float(np.exp(-1.0 / (10e-3 * fs)))
    bands, smoothed, z_out, s_out = KernelE(fs, pole, chunk, threads, cluster).run(x, z, s)
    ref = ct.float64_reference(x, fs, z, pole, s, np.eye(3), np.zeros((3, 3)), 1.0)
    want = (ref[0], ref[2], ref[1], ref[2][..., -1])  # bands, smoothed, z, smoothing state
    plain_bands, plain_z = ct.three_band_split_plain(torch.from_numpy(x), fs, state=tf.CrossoverState(torch.from_numpy(z)))
    plain_sm = tf.onepole_smooth(plain_bands * plain_bands, torch.tensor(np.float32(pole)), torch.from_numpy(s))
    plain = (plain_bands.numpy(), plain_sm.numpy(), plain_z.z.numpy(), plain_sm[..., -1].numpy())
    for name, got, ref, w64 in zip(("bands", "smoothed", "z", "smooth state"), (bands, smoothed, z_out, s_out),
                                   plain, want):
        err = float(np.abs(got - w64).max())
        plain_err = float(np.abs(ref - w64).max())
        assert err <= 2 * plain_err, (name, err, plain_err)
    # the silent row stays exactly zero
    assert not bands[2].any() and not smoothed[2].any() and not z_out[2].any() and not s_out[2].any()


@pytest.mark.parametrize("fs", [48_000.0, 96_000.0])
@pytest.mark.parametrize("chunk,threads,w", [(16, 512, 16384), (16, 512, 3001), (4, 64, 3001),
                                             (32, 128, 5000), (8, 256, 2047)])
def test_colour_track_chunked_scan_holds_the_float64_oracle(fs, chunk, threads, w):
    """Kernel E's chunked scans (the model above) in one block a row, at
    several chunk lengths and block sizes, W a multiple of the tile and not
    a multiple of the chunk, from carried states: bands, smoothed energies
    and every end state within 2x the plain doubling scans' own distance
    from the float64 chain (each measured here on the same input)."""
    _colour_model_against_the_oracle(fs, chunk, threads, w)


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("segments", [1.0, 0.7, 2.4])
def test_colour_track_cluster_scan_holds_the_float64_oracle(cluster, segments):
    """The same with a row split across ``cluster`` blocks of 32 threads (a
    segment of 512 samples each), W the cluster's span times ``segments``:
    a whole span, a row that leaves blocks idle or short, and a row walked
    in three tiles; at 96 kHz, within the same bound."""
    w = int(round(cluster * 32 * ct.CHUNK * segments))
    _colour_model_against_the_oracle(96_000.0, ct.CHUNK, 32, w, cluster)


def test_colour_plan_covers_the_card():
    """The plan spreads few long rows over many SMs: cfg3's 32 rows of 16384
    samples take 8 blocks of 128 threads a row (256 blocks), a coloured
    session's 2 rows 8 blocks of 128 (16 blocks); a row that fits one
    block's segment (8192 samples) takes one block, the fewest threads
    covering it: 6 rows of 3001 samples one block of 256. A cluster never
    has more than 32 warps, and the cluster's span covers the row where 32
    warps can (16384 samples), else it is walked in tiles."""
    assert ct.colour_plan(32, 16384, 132) == (128, 8)
    assert ct.colour_plan(2, 16384, 132) == (128, 8)
    assert ct.colour_plan(6, 3001, 132) == (256, 1)
    assert ct.colour_plan(2, 8192, 132) == (512, 1)
    assert ct.colour_plan(2, 8193, 132) == (128, 8)
    assert ct.colour_plan(4, 100, 132) == (32, 1)
    for rows, w in ((1, 1), (3, 700), (33, 16384), (2, 200_000), (256, 4096), (1, 100_000)):
        threads, cluster = ct.colour_plan(rows, w, 132)
        assert 1 <= cluster <= ct.PLAN_CLUSTER <= ct.MAX_CLUSTER
        assert 32 <= threads <= ct.THREADS and threads & (threads - 1) == 0
        assert cluster * threads // 32 <= ct.CLUSTER_WARPS
        assert cluster == 1 or w > ct.THREADS * ct.CHUNK
        span = cluster * threads * ct.CHUNK
        assert span >= w or 2 * threads > min(ct.THREADS, ct.CLUSTER_WARPS // cluster * 32)


# ---------------------------------------------------------------------------
# kernel G (csrc/phase_decay_db.cu): the PHASE tail, T split into chunks
# ---------------------------------------------------------------------------


def _phase_walk(vals, s, ph, pole, pp, valid, t0, t1):
    """Kernel G's walk over frames [t0, t1) of ``vals`` [pairs, T, 2, P]
    from (s, ph) [pairs, K, P], each operation rounded on its own as the
    kernel's: returns the state after each frame, stacked [pairs, n, K, P]."""
    ss, phs = [], []
    for t in range(t0, t1):
        m = vals[:, t, 0][:, None] * 0.5
        tgt = vals[:, t, 1][:, None] * m
        s_new = torch.maximum(pole * s, m)
        ph_new = tgt + pp * (ph - tgt)
        if valid is None or valid[t]:
            s, ph = s_new, ph_new
        ss.append(s)
        phs.append(ph)
    return torch.stack(ss, 1), torch.stack(phs, 1)


def phase_plan_model(c, state, vals, valid, frames):
    """Kernel G's two passes, as the kernel lays them out, T in chunks of
    ``frames``: the walk pass writes chunk 0's start from the state, then
    walks frames [0, (chunks - 1) frames) in stages of WALK_FRAMES and
    writes chunk c's start at the end of the stage that ends at c frames;
    the mapping pass walks each chunk again from its start, and its last
    chunk's end is the new state. Returns (s, ph) [pairs, T, K, P] and the
    end (s, ph)."""
    t = vals.shape[1]
    chunks = 1 if frames >= t else -(-t // frames)
    pole, pp = c.decay_poles[:, None], pd.phase_poles(c)
    s, ph = state.magnitude[:, :, 0], state.phase
    starts = [(s, ph)]
    for st in range((chunks - 1) * frames // pd.WALK_FRAMES if chunks > 1 else 0):
        ss, phs = _phase_walk(vals, s, ph, pole, pp, valid, st * pd.WALK_FRAMES, (st + 1) * pd.WALK_FRAMES)
        s, ph = ss[:, -1], phs[:, -1]
        if (st + 1) * pd.WALK_FRAMES % frames == 0:
            starts.append((s, ph))
    assert len(starts) == chunks
    runs = [_phase_walk(vals, *starts[i], pole, pp, valid, i * frames, min(t, (i + 1) * frames))
            for i in range(chunks)]
    s_all, ph_all = torch.cat([r[0] for r in runs], 1), torch.cat([r[1] for r in runs], 1)
    return s_all, ph_all, s_all[:, -1], ph_all[:, -1]


def kernel_db(c, v):
    """Kernel G's dB map: the product by slope / lower, formed once a pixel."""
    lower, dyr, clip = (float(x) for x in c.display_scalars[1:4])
    x = v * (c.slope_map / torch.tensor(lower, dtype=torch.float32))
    return torch.where(x > 0, torch.log(torch.clamp(x, min=1e-38)) * dyr, torch.tensor(clip))


PHASE_MODEL_CASES = [
    (t, frames, mask, (1, 2, 11)[i % 3])
    for i, (t, frames, mask) in enumerate(
        (t, frames, mask) for t in (1, 7, 128, 512) for frames in (None, 32, 64, 96)
        for mask in (None, "last", "some") if frames is None or frames < t
    )
]


@pytest.mark.parametrize("t,frames,mask,k", PHASE_MODEL_CASES)
def test_phase_plan_model_is_bit_equal_to_the_plain_loop(t, frames, mask, k):
    """Kernel G's walk-then-map plan (the model above: chunk starts from a
    walk, each chunk walked again from its start) against
    ``phase_decay_db_plain``: every frame's (s, ph) mapped by the plain dB
    map bit for bit equal to the plain tail's display, both states bit-equal;
    the kernel's dB map (slope / lower formed once) within 1e-5 of it."""
    p, pairs = 40, 2
    c = make_spectrum_constant(axis_points=p, window_size=256, configuration=SpectrumChannels.PHASE,
                               view_scaling=ViewScaling.LOGARITHMIC, num_line_graphs=k, device="cpu")
    rng = np.random.default_rng(t + k)
    mid = np.abs(rng.standard_normal((pairs, t, p))) * 0.3
    vals = torch.from_numpy(np.stack([mid, rng.random((pairs, t, p))], -2).astype(np.float32))
    mag = torch.from_numpy((rng.random((pairs, k, 2, p)) * 0.05).astype(np.float32))
    phase = torch.from_numpy((rng.random((pairs, k, p)) * 0.05).astype(np.float32))
    valid = None
    if mask == "last":
        valid = np.ones(t, bool)
        valid[-3:] = False
    elif mask == "some":
        valid = rng.random(t) > 0.3
    plain = ts.LineGraphState(mag.clone(), phase.clone())
    want = pd.phase_decay_db_plain(c, plain, vals, valid)
    s, ph, s_end, ph_end = phase_plan_model(c, ts.LineGraphState(mag, phase), vals, valid,
                                            t if frames is None else frames)
    got = torch.stack([_db_map(c, s), _db_map(c, ph)], -2)  # [pairs, T, K, 2, P]
    assert torch.equal(got, want)
    assert torch.equal(s_end, plain.magnitude[:, :, 0]) and torch.equal(ph_end, plain.phase)
    kernel = torch.stack([kernel_db(c, s), kernel_db(c, ph)], -2)
    torch.testing.assert_close(kernel, want, rtol=0, atol=1e-5)


def test_phase_plan_covers_the_card():
    """The headline (16 pairs x 128 frames x 1024 px, K = 2) is one chunk:
    32 tiles x 16 pairs = 512 blocks, two or more an SM of 132; the
    spectrogram's cfg4 (1 pair x 512 frames) takes 16 chunks of 32 frames,
    32 x 16 = 512 blocks; T = 1 one chunk; 11 line graphs take two groups."""
    assert pd.phase_plan(16, 128, 2, 1024, 132) == (128, 1)
    assert pd.phase_plan(1, 512, 2, 1024, 132) == (32, 16)
    assert pd.phase_plan(16, 1, 2, 1024, 132) == (1, 1)
    assert pd.phase_plan(2, 33, 11, 200, 132) == (33, 1)
    for pairs, t in ((16, 128), (1, 512)):
        frames, chunks = pd.phase_plan(pairs, t, 2, 1024, 132)
        assert -(-1024 // pd.TILE) * pairs * chunks >= 2 * 132


@pytest.mark.parametrize("python_name,kernel_name", [("TILE", "kTile"), ("GROUP", "kGroup"),
                                                     ("WALK_FRAMES", "kWalkFrames")])
def test_phase_plan_constants_are_the_kernels(python_name, kernel_name):
    """The wrapper plans kernel G's layout from copies of the kernel's
    constants: each copy equals its constant in csrc/phase_decay_db.cu."""
    import re
    from pathlib import Path

    source = (Path(pd.__file__).resolve().parent.parent / "csrc" / "phase_decay_db.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", source)}
    assert getattr(pd, python_name) == consts[kernel_name]


# ---------------------------------------------------------------------------
# kernel F's spectrum load stage (csrc/spectral_walk.cu)
# ---------------------------------------------------------------------------


def _walk_constants():
    import re
    from pathlib import Path

    from signalizer_tpu_torch.kernels import spectral_walk as sw

    source = (Path(sw.__file__).resolve().parent.parent / "csrc" / "spectral_walk.cu").read_text()
    return {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", source)}


def spectrum_load_model(n, rows, row_entries):
    """The spectrum stage of kernel F as a numpy model, for rows of a
    contiguous complex64 tensor [rows, row_entries] whose first row starts
    on a 16-byte boundary. Per row: the block's threads and walkers, the
    16-byte chunks each thread loads (as entry indices: the chunk's first
    entry, -1 where an odd row starts 8 bytes past a boundary), the thread
    that forms each bin's magnitude, the staged slots read for a bin's
    offset (its neighbours) and the walker slot that holds each candidate.
    Mirrors sig_spectral_walk_spectrum's plan and the kernel's index
    arithmetic."""
    k = _walk_constants()
    pow2 = lambda v: 1 << max(int(v) - 1, 0).bit_length()  # noqa: E731
    m = max(n // 2 - 2, 0)
    entries = m + 3
    chunks_max = (entries + 2) // 2
    walkers = max(32, pow2(-(-m // k["kSlots"])))
    threads = min(max(pow2((chunks_max + 1) // 2), walkers), k["kMaxThreads"])
    assert walkers <= threads <= k["kMaxThreads"] and k["kLoadChunks"] * threads >= chunks_max
    out = []
    for r in range(rows):
        start = r * row_entries  # the row's first entry, in complex entries from the base
        s = start & 1  # 8 bytes past a 16-byte boundary
        chunks = (entries + s + 1) >> 1
        loads = {}  # thread -> [first entry of each chunk it loads]
        formed = {}  # bin -> thread that forms |X|
        staged = np.zeros(2 * chunks_max, bool)
        for t in range(threads):
            for b in range(0, k["kLoadChunks"], k["kLoadBatch"]):
                if t + b * threads >= chunks:
                    break
                for i in range(k["kLoadBatch"]):
                    c = t + (b + i) * threads
                    if c >= chunks:
                        continue
                    assert (start - s + 2 * c) * 8 % 16 == 0  # a 16-byte aligned load
                    loads.setdefault(t, []).append(2 * c - s)
                    staged[2 * c : 2 * c + 2] = True
                    for e in (2 * c - s, 2 * c + 1 - s):
                        if 1 <= e <= m + 1:
                            assert e not in formed
                            formed[e] = t
        neighbours = {j: [j - 1 + s, j + s, j + 1 + s] for j in range(1, m + 2)}
        held = {}  # candidate bin -> (walker, slot)
        for t in range(walkers):
            for slot in range(k["kSlots"]):
                j = 2 + t + slot * walkers
                if j <= m + 1:
                    assert j not in held
                    held[j] = (t, slot)
        out.append(dict(s=s, threads=threads, walkers=walkers, chunks=chunks, loads=loads, formed=formed,
                        neighbours=neighbours, staged=staged, held=held))
    return out


@pytest.mark.parametrize("rows", [1, 16, 33])
@pytest.mark.parametrize("n", [8192, 1024])
def test_spectral_walk_spectrum_load_stage(n, rows):
    """Kernel F's spectrum stage on an rfft [rows, n / 2 + 1] complex64:
    every bin 1 .. n/2 - 1 has its magnitude formed exactly once, by the
    thread that loaded the bin's chunk; each bin's offset reads the staged
    slots of entries j - 1, j, j + 1, all loaded; an odd row (its start 8
    bytes past a 16-byte boundary) loads from entry -1, an even one from
    entry 0; no load starts past the 16-byte block that holds entry n / 2;
    every candidate bin 2 .. n/2 - 1 is held by exactly one walker's slot,
    bins rising along a walker's slots; the staged slots fit the shared
    memory the entry asks for."""
    half = n // 2
    for r, row in enumerate(spectrum_load_model(n, rows, half + 1)):
        assert row["s"] == (r * (half + 1)) % 2
        assert sorted(row["formed"]) == list(range(1, half))
        first = min(e for loads in row["loads"].values() for e in loads)
        assert first == -row["s"]
        last = max(e for loads in row["loads"].values() for e in loads)
        assert last <= half <= last + 1  # the last chunk holds entry n / 2
        for j, slots in row["neighbours"].items():
            assert [sl - row["s"] for sl in slots] == [j - 1, j, j + 1]
            assert all(row["staged"][sl] for sl in slots)
        for j, t in row["formed"].items():
            assert (j + row["s"]) // 2 % row["threads"] == t  # the thread that loaded the bin's chunk
        assert sorted(row["held"]) == list(range(2, half))
        for t in range(row["walkers"]):
            bins = [j for j, (w, _) in sorted(row["held"].items(), key=lambda kv: kv[1][1]) if w == t]
            assert bins == sorted(bins)
        assert (row["threads"], row["walkers"]) == ((1024, 256) if n == 8192 else (256, 32))
        assert 8 * len(row["staged"]) == 16 * ((half + 3) // 2)


@pytest.mark.parametrize("n", [16389, 16384, 10000])
def test_spectral_walk_spectrum_plan_stages_the_largest_rows(n):
    """Up to the largest lookahead the kernel takes (n = 16389, MAX_BINS
    candidates) the plan's 1024 threads stage an rfft row [n // 2 + 1] in
    at most kLoadChunks chunks a thread, the largest taking all of them;
    every bin is formed once and every candidate held by one of 512
    walkers, odd rows included."""
    k = _walk_constants()
    half = n // 2
    for row in spectrum_load_model(n, 2, half + 1):
        assert (row["threads"], row["walkers"]) == (1024, 512)
        assert sorted(row["formed"]) == list(range(1, half)) and sorted(row["held"]) == list(range(2, half))
        most = max(len(v) for v in row["loads"].values())
        assert most <= k["kLoadChunks"] and (n != 16389 or most == k["kLoadChunks"])


# ---------------------------------------------------------------------------
# the PHASE values kernel (csrc/phase_values.cu): a pixel's taps or its walk
# ---------------------------------------------------------------------------


def _cabs(re, im):
    """|z| of float32 parts, as torch's complex abs takes it."""
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).abs().numpy()


# csrc/phase_values.cu's kWarp
PV_WARP = 32


def pv_lanes(longest):
    """csrc/phase_values.cu ``lanes_for``: the lanes that walk a pixel's
    chunk, the fewest (a power of two, at most a warp) that leave a lane at
    most a warp's width of the plan's longest chunk."""
    lanes = 1
    while lanes < PV_WARP and longest > PV_WARP * lanes:
        lanes *= 2
    return lanes


def _first_max(v, best):
    """Where the walk's ``v`` takes over from ``best``: greater, or a NaN
    over a number (csrc/phase_values.cu ``beats``)."""
    return (v > best) | (np.isnan(v) & ~np.isnan(best))


def lane_walk(power, lo, length, lanes):
    """The kernel's walk of each bin-max pixel's chunk: lane ``k`` of the
    pixel's ``lanes`` keeps the first maximum of bins k, k + lanes, ... of
    its chunk (its batched loads compare in bin order), then a butterfly of
    shuffles (partners lanes / 2, ..., 1 apart) keeps the larger, or the
    lower bin where neither beats the other. ``power`` [F, nv], ``lo`` and
    ``length`` (at least 1) [n] -> the bins [F, n], as every lane ends."""
    f, n = power.shape[0], len(lo)
    best = np.full((f, n, lanes), -np.inf, np.float32)
    at = np.broadcast_to(length[None, :, None], (f, n, lanes)).copy()  # no bin: past the chunk
    ks = np.arange(lanes)
    for step in range(-(-int(length.max(initial=1)) // lanes)):
        j = ks[None, :] + step * lanes  # [1, lanes]
        k = np.minimum(lo[:, None] + j, power.shape[1] - 1)  # [n, lanes]
        v = power[:, k]
        take = (j < length[:, None])[None] & _first_max(v, best)
        best, at = np.where(take, v, best), np.where(take, j, at)
    o = lanes // 2
    while o:
        vb, bb = best[..., ks ^ o], at[..., ks ^ o]
        take = _first_max(vb, best) | (~_first_max(best, vb) & (bb < at))
        best, at = np.where(take, vb, best), np.where(take, bb, at)
        o //= 2
    assert (at == at[..., :1]).all()  # every lane holds the pixel's winner
    return lo[None, :] + at[..., 0]


def phase_values_model(constant, spec, lanes=None):
    """csrc/phase_values.cu's per-pixel arithmetic in numpy float32, on
    ``spec`` [F, 2, nv] complex64, every frame of a pixel at once. An
    interpolation pixel sums its taps in tap order from 0, each product
    rounded before its sum. A bin-max pixel finds its chunk's first maximum
    of max(|L|, |R|) (a single-bin pixel its one bin) by :func:`lane_walk`
    with the kernel's lanes for the plan (``lanes`` None) or the lanes
    given, and takes that bin's L and R. The magnitudes the walk compares
    are torch's abs of the whole spectrum, as the plain path takes them.
    Returns (values [F, 2, P], the walk's bins [F, P] (-1 on interpolation
    pixels), the winners' L and R [F, P] complex64)."""
    c = constant
    f32 = np.float32
    if lanes is None:
        lanes = pv_lanes(c.band_idx.shape[-1])
    spec = spec.numpy()
    f, nv, p = spec.shape[0], spec.shape[-1], c.axis_points
    re, im = spec.real.astype(f32), spec.imag.astype(f32)
    mags = torch.from_numpy(spec).abs().numpy()
    a, b = mags[:, 0], mags[:, 1]
    power = np.where(np.isnan(a) | (a > b), a, b)
    inv = f32(c.inv_size)
    interp, single = c.interp_mask.numpy(), c.single_mask.numpy()
    mid, cancel = np.zeros((f, p), f32), np.zeros((f, p), f32)

    def cancellation(sre, sim, m):
        num = inv * _cabs(sre, sim)
        return f32(1) - np.where(m > 0, num / np.maximum(m, f32(1e-30)), f32(0))

    ip = np.nonzero(interp)[0]
    ilr, ili, irr, iri, ml, mr = (np.zeros((f, len(ip)), f32) for _ in range(6))
    for j in range(c.interp_taps):  # tap order
        at, w = c.interp_indices.numpy()[ip, j], c.interp_weights.numpy()[ip, j]
        ilr, ili = ilr + re[:, 0, at] * w, ili + im[:, 0, at] * w
        irr, iri = irr + re[:, 1, at] * w, iri + im[:, 1, at] * w
        ml, mr = ml + mags[:, 0, at] * w, mr + mags[:, 1, at] * w
    mid[:, ip] = inv * (ml + mr)
    cancel[:, ip] = cancellation(ilr + irr, ili + iri, inv * (_cabs(ilr, ili) + _cabs(irr, iri)))

    bp = np.nonzero(~interp)[0]
    lo = np.where(single[bp], c.single_bin.numpy()[bp], c.chunk_lo.numpy()[bp]).astype(np.int64)
    length = np.maximum(np.where(single[bp], 1, c.chunk_len.numpy()[bp]), 1)
    at = lane_walk(power, lo, length, lanes)
    lr, li, rr, ri = (np.take_along_axis(x, at, axis=1) for x in (re[:, 0], im[:, 0], re[:, 1], im[:, 1]))
    m = inv * (_cabs(lr, li) + _cabs(rr, ri))
    mid[:, bp] = m
    cancel[:, bp] = cancellation(lr + rr, li + ri, m)
    bins = np.full((f, p), -1, np.int64)
    bins[:, bp] = at
    left, right = np.zeros((f, p), np.complex64), np.zeros((f, p), np.complex64)
    left[:, bp], right[:, bp] = lr + 1j * li, rr + 1j * ri
    return np.stack([mid, cancel], axis=1), bins, left, right


PHASE_VALUE_PLANS = [
    (window, scaling, interp)
    for window in (4096, 65536, 1 << 21)
    for scaling in (ViewScaling.LOGARITHMIC, ViewScaling.LINEAR)
    for interp in (BinInterpolation.NONE, BinInterpolation.LINEAR, BinInterpolation.LANCZOS)
]


def _assert_model_is_the_plain_path(c, spec, lanes=None):
    got, bins, left, right = phase_values_model(c, spec, lanes)
    want = ts.phase_values_plain(c, spec).numpy()
    mags = spec.abs()
    argbin = ts._binmax_argbin(torch.maximum(mags[..., 0, :], mags[..., 1, :]), c).numpy()
    bp = ~c.interp_mask.numpy()
    assert bool(bp.any())
    np.testing.assert_array_equal(bins[:, bp], argbin[:, bp])
    idx = torch.from_numpy(argbin)
    np.testing.assert_array_equal(left[:, bp], torch.gather(spec[..., 0, :], -1, idx).numpy()[:, bp])
    np.testing.assert_array_equal(right[:, bp], torch.gather(spec[..., 1, :], -1, idx).numpy()[:, bp])
    # the sums and quotients round alike; torch's CPU abs may take the
    # other of two roundings of |z| by where z sits in its vector, so the
    # values are held within a few ulps (a Lanczos tap sum in torch's own
    # order: 1e-6 of the row's largest)
    scale = 1e-6 * float(np.abs(want[:, 0]).max()) if c.interp_taps > 2 else 0.0
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=4e-7, atol=scale)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-6)
    return got, bins, argbin


@pytest.mark.parametrize("window,scaling,interp", PHASE_VALUE_PLANS,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_phase_values_model_is_the_plain_path(window, scaling, interp):
    """The kernel's walk picks the plain path's argbin and carries the
    plain path's gathered L and R bit for bit, on every plan kind (NONE,
    LINEAR and Lanczos taps; LOGARITHMIC and LINEAR axes) and on chunks up
    to a 2^21-point plan's 7948 bins, with exact ties planted in every chunk
    (the first maximum wins), a silent frame (mid 0, cancellation 1) and a
    frame with a silent right channel (cancellation 0)."""
    c = make_spectrum_constant(axis_points=1024, window_size=window, configuration=SpectrumChannels.PHASE,
                               bin_interpolation=interp, view_scaling=scaling, device="cpu")
    frames = 4 if window < (1 << 21) else 3
    spec = phase_spectra(c, frames, seed=window % 97 + int(scaling) + 3 * int(interp), plant=True)
    got, bins, argbin = _assert_model_is_the_plain_path(c, spec)
    assert np.all(got[1, 0] == 0) and np.all(got[1, 1] == 1)
    assert np.all(got[2, 1] == 0)
    longest = int(c.chunk_len.max())
    assert longest == {4096: (16, 3), 65536: (249, 33), 1 << 21: (7948, 1026)}[window][scaling == ViewScaling.LINEAR]
    assert c.band_idx.shape[-1] == longest  # what picks the kernel's lanes a pixel
    assert pv_lanes(longest) == {16: 1, 3: 1, 249: 8, 33: 2, 7948: 32, 1026: 32}[longest]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_phase_values_every_lane_count_is_the_plain_path(lanes):
    """Every lane count the kernel can take a pixel with finds the plain
    path's bins on a 65536-point plan (chunks of 1 to 249 bins, ties
    planted in each), whichever the plan picks."""
    c = make_spectrum_constant(axis_points=1024, window_size=65536, configuration=SpectrumChannels.PHASE,
                               view_scaling=ViewScaling.LOGARITHMIC, device="cpu")
    spec = phase_spectra(c, 3, seed=40 + lanes, plant=True)
    got, _, _ = _assert_model_is_the_plain_path(c, spec, lanes)
    assert np.all(got[1, 0] == 0) and np.all(got[1, 1] == 1)


def test_phase_values_lanes_rule_is_the_kernels():
    """``pv_lanes`` is csrc/phase_values.cu's ``lanes_for``, read from the
    source: the same loop on the same bound."""
    from pathlib import Path

    from signalizer_tpu_torch.kernels import phase_values as pv

    source = (Path(pv.__file__).resolve().parent.parent / "csrc" / "phase_values.cu").read_text()
    assert "while (lanes < kWarp && longest > kWarp * lanes) lanes *= 2;" in source
    assert "constexpr int kWarp = 32;" in source
    assert [pv_lanes(n) for n in (1, 32, 33, 64, 65, 128, 129, 256, 257, 512, 513, 10**6)] == \
        [1, 1, 2, 2, 4, 4, 8, 8, 16, 16, 32, 32]


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("lanes", [2, 8, 32])
def test_phase_values_lane_walk_keeps_the_lowest_bin_on_ties(lanes, seed):
    """The lane split's combine on values drawn from a handful of levels (so
    most chunks tie for their maximum, often in lanes below the first
    maximum's), with NaNs in some chunks: the first maximum, the first NaN
    where there is one, as torch's argmax picks it, on chunks of 1 to 300
    bins."""
    rng = np.random.default_rng(10 * lanes + seed)
    n, nv = 64, 12000
    power = rng.integers(0, 4, (2, nv)).astype(np.float32)
    power[0, rng.integers(0, nv, 40)] = np.nan
    length = rng.integers(1, 301, n)
    lo = rng.integers(0, nv - 300, n)
    got = lane_walk(power, lo, length, lanes)
    for f in range(2):
        for x in range(n):
            chunk = torch.from_numpy(power[f, lo[x] : lo[x] + length[x]])
            assert got[f, x] == lo[x] + int(torch.argmax(chunk))


def test_phase_values_model_first_maximum_and_single_bins():
    """Planted single-bin pixels (any bin, tied or not with their
    neighbours) and chunks whose bins all tie: the walk keeps the chunk's
    first bin, as ``_binmax_argbin`` does, and a single-bin pixel reads its
    bin."""
    c = make_spectrum_constant(axis_points=256, window_size=4096, configuration=SpectrumChannels.PHASE,
                               view_scaling=ViewScaling.LINEAR, device="cpu")
    single = c.single_mask.clone()
    single_bin = c.single_bin.clone()
    single[5::7] = True
    single_bin[5::7] = torch.arange(5, 256, 7, dtype=torch.int32) * 3 + 1
    c = dataclasses.replace(c, single_mask=single, single_bin=single_bin)
    spec = phase_spectra(c, 4, seed=11, plant=False)
    spec[0] = torch.complex(torch.tensor(0.75), torch.tensor(-0.5))  # every bin ties
    _, bins, argbin = _assert_model_is_the_plain_path(c, spec)
    bp = ~c.interp_mask.numpy()
    first = np.where(single.numpy(), single_bin.numpy(), c.chunk_lo.numpy())
    np.testing.assert_array_equal(bins[0, bp], first[bp])
    np.testing.assert_array_equal(bins[:, single.numpy()], np.broadcast_to(single_bin.numpy()[single.numpy()],
                                                                           (4, int(single.sum()))))


def test_phase_values_max_taps_is_the_kernels():
    """The wrapper's refusal uses a copy of csrc/phase_values.cu's kMaxTaps."""
    import re
    from pathlib import Path

    from signalizer_tpu_torch.kernels import phase_values as pv

    source = (Path(pv.__file__).resolve().parent.parent / "csrc" / "phase_values.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", source)}
    assert pv.MAX_TAPS == consts["kMaxTaps"] == dm.MAX_TAPS
