"""Kernel E: the Oscilloscope's colour track.

Replaces the associative scans of the JAX package's colour track
(``signalizer_tpu/kernels/filters.py::three_band_split`` and
``::onepole_smooth`` under ``signalizer_tpu/kernels/oscilloscope.py::
spectral_colour_track``; ref: OscilloscopeDSP.inl:440-494). The CUDA source
is ``signalizer_tpu_torch/csrc/colour_track.cu``, one templated kernel with
two entries, and this module holds their wrappers, the host tables they
read and the plain versions:

* :func:`three_band_split` (the split alone: bands [..., 3, W] and the
  crossover state) and :func:`three_band_split_plain`, eight biquads each
  solved by the doubling scan of :mod:`signalizer_tpu_torch.kernels.filters`;
* :func:`colour_track`, the oscilloscope step's whole colour track in one
  launch (the split, the smoothed band energies, the rgb mix and the lerp
  toward the key colour), colours written channel-major [..., 3, W], and
  :func:`colour_track_plain`, the plain split followed by
  :func:`spectral_colour_track_plain`;
* :func:`spectral_colour_track`, the colouring of bands it is given (the
  fused entry reading bands in place of x), returning [..., W, 3] as a view.

CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise. The kernel solves each recurrence as a chunked scan, a row split
across a thread-block cluster (:func:`colour_plan` picks its size and the
block's threads): a thread runs ``CHUNK`` samples from a zero state, the
chunks' end states are combined across the block and then across the
cluster's blocks with powers of the recurrence's matrix, and each sample is
fixed up with the power of its distance from the chunk's start.
:func:`host_table` forms every power in float64 from the float32
coefficients the plain code uses and rounds it once to float32; the table
is built once per sample rate, crossover and pole, and kept on the device.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from signalizer_tpu_torch.kernels import _build
from signalizer_tpu_torch.kernels.display_map import _multiprocessors
from signalizer_tpu_torch.kernels.filters import (
    CrossoverState,
    biquad_filter,
    butterworth_highpass,
    butterworth_lowpass,
    init_crossover_state,
    onepole_smooth,
)
from signalizer_tpu_torch.utils.diagnostics import count, span

# the kernel's geometry (csrc/colour_track.cu kChunk, kThreads,
# kMaxCluster, kClusterWarps, kSteps): samples a thread holds, threads a
# block at most (a block's segment of the row is its threads times CHUNK
# samples), blocks a row at most (a cluster; above 8 a non-portable one),
# warps a cluster at most (one a lane of the scan over them) and that
# scan's steps
CHUNK = 16
THREADS = 512
MAX_CLUSTER = 16
CLUSTER_WARPS = 32
STEPS = 5
# the most blocks a row the plan takes: a cluster of 16 (non-portable)
# measured slower than one of 8 at a session's 2 rows of 16384 samples
PLAN_CLUSTER = 8
WARP = 32
F32 = np.float32

# kernel launches by either entry count in the diagnostics registry as
# colour_track.launches


def crossover_coeffs(fs: float, f_low: float = 300.0, f_high: float = 3000.0):
    """The four biquads of the LR4 network, in section-pair order: lp_lo,
    hp_lo, lp_hi, hp_hi (each applied twice)."""
    return (
        butterworth_lowpass(f_low, fs),
        butterworth_highpass(f_low, fs),
        butterworth_lowpass(f_high, fs),
        butterworth_highpass(f_high, fs),
    )


def exponents(chunk: int = CHUNK, steps: int = STEPS) -> list:
    """The powers of a recurrence's matrix the table holds, in order: m^1..
    m^chunk (a sample's fix-up), m^(chunk l) for l = 0..31 (the lanes'
    scan) and m^(32 chunk 2^k) for k < ``steps`` (the scan over warps: the
    kernel's STEPS cover a cluster's 32 warps; the earlier designs, a row in
    one block of 512 threads, took 4: PERF.md §6)."""
    return (list(range(1, chunk + 1)) + [chunk * k for k in range(WARP)]
            + [WARP * chunk * 2**k for k in range(steps)])


def _powers(m: np.ndarray, exps: list) -> list:
    """m^e for each e in ``exps``, in float64 (binary powers), each rounded
    once to float32 and flattened."""
    return [np.linalg.matrix_power(m, e).astype(F32).ravel() for e in exps]


def host_table(fs, f_low: float = 300.0, f_high: float = 3000.0, pole: float = 0.0,
               chunk: int = CHUNK, steps: int = STEPS) -> np.ndarray:
    """The table kernel E reads (csrc/colour_track.cu, ``kTable`` floats):
    for each of the four biquads [-a1, 1, -a2, 0, bv0, bv1, b0, 0] (the
    companion matrix and the input vector of :func:`biquad_filter`, in
    float32 as it forms them) followed by its powers (:func:`exponents`, 2×2
    row-major), zeros where ``fs`` is None (bands given, no split); then
    the pole block [p, 1 - p, 0, 0] (p in float32, 1 - p rounded as the
    plain code's float32 subtraction) with p's powers."""
    exps = exponents(chunk, steps)
    parts = []
    for c in crossover_coeffs(fs, f_low, f_high) if fs is not None else [None] * 4:
        if c is None:
            parts.append(np.zeros(8 + 4 * len(exps), F32))
            continue
        b0, b1, b2, a1, a2 = (float(v) for v in c)
        a = np.array([[-a1, 1.0], [-a2, 0.0]], F32)
        parts.append(np.concatenate([a.ravel(), [F32(b1 - a1 * b0), F32(b2 - a2 * b0), F32(b0), 0.0]]))
        parts += _powers(a.astype(np.float64), exps)
    p = F32(pole)
    parts.append(np.array([p, F32(1.0) - p, 0.0, 0.0], F32))
    parts += _powers(np.array([[float(p)]]), exps)
    return np.concatenate(parts).astype(F32)


@functools.lru_cache(maxsize=None)
def colour_plan(rows: int, w: int, sms: int, chunk: int = CHUNK) -> Tuple[int, int]:
    """``(threads, cluster)`` for ``rows`` rows of ``w`` samples on a card of
    ``sms`` multiprocessors. A row that fits one block's segment (THREADS
    ``chunk`` samples) takes one block: its threads hold a chunk each
    either way, and a cluster only adds a cluster barrier a round (on an
    H100, 3 × 2 × 3001 ran faster in one block than in 2 or 6). A longer
    row takes the least power of two of blocks that gives the rows an SM's
    block each, at most PLAN_CLUSTER. Then the threads of
    :func:`colour_threads`."""
    cluster = 1
    if w > THREADS * chunk:
        while cluster < PLAN_CLUSTER and rows * cluster < sms:
            cluster *= 2
    return colour_threads(w, cluster, chunk), cluster


def colour_threads(w: int, cluster: int, chunk: int = CHUNK) -> int:
    """The fewest threads a block (a power of two, 32 to THREADS, the
    cluster at most CLUSTER_WARPS warps) whose ``cluster`` segments cover a
    row of ``w`` samples, else the most: the row is then walked in tiles of
    the cluster's span."""
    limit = min(THREADS, CLUSTER_WARPS // max(cluster, 1) * WARP)
    threads = WARP
    while 2 * threads <= limit and cluster * threads * chunk < w:
        threads *= 2
    return threads


def _geometry(dev: torch.device, rows: int, w: int) -> Tuple[int, int]:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return colour_plan(rows, w, _multiprocessors(index))


@functools.lru_cache(maxsize=32)
def _device_table(fs, f_low: float, f_high: float, pole: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(host_table(fs, f_low, f_high, pole)).to(device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def three_band_split_plain(
    x: torch.Tensor,
    fs: float,
    f_low: float = 300.0,
    f_high: float = 3000.0,
    state: CrossoverState = None,
) -> Tuple[torch.Tensor, CrossoverState]:
    """Plain PyTorch version of kernel E's split: each LR4 section a
    doubling scan (:func:`biquad_filter`)."""
    if state is None:
        state = init_crossover_state(x.shape[:-1], x.dtype, x.device)
    lp_lo, hp_lo, lp_hi, hp_hi = crossover_coeffs(fs, f_low, f_high)

    z = state.z
    low1, z0 = biquad_filter(lp_lo, x, z[..., 0, :])
    low, z1 = biquad_filter(lp_lo, low1, z[..., 1, :])
    rest1, z2 = biquad_filter(hp_lo, x, z[..., 2, :])
    rest, z3 = biquad_filter(hp_lo, rest1, z[..., 3, :])
    mid1, z4 = biquad_filter(lp_hi, rest, z[..., 4, :])
    mid, z5 = biquad_filter(lp_hi, mid1, z[..., 5, :])
    high1, z6 = biquad_filter(hp_hi, rest, z[..., 6, :])
    high, z7 = biquad_filter(hp_hi, high1, z[..., 7, :])

    bands = torch.stack([low, mid, high], dim=-2)
    new_state = CrossoverState(z=torch.stack([z0, z1, z2, z3, z4, z5, z6, z7], dim=-2))
    return bands, new_state


def spectral_colour_track_plain(
    bands: torch.Tensor,
    smooth_pole,
    band_colours: torch.Tensor,
    key_colour: torch.Tensor,
    blend,
    smooth_state: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the colouring (see
    :func:`signalizer_tpu_torch.kernels.oscilloscope.spectral_colour_track`):
    the smoother a doubling scan (:func:`onepole_smooth`)."""
    sq = bands * bands  # [..., 3, W]
    smoothed = onepole_smooth(sq, smooth_pole, smooth_state)  # [..., 3, W]
    s = smoothed[..., :, :, None]  # [..., 3, W, 1]
    rgb = s[..., 0, :, :] * band_colours[0] + s[..., 1, :, :] * band_colours[1]
    rgb = rgb + s[..., 2, :, :] * band_colours[2]  # [..., W, 3]
    peak = torch.amax(rgb, dim=-1, keepdim=True)
    rgb = rgb / torch.clamp(peak, min=1e-20)
    rgb = torch.where(peak > 0, rgb, 0.0)
    key = key_colour[..., None, :]
    out = key + (rgb - key) * blend
    return out, smoothed[..., -1]


def colour_track_plain(
    x: torch.Tensor,
    fs: float,
    crossover: CrossoverState,
    pole,
    band_colours: torch.Tensor,
    key_colour: torch.Tensor,
    blend,
    smooth_state: torch.Tensor = None,
    f_low: float = 300.0,
    f_high: float = 3000.0,
) -> Tuple[torch.Tensor, CrossoverState, torch.Tensor]:
    """Plain PyTorch version of :func:`colour_track`: the plain split, then
    the plain colouring; the colours returned channel-major as a view."""
    bands, new_xover = three_band_split_plain(x, fs, f_low, f_high, crossover)
    colours, new_smooth = spectral_colour_track_plain(bands, pole, band_colours, key_colour, blend, smooth_state)
    return torch.movedim(colours, -1, -2), new_xover, new_smooth


def float64_reference(x, fs: float, z, pole, s, band_colours, key, blend, f_low: float = 300.0,
                      f_high: float = 3000.0):
    """The colour track in float64 (scipy's ``lfilter``, whose zi is the same
    TDF2 state), the oracle the card's checks hold kernel E and its plain
    version to. numpy in and out: x [B, W], z [B, 8, 2], s [B, 3], key [B,
    3]. Returns (bands [B, 3, W], z [B, 8, 2], smoothed energies [B, 3, W],
    colours [B, 3, W])."""
    from scipy.signal import lfilter

    x = np.asarray(x, np.float64)
    z = np.asarray(z, np.float64)
    z_out = np.empty(z.shape)

    def section(i, v, c):
        out = np.empty(v.shape)
        for r in range(v.shape[0]):
            out[r], z_out[r, i] = lfilter([c.b0, c.b1, c.b2], [1.0, c.a1, c.a2], v[r], zi=z[r, i])
        return out

    lp_lo, hp_lo, lp_hi, hp_hi = crossover_coeffs(fs, f_low, f_high)
    low = section(1, section(0, x, lp_lo), lp_lo)
    rest = section(3, section(2, x, hp_lo), hp_lo)
    mid = section(5, section(4, rest, lp_hi), lp_hi)
    high = section(7, section(6, rest, hp_hi), hp_hi)
    bands = np.stack([low, mid, high], 1)
    p = float(F32(pole))
    s = np.asarray(s, np.float64)
    smoothed = np.empty(bands.shape)
    for r, k in np.ndindex(s.shape):
        smoothed[r, k], _ = lfilter([1.0 - p], [1.0, -p], bands[r, k] ** 2, zi=[p * s[r, k]])
    rgb = np.einsum("bkw,kc->bcw", smoothed, np.asarray(band_colours, np.float64))
    peak = rgb.max(1, keepdims=True)
    rgb = np.where(peak > 0, rgb / np.maximum(peak, 1e-20), 0.0)
    key = np.asarray(key, np.float64)[:, :, None]
    return bands, z_out, smoothed, key + (rgb - key) * float(F32(blend))


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------


def _check_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim < 1 or x.shape[-1] < 1:
        raise ValueError(f"{name}: x must be float32 [..., W>=1], got {x.dtype} {tuple(x.shape)}")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., W] as [B, W] rows with unit stride (a view where it can be)."""
    rows = x.reshape(-1, x.shape[-1])
    return rows if rows.stride(-1) == 1 else rows.contiguous()


def _state(v, shape, dev: torch.device, name: str, what: str) -> torch.Tensor:
    if v is None:
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    if tuple(v.shape) != tuple(shape) or v.dtype != torch.float32 or v.device != dev:
        raise ValueError(f"{name}: {what} must be float32 {tuple(shape)} on {dev}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")
    return v.contiguous()


def _host_pole(pole) -> float:
    """The pole as a host number (a tensor is read back: one sync)."""
    return float(F32(pole.item() if isinstance(pole, torch.Tensor) else pole))


def _launch_track(src: torch.Tensor, row_stride: int, lead, w: int, bands_in: bool, fs, f_low, f_high,
                  crossover, pole, band_colours, key_colour, blend, smooth_state, name: str):
    """sig_colour_track on rows ``src``: returns (colours [*lead, 3, W],
    z [*lead, 8, 2] or None, smooth [*lead, 3])."""
    dev = src.device
    n = math.prod(lead)
    z_in = None if bands_in else _state(None if crossover is None else crossover.z, (*lead, 8, 2), dev, name,
                                        "the crossover state")
    s_in = _state(smooth_state, (*lead, 3), dev, name, "the smoothing state")
    bc = torch.as_tensor(band_colours, dtype=torch.float32, device=dev)
    if bc.shape != (3, 3):
        raise ValueError(f"{name}: band_colours must be [3, 3], got {tuple(bc.shape)}")
    bc = bc.contiguous()
    # the key per row: [pairs, rows_per_pair, 3] with a pair stride (0 for
    # one key a row shared by every pair)
    rows_pp = max(lead[-1], 1) if len(lead) else 1
    key = torch.broadcast_to(torch.as_tensor(key_colour, dtype=torch.float32, device=dev), (*lead, 3))
    key = key.reshape(-1, rows_pp, 3) if n > 0 else key.reshape(0, 1, 3)
    if key.stride(-1) != 1:
        key = key.contiguous()
    if isinstance(blend, torch.Tensor):
        if blend.numel() != 1 or blend.dtype != torch.float32 or blend.device != dev:
            raise ValueError(f"{name}: blend must be a float32 scalar on {dev}")
        blend_ptr, blend_value = blend.data_ptr(), 0.0
    else:
        blend_ptr, blend_value = None, float(F32(blend))
    table = _device_table(None if bands_in else float(fs), float(f_low), float(f_high), _host_pole(pole), dev)
    colours = torch.empty((*lead, 3, w), dtype=torch.float32, device=dev)
    z_out = None if bands_in else torch.empty_like(z_in)
    s_out = torch.empty_like(s_in)
    if n > 0:
        _build.launch(
            "sig_colour_track", dev, src.data_ptr(), row_stride, int(bands_in), table.data_ptr(),
            None if bands_in else z_in.data_ptr(), None if bands_in else z_out.data_ptr(),
            s_in.data_ptr(), s_out.data_ptr(), bc.data_ptr(), key.data_ptr(), key.stride(0), key.stride(1),
            rows_pp, blend_ptr, blend_value, colours.data_ptr(), n, w, CHUNK, *_geometry(dev, n, w), name=name,
        )
        count("colour_track.launches")
    return colours, z_out, s_out


def three_band_split(
    x: torch.Tensor,
    fs: float,
    f_low: float = 300.0,
    f_high: float = 3000.0,
    state: CrossoverState = None,
) -> Tuple[torch.Tensor, CrossoverState]:
    """3-band LR4 split, x [..., W] -> bands [..., 3, W] (low, mid, high)
    and the new crossover state [..., 8, 2]. CPU tensors take
    :func:`three_band_split_plain`; CUDA tensors launch kernel E's split
    entry or raise."""
    with span("kernel.colour_track"):
        if x.device.type == "cpu":
            return three_band_split_plain(x, fs, f_low, f_high, state)
        _check_cuda(x, "three_band_split")
        dev, lead, w = x.device, x.shape[:-1], x.shape[-1]
        rows = _rows(x)
        z_in = _state(None if state is None else state.z, (*lead, 8, 2), dev, "three_band_split", "the crossover state")
        table = _device_table(float(fs), float(f_low), float(f_high), 0.0, dev)
        bands = torch.empty((*lead, 3, w), dtype=torch.float32, device=dev)
        z_out = torch.empty_like(z_in)
        if rows.shape[0] > 0:
            stride = rows.stride(0) if rows.shape[0] > 1 else w
            _build.launch(
                "sig_colour_split", dev, rows.data_ptr(), stride, table.data_ptr(), z_in.data_ptr(), z_out.data_ptr(),
                bands.data_ptr(), rows.shape[0], w, CHUNK, *_geometry(dev, rows.shape[0], w), name="three_band_split",
            )
            count("colour_track.launches")
        return bands, CrossoverState(z=z_out)


def colour_track(
    x: torch.Tensor,
    fs: float,
    crossover: CrossoverState,
    pole,
    band_colours: torch.Tensor,
    key_colour: torch.Tensor,
    blend,
    smooth_state: torch.Tensor = None,
    f_low: float = 300.0,
    f_high: float = 3000.0,
) -> Tuple[torch.Tensor, CrossoverState, torch.Tensor]:
    """The oscilloscope's colour track (ref: OscilloscopeDSP.inl:440-494):
    the 3-band split of x [..., W] from the crossover state, each band's
    energy smoothed by the one-pole ``pole`` from ``smooth_state`` [..., 3],
    rgb = sum_b s_b * band_colours[b], normalised so max(r, g, b) = 1, and
    lerped by ``blend`` toward ``key_colour`` (broadcast to [..., 3]: one
    key a row, or a key per pair and row).

    Returns (colours [..., 3, W] channel-major, the new crossover state,
    the new smoothing state). ``pole`` is a host number (a tensor is read
    back once); ``blend`` a host number or a float32 scalar on x's device.
    CPU tensors take :func:`colour_track_plain`; CUDA tensors launch kernel
    E once or raise."""
    with span("kernel.colour_track"):
        if x.device.type == "cpu":
            return colour_track_plain(x, fs, crossover, pole, band_colours, key_colour, blend, smooth_state,
                                      f_low, f_high)
        _check_cuda(x, "colour_track")
        rows = _rows(x)
        stride = rows.stride(0) if rows.shape[0] > 1 else x.shape[-1]
        colours, z_out, s_out = _launch_track(rows, stride, x.shape[:-1], x.shape[-1], False, fs, f_low, f_high,
                                              crossover, pole, band_colours, key_colour, blend, smooth_state,
                                              "colour_track")
        return colours, CrossoverState(z=z_out), s_out


def spectral_colour_track(
    bands: torch.Tensor,
    smooth_pole,
    band_colours: torch.Tensor,
    key_colour: torch.Tensor,
    blend,
    smooth_state: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The colouring of bands [..., 3, W] it is given (see
    :func:`signalizer_tpu_torch.kernels.oscilloscope.spectral_colour_track`):
    CPU tensors take :func:`spectral_colour_track_plain`; CUDA tensors
    launch kernel E's fused entry on the bands or raise, and get the
    channel-major colours back as a [..., W, 3] view."""
    with span("kernel.colour_track"):
        if bands.device.type == "cpu":
            return spectral_colour_track_plain(bands, smooth_pole, band_colours, key_colour, blend, smooth_state)
        _check_cuda(bands, "spectral_colour_track")
        if bands.ndim < 2 or bands.shape[-2] != 3:
            raise ValueError(f"spectral_colour_track: bands must be [..., 3, W], got {tuple(bands.shape)}")
        lead, w = bands.shape[:-2], bands.shape[-1]
        src = bands.contiguous()
        colours, _, s_out = _launch_track(src, 3 * w, lead, w, True, None, 300.0, 3000.0, None, smooth_pole,
                                          band_colours, key_colour, blend, smooth_state, "spectral_colour_track")
        return torch.movedim(colours, -2, -1), s_out
