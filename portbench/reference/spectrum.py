"""The plain reference of a Spectrum view's display path, in any precision.

Frames ``[..., C, W]`` -> channel packing -> window -> radix-2 FFT ->
DC/Nyquist halving -> ``|.|`` -> pixel remap -> peak decay over time and line
graphs -> normalized dB (ref: Signalizer v0.4.3 TransformDSP.inl:38-231,
:486-639, :1297-1435), and the spectrogram's colour columns
(SpectrumDSP.cpp:110-206). Written from the reference's description with
plain torch operations on real tensors, so one code runs in float64 (the
reference) and in bfloat16 (the control, the precision below the program's
float32): every operation rounds to ``dtype``. It imports nothing of the
program and takes its design from :mod:`portbench.reference.plan`.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.plan import ViewDesign


class Tables:
    """A :class:`ViewDesign` as tensors of ``dtype`` on ``device``."""

    def __init__(self, d: ViewDesign, dtype: torch.dtype, device):
        f = dict(dtype=dtype, device=device)
        p = d.plan
        self.design, self.dtype, self.device = d, dtype, device
        self.window = torch.tensor(d.window, **f)
        self.inv_size = torch.tensor(d.inv_size, **f)
        self.interp_idx = torch.tensor(p.interp_indices, dtype=torch.int64, device=device)
        self.interp_w = torch.tensor(p.interp_weights, **f)
        self.interp_mask = torch.tensor(p.interp_mask, device=device)
        self.single_bin = torch.tensor(p.single_bin, dtype=torch.int64, device=device)
        self.single_mask = torch.tensor(p.single_mask, device=device)
        width = max(int(p.band_len.max()), 1)
        j = torch.arange(width, device=device)[None, :]
        lo = torch.tensor(p.band_lo, device=device)[:, None]
        self.band_idx = torch.clamp(lo + j, max=p.n_values - 1)
        self.band_mask = j < torch.tensor(p.band_len, device=device)[:, None]
        self.slope = torch.tensor(d.slope, **f)
        self.poles = torch.tensor(d.poles, **f)
        self.lower = torch.tensor(d.lower, **f)
        self.delta_y_recip = torch.tensor(d.delta_y_recip, **f)
        self.clip_db = torch.tensor(d.clip_db, **f)
        n = d.transform_size
        self.bitrev = _bit_reverse(n, device)
        # each stage's twiddles exp(-2 pi i k / (2h)), designed in float64
        self.twiddles = []
        h = 1
        while h < n:
            ang = -2.0 * math.pi * torch.arange(h, dtype=torch.float64, device=device) / (2 * h)
            self.twiddles.append((torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)))
            h *= 2


def _bit_reverse(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    i = torch.arange(n, device=device)
    r = torch.zeros_like(i)
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return r


def fft(tables: Tables, re: torch.Tensor, im: torch.Tensor):
    """Radix-2 decimation-in-time FFT of ``re + i im`` along the last axis
    (length a power of two), every butterfly rounded to ``re``'s dtype."""
    n = re.shape[-1]
    lead = re.shape[:-1]
    re, im = re[..., tables.bitrev], im[..., tables.bitrev]
    h = 1
    for wr, wi in tables.twiddles:
        re = re.reshape(*lead, n // (2 * h), 2, h)
        im = im.reshape(*lead, n // (2 * h), 2, h)
        ar, ai, br, bi = re[..., 0, :], im[..., 0, :], re[..., 1, :], im[..., 1, :]
        tr = br * wr - bi * wi
        ti = br * wi + bi * wr
        re = torch.cat([ar + tr, ar - tr], dim=-1)
        im = torch.cat([ai + ti, ai - ti], dim=-1)
        h *= 2
    return re.reshape(*lead, n), im.reshape(*lead, n)


def pack(tables: Tables, frames: torch.Tensor) -> torch.Tensor:
    """frames [..., C, W] -> windowed rows [..., rows, W] (ref:
    TransformDSP.inl:91-215: mid and side are halved)."""
    mode = tables.design.mode
    x = frames.to(tables.dtype)
    left, right = x[..., 0, :], x[..., 1, :]
    if mode == "LEFT":
        rows = left[..., None, :]
    elif mode == "RIGHT":
        rows = right[..., None, :]
    elif mode == "MERGE":
        rows = ((left + right) * 0.5)[..., None, :]
    elif mode == "SIDE":
        rows = ((left - right) * 0.5)[..., None, :]
    elif mode == "MIDSIDE":
        rows = torch.stack([(left + right) * 0.5, (left - right) * 0.5], dim=-2)
    else:  # SEPARATE
        rows = x[..., :2, :]
    return rows * tables.window


def magnitudes(tables: Tables, frames: torch.Tensor) -> torch.Tensor:
    """frames [..., C, W] -> |X| [..., rows, N/2 + 1], DC and Nyquist halved
    (ref: TransformDSP.inl:551-554)."""
    rows = pack(tables, frames)
    n = tables.design.transform_size
    pad = n - rows.shape[-1]
    re = torch.nn.functional.pad(rows, (0, pad)) if pad else rows
    re, im = fft(tables, re, torch.zeros_like(re))
    re, im = re[..., : n // 2 + 1], im[..., : n // 2 + 1]
    mag = torch.sqrt(re * re + im * im)
    half = torch.ones(n // 2 + 1, dtype=mag.dtype, device=mag.device)
    half[0] = half[-1] = 0.5
    return mag * half


def remap(tables: Tables, mags: torch.Tensor) -> torch.Tensor:
    """|X| [..., rows, nv] -> linear display values [..., rows, P]: taps
    interpolated (then rectified) below the break, the max of each chunk of
    bins above it (ref: TransformDSP.inl:562-639), times ``inv_size``."""
    interp = (mags[..., tables.interp_idx] * tables.interp_w).sum(-1).abs()
    band = torch.where(tables.band_mask, mags[..., tables.band_idx], -math.inf).amax(-1)
    binmax = torch.where(tables.single_mask, mags[..., tables.single_bin], band)
    return tables.inv_size * torch.where(tables.interp_mask, interp, binmax)


def db_map(tables: Tables, x: torch.Tensor) -> torch.Tensor:
    """Linear magnitudes -> normalized dB: 0 at the low end, 1 at the high
    end, ``clip_db`` where the magnitude is not positive
    (ref: TransformDSP.inl:1308-1346)."""
    y = tables.slope * x / tables.lower
    return torch.where(y > 0, torch.log(torch.clamp(y, min=1e-38)) * tables.delta_y_recip, tables.clip_db)


class SpectrumReference:
    """The whole display path with its carried peak-decay state
    ``[pairs, K, rows, P]`` (``state = max(pole * state, new)``, ref:
    TransformDSP.inl:1336-1341), starting from zero."""

    def __init__(self, d: ViewDesign, pairs: int, dtype: torch.dtype, device):
        self.tables = Tables(d, dtype, device)
        k, p = len(d.poles), len(d.slope)
        self.state = torch.zeros((pairs, k, d.rows, p), dtype=dtype, device=device)

    def process(self, frames: torch.Tensor, block: int = 16) -> torch.Tensor:
        """frames [pairs, T, C, W] -> display values [pairs, T, K, rows, P],
        ``block`` frames at a time so that the float64 temporaries fit."""
        t = self.tables
        poles = t.poles[:, None, None]
        out = []
        for b in range(0, frames.shape[1], block):
            vals = remap(t, magnitudes(t, frames[:, b : b + block]))  # [pairs, block, rows, P]
            for i in range(vals.shape[1]):
                self.state = torch.maximum(poles * self.state, vals[:, i, None])
                out.append(db_map(t, self.state))
        return torch.stack(out, dim=1)


def colour_columns(intensity: torch.Tensor, colours: torch.Tensor, ratios: torch.Tensor) -> torch.Tensor:
    """Intensities [pairs, T, P] through each pair's gradient ``colours``
    [pairs, stops, 3] with segment widths ``ratios`` [stops] (stop 0 the
    background), the pairs blended as ``1 - prod(1 - c)`` and truncated to
    RGBA8 -> [T, P, 4] uint8 (ref: SpectrumDSP.cpp:110-206). Computes in
    ``intensity``'s dtype."""
    dtype = intensity.dtype
    colours, ratios = colours.to(dtype), ratios.to(dtype)
    bounds = torch.cumsum(ratios, 0)
    x = torch.clamp(intensity, 0.0, 1.0)
    # the segment c with bounds[c - 1] < x <= bounds[c]
    seg = torch.clamp((x[..., None] > bounds).sum(-1), 1, ratios.shape[0] - 1)
    lo, hi = bounds[seg - 1], bounds[seg]
    mix = torch.where(hi > lo, (x - lo) / torch.clamp(hi - lo, min=1e-20), 1.0)
    pair = torch.arange(colours.shape[0], device=x.device).reshape(-1, *([1] * (x.ndim - 1)))
    rgb = colours[pair, seg - 1] * (1.0 - mix[..., None]) + colours[pair, seg] * mix[..., None]
    last = colours[:, -1].reshape(colours.shape[0], *([1] * (x.ndim - 1)), 3)
    rgb = torch.where((x >= 0.999)[..., None], last, rgb)
    rgb = torch.where((intensity < 0)[..., None], 0.0, rgb)
    blended = 1.0 - torch.prod(1.0 - rgb, dim=0)
    q = torch.floor(torch.clamp(blended, 0.0, 1.0) * 255.0).to(torch.uint8)
    alpha = torch.full(q.shape[:-1] + (1,), 255, dtype=torch.uint8, device=q.device)
    return torch.cat([q, alpha], dim=-1)
