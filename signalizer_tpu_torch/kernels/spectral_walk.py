"""Kernel F: the Oscilloscope's spectral trigger walk.

Replaces the ``lax.while_loop`` of
``signalizer_tpu/kernels/oscilloscope.py::spectral_fundamental`` (ref:
calculateFundamentalPeriod, OscilloscopeDSP.inl:134-184), the per-bin
``jnp.abs(spec)`` and ``_quad_delta`` that feed it, and, in its filtered
entries, ``median_record_filter`` (ref: OscilloscopeDSP.inl:187-213). The
CUDA source is ``signalizer_tpu_torch/csrc/spectral_walk.cu``, one templated
kernel with two load stages and four entries, and this module holds their
wrappers and plain versions:

* :func:`spectral_walk_spectrum`, the walk on the rfft's half spectrum of
  an ``n``-sample lookahead, ``[..., >= n // 2 + 1]`` complex64: the kernel
  forms each bin's magnitude and quadratic offset itself. What
  :func:`~signalizer_tpu_torch.kernels.oscilloscope.spectral_fundamental`
  calls; :func:`spectral_walk_spectrum_plain` is ``spec.abs()``,
  :func:`_quad_delta` and the plain loop.
* :func:`spectral_walk_filtered_spectrum`, the same and the 8-deep median
  filter in one launch (what the oscilloscope step's SPECTRAL trigger
  calls), and :func:`spectral_walk_filtered_spectrum_plain`.
* :func:`spectral_walk` and :func:`spectral_walk_filtered`, the walk (and
  the filter) on magnitudes and quadratic offsets ``[..., >= n // 2]`` f32
  formed by the caller, and their plain versions
  :func:`spectral_walk_plain`, the loop from acceptance to acceptance that
  tests ``any(active)`` on the host every pass, and
  :func:`spectral_walk_filtered_plain`, that loop followed by
  :func:`median_record_filter`.

Bin 1 is the first incumbent, bins 2 .. n/2 - 1 the candidates.
``threshold`` and ``hysteresis`` are host numbers or float32 scalars on the
input's device. Each plain version is what its kernel is held to bit for
bit on the card. A launch copies nothing between host and device and reads
nothing back: the passes stay on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from signalizer_tpu_torch.kernels import _build
from signalizer_tpu_torch.utils.diagnostics import count, span

MAX_WALK_ITERATIONS = 280  # > the 277 doublings f32's range allows
MEDIAN_FILTER_SIZE = 8  # ref: OscilloscopeDSP.inl MedianData::FilterSize
QUARTER_SEMITONE = 2.0 ** (0.25 / 12.0) - 1.0
# the kernel's limit (csrc/spectral_walk.cu kMaxBins): candidate bins a row
# at most, n // 2 - 2 <= MAX_BINS
MAX_BINS = 8192
F32 = np.float32

# kernel launches by any entry, and by the two spectrum entries alone,
# count in the diagnostics registry as spectral_walk.launches and
# .spectrum_launches; the passes [...] int32 of the last launch, on the
# device (chip_smoke.py and tests read them)
last_passes = None


class BinRecord(NamedTuple):
    """Fundamental candidate (ref: OscilloscopeDSP.inl BinRecord)."""

    index: torch.Tensor  # int32
    value: torch.Tensor  # f32 magnitude
    offset: torch.Tensor  # f32 fractional bin offset

    def omega(self):
        return self.index.to(torch.float32) + self.offset


def _quad_delta(spec: torch.Tensor) -> torch.Tensor:
    """Complex quadratic interpolation of the true peak offset per bin
    (ref: OscilloscopeDSP.inl:103-126): Re((X[w-1]-X[w+1]) /
    (2 X[w] - X[w-1] - X[w+1])), with bin 0 mirroring bin 1. The guard is
    the reference's ``(denom.real + denom.imag) != 0``, as the JAX code has
    it."""
    xm1 = torch.cat([spec[..., 1:2], spec[..., :-1]], dim=-1)
    x1 = torch.roll(spec, -1, dims=-1)
    denom = spec * 2.0 - xm1 - x1
    ok = (denom.real + denom.imag) != 0
    ratio = (xm1 - x1) / torch.where(ok, denom, torch.ones_like(denom))
    return torch.where(ok, ratio.real, 0.0)


def spectral_walk_plain(
    mags: torch.Tensor, offsets: torch.Tensor, n: int, threshold=0.0, hysteresis=0.0
) -> Tuple[BinRecord, torch.Tensor]:
    """Plain PyTorch version of :func:`spectral_walk`: between two
    acceptances the incumbent is constant, so each pass tests every later
    bin against it at once and takes the first accepted one; the loop ends
    when no row accepted anything, a test the host makes every pass."""
    dev = mags.device
    inv_h = 1.0 - hysteresis
    batch_shape = mags.shape[:-1]
    floor = torch.as_tensor(threshold, dtype=torch.float32, device=dev) * n / 6.0
    record = BinRecord(
        index=torch.full(batch_shape, 1, dtype=torch.int32, device=dev),
        value=torch.maximum(floor, mags[..., 1]),
        offset=offsets[..., 1],
    )

    half = n // 2
    idxs = torch.arange(2, half, dtype=torch.int32, device=dev)
    vals = mags[..., 2:half]  # [..., M]
    offs = offsets[..., 2:half]
    omegas = idxs.to(torch.float32) + offs

    def accept_mask(rec: BinRecord) -> torch.Tensor:
        max_omega = rec.omega()[..., None]
        vastly_better = inv_h * vals > rec.value[..., None] * 2.0
        factor = omegas / torch.where(max_omega > 0, max_omega, 1.0)
        sensitivity = vals / torch.clamp(rec.value[..., None], min=1e-30)
        twenty_x = inv_h * sensitivity > 20.0
        same_partial = torch.abs(1.0 - factor) < inv_h * QUARTER_SEMITONE
        mult_dev = torch.abs(factor - torch.floor(factor + 0.5))
        not_harmonic = inv_h * mult_dev > QUARTER_SEMITONE
        accept_with_positive = twenty_x | same_partial | not_harmonic
        accept = vastly_better & torch.where(max_omega > 0, accept_with_positive, True)
        return accept & (idxs > rec.index[..., None])

    accepted = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
    it = 0
    while it < MAX_WALK_ITERATIONS:
        acc = accept_mask(record)
        any_acc = acc.any(dim=-1)
        it += 1
        if not bool(any_acc.any()):
            break
        accepted += any_acc
        first = torch.argmax(acc.to(torch.uint8), dim=-1)  # first True
        record = BinRecord(
            index=torch.where(any_acc, idxs[first], record.index),
            value=torch.where(any_acc, torch.gather(vals, -1, first[..., None])[..., 0], record.value),
            offset=torch.where(any_acc, torch.gather(offs, -1, first[..., None])[..., 0], record.offset),
        )
    return record, torch.clamp(accepted + 1, max=MAX_WALK_ITERATIONS)


def median_record_filter(
    history_omega: torch.Tensor, record: BinRecord
) -> Tuple[torch.Tensor, BinRecord, torch.Tensor]:
    """8-deep median-by-bin filter over detected fundamentals
    (ref: OscilloscopeDSP.inl:187-213): the single upper-middle element of
    the history BEFORE inserting the new detection, skipped while it is a
    -1 sentinel. Returns (new_history, filtered record, use_median)."""
    middle = history_omega.shape[-1] // 2
    med = torch.sort(history_omega, dim=-1).values[..., middle]
    omega = record.omega()
    hist = torch.cat([history_omega[..., 1:], omega[..., None]], dim=-1)
    use_median = (med >= 0) & (torch.abs(omega - med) > 0.5)
    omega = torch.where(use_median, med, omega)
    filtered = BinRecord(
        index=torch.floor(omega).to(torch.int32),
        value=record.value,
        offset=omega - torch.floor(omega),
    )
    return hist, filtered, use_median


def spectral_walk_filtered_plain(
    mags: torch.Tensor, offsets: torch.Tensor, n: int, history: torch.Tensor, threshold=0.0, hysteresis=0.0
) -> Tuple[torch.Tensor, BinRecord, torch.Tensor]:
    """Plain PyTorch version of :func:`spectral_walk_filtered`: the plain
    loop, then :func:`median_record_filter`."""
    record, passes = spectral_walk_plain(mags, offsets, n, threshold, hysteresis)
    hist, filtered, _ = median_record_filter(history, record)
    return hist, filtered, passes


def spectral_walk_spectrum_plain(
    spec: torch.Tensor, n: int, threshold=0.0, hysteresis=0.0
) -> Tuple[BinRecord, torch.Tensor]:
    """Plain PyTorch version of :func:`spectral_walk_spectrum`: the
    magnitudes (``spec.abs()``) and quadratic offsets (:func:`_quad_delta`)
    of the whole row, then :func:`spectral_walk_plain`."""
    return spectral_walk_plain(spec.abs(), _quad_delta(spec), n, threshold, hysteresis)


def spectral_walk_filtered_spectrum_plain(
    spec: torch.Tensor, n: int, history: torch.Tensor, threshold=0.0, hysteresis=0.0
) -> Tuple[torch.Tensor, BinRecord, torch.Tensor]:
    """Plain PyTorch version of :func:`spectral_walk_filtered_spectrum`: the
    magnitudes and offsets as :func:`spectral_walk_spectrum_plain` forms
    them, then :func:`spectral_walk_filtered_plain`."""
    return spectral_walk_filtered_plain(spec.abs(), _quad_delta(spec), n, history, threshold, hysteresis)


def _scalar(v, name: str, dev: torch.device):
    """A device scalar's pointer, or None for a host number."""
    if not isinstance(v, torch.Tensor):
        return None
    if v.numel() != 1 or v.dtype != torch.float32 or v.device != dev:
        raise ValueError(f"spectral_walk: {name} must be a float32 scalar on {dev}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")
    return v.data_ptr()


def _rows(t: torch.Tensor) -> torch.Tensor:
    """[..., H] as [rows, H] with unit stride along H."""
    t = t.reshape(-1, t.shape[-1])
    return t if t.stride(-1) == 1 else t.contiguous()


def _launch(what, src, n, threshold, hysteresis, history, offsets=None):
    """One launch of an entry: the spectrum stage on ``src`` [..., >= n // 2
    + 1] complex64 (``offsets`` None), or the bins stage on ``src`` (the
    magnitudes) and ``offsets`` [..., >= n // 2] f32."""
    global last_passes
    if src.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {src.device}")
    dev = src.device
    half = n // 2
    m = max(half - 2, 0)
    spectrum = offsets is None
    if spectrum:
        if src.dtype != torch.complex64:
            raise ValueError(f"{what}: spec must be complex64, got {src.dtype}")
        if src.ndim < 1 or src.shape[-1] < m + 3:
            raise ValueError(f"{what}: spec must be [..., >= {m + 3}] (n = {n}), got {tuple(src.shape)}")
    else:
        if src.dtype != torch.float32 or offsets.dtype != torch.float32 or offsets.shape != src.shape:
            raise ValueError(f"{what}: mags and offsets must be float32 of one shape, got {src.dtype} "
                             f"{tuple(src.shape)} and {offsets.dtype} {tuple(offsets.shape)}")
        if src.ndim < 1 or src.shape[-1] < max(half, 2) or offsets.device != dev:
            raise ValueError(f"{what}: mags and offsets must be [..., >= {max(half, 2)}] on {dev}, got "
                             f"{tuple(src.shape)} on {src.device} and {offsets.device}")
    if m > MAX_BINS:
        raise ValueError(f"{what}: {m} candidate bins (n = {n}); the kernel takes at most {MAX_BINS} (n <= "
                         f"{2 * MAX_BINS + 5})")
    lead = src.shape[:-1]
    if history is not None and (history.shape != (*lead, MEDIAN_FILTER_SIZE) or history.dtype != torch.float32
                                or history.device != dev):
        raise ValueError(f"{what}: history must be float32 {(*lead, MEDIAN_FILTER_SIZE)} on {dev}, got "
                         f"{history.dtype} {tuple(history.shape)} on {history.device}")
    thr_ptr = _scalar(threshold, "threshold", dev)
    hyst_ptr = _scalar(hysteresis, "hysteresis", dev)
    # host numbers: the plain version's f32 values, each formed in float64
    # and rounded once (f32(threshold); 1 - h and (1 - h) * qs as Python
    # floats, rounded where they meet a float32 tensor)
    thr = 0.0 if thr_ptr is not None else float(F32(threshold))
    inv_h = 0.0 if hyst_ptr is not None else float(F32(1.0 - hysteresis))
    iq = 0.0 if hyst_ptr is not None else float(F32((1.0 - hysteresis) * QUARTER_SEMITONE))
    index = torch.empty(lead, dtype=torch.int32, device=dev)
    value = torch.empty(lead, dtype=torch.float32, device=dev)
    offset = torch.empty(lead, dtype=torch.float32, device=dev)
    passes = torch.empty(lead, dtype=torch.int32, device=dev)
    hist_in = hist_out = None
    if history is not None:
        hist_in = history.contiguous()
        hist_out = torch.empty_like(hist_in)
    rows2 = _rows(src)
    rows = rows2.shape[0]
    if rows > 0:
        stride = lambda t: t.stride(0) if rows > 1 else t.shape[-1]  # noqa: E731
        tail = (thr_ptr, hyst_ptr, thr, inv_h, iq, float(F32(QUARTER_SEMITONE)), float(F32(n)),
                None if hist_in is None else hist_in.data_ptr(),
                index.data_ptr(), value.data_ptr(), offset.data_ptr(),
                None if hist_out is None else hist_out.data_ptr(), passes.data_ptr(), rows, m)
        if spectrum:
            _build.launch("sig_spectral_walk_spectrum", dev, rows2.data_ptr(), stride(rows2), *tail, name=what)
        else:
            o2 = _rows(offsets)
            _build.launch("sig_spectral_walk", dev, rows2.data_ptr(), stride(rows2), o2.data_ptr(), stride(o2), *tail,
                          name=what)
        count("spectral_walk.launches")
        count("spectral_walk.spectrum_launches", int(spectrum))
    last_passes = passes
    return BinRecord(index, value, offset), hist_out, passes


def spectral_walk(
    mags: torch.Tensor, offsets: torch.Tensor, n: int, threshold=0.0, hysteresis=0.0
) -> Tuple[BinRecord, torch.Tensor]:
    """The fundamental candidate walk (ref: OscilloscopeDSP.inl:134-184):
    a bin must beat the incumbent by 2x (scaled by 1 - hysteresis); a 20x
    winner always takes over; a candidate within a quarter semitone of the
    incumbent is a better estimate of the same partial; a candidate
    harmonically related to the incumbent is rejected.

    ``mags``, ``offsets`` [..., >= n // 2] f32 (the rfft's magnitudes and
    quadratic offsets of an ``n``-sample lookahead). Returns (BinRecord
    [...], passes [...] int32: the passes each row took, the last accepting
    nothing unless it was the ``MAX_WALK_ITERATIONS``-th). CPU tensors take
    :func:`spectral_walk_plain`; CUDA tensors launch
    ``csrc/spectral_walk.cu`` (one block a row, at most ``MAX_BINS``
    candidates) or raise.
    """
    with span("kernel.spectral_walk"):
        if mags.device.type == "cpu":
            return spectral_walk_plain(mags, offsets, n, threshold, hysteresis)
        record, _, passes = _launch("spectral_walk", mags, n, threshold, hysteresis, None, offsets)
        return record, passes


def spectral_walk_filtered(
    mags: torch.Tensor, offsets: torch.Tensor, n: int, history: torch.Tensor, threshold=0.0, hysteresis=0.0
) -> Tuple[torch.Tensor, BinRecord, torch.Tensor]:
    """The oscilloscope step's SPECTRAL trigger search: :func:`spectral_walk`,
    then :func:`median_record_filter` over ``history`` [..., 8] f32 (past
    omegas, -1 where none yet). Returns (new history [..., 8], the filtered
    BinRecord [...], passes [...] int32). CPU tensors take
    :func:`spectral_walk_filtered_plain`; CUDA tensors launch
    ``csrc/spectral_walk.cu``'s filtered entry (one launch, no host-device
    copy) or raise."""
    with span("kernel.spectral_walk"):
        if mags.device.type == "cpu":
            return spectral_walk_filtered_plain(mags, offsets, n, history, threshold, hysteresis)
        record, hist, passes = _launch("spectral_walk_filtered", mags, n, threshold, hysteresis, history, offsets)
        return hist, record, passes


def spectral_walk_spectrum(
    spec: torch.Tensor, n: int, threshold=0.0, hysteresis=0.0
) -> Tuple[BinRecord, torch.Tensor]:
    """:func:`spectral_walk` on the rfft's half spectrum ``spec`` [...,
    >= n // 2 + 1] complex64 of an ``n``-sample lookahead (n >= 4): each
    bin's magnitude and quadratic offset are formed from ``spec`` as
    ``spec.abs()`` and :func:`_quad_delta` form them. Returns (BinRecord
    [...], passes [...] int32). CPU tensors take
    :func:`spectral_walk_spectrum_plain`; CUDA tensors launch
    ``csrc/spectral_walk.cu``'s spectrum stage (one launch, no host-device
    copy) or raise."""
    with span("kernel.spectral_walk"):
        if spec.device.type == "cpu":
            return spectral_walk_spectrum_plain(spec, n, threshold, hysteresis)
        record, _, passes = _launch("spectral_walk_spectrum", spec, n, threshold, hysteresis, None)
        return record, passes


def spectral_walk_filtered_spectrum(
    spec: torch.Tensor, n: int, history: torch.Tensor, threshold=0.0, hysteresis=0.0
) -> Tuple[torch.Tensor, BinRecord, torch.Tensor]:
    """The oscilloscope step's SPECTRAL trigger search on the rfft's half
    spectrum: :func:`spectral_walk_spectrum`, then
    :func:`median_record_filter` over ``history`` [..., 8] f32. Returns (new
    history [..., 8], the filtered BinRecord [...], passes [...] int32). CPU
    tensors take :func:`spectral_walk_filtered_spectrum_plain`; CUDA tensors
    launch ``csrc/spectral_walk.cu``'s filtered spectrum entry (one launch,
    no host-device copy) or raise."""
    with span("kernel.spectral_walk"):
        if spec.device.type == "cpu":
            return spectral_walk_filtered_spectrum_plain(spec, n, history, threshold, hysteresis)
        record, hist, passes = _launch("spectral_walk_filtered_spectrum", spec, n, threshold, hysteresis, history)
        return hist, record, passes
