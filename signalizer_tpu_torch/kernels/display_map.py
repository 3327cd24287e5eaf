"""Kernel B: pixel remap -> peak decay -> normalized dB over all frames and
line graphs, one CUDA warp per (pair, row, 32 pixels, 8 frames) with the
decay recurrence split exactly across the groups of frames, and across the
blocks of a thread-block cluster where the pixel tiles leave the card empty
(:func:`display_map_plan`); decay and dB alone in a kernel of their own: a
fold pass, then a thread per 4 pixels x 8 frames.

Replaces the Pallas kernel ``tools/pallas_display_map.py::fused_display_map``
and computes the magnitude tail of the Spectrum step: the JAX production
path runs it as ``_remap_mag`` + ``post_process``
(``signalizer_tpu/kernels/spectrum.py:286-291, :518-598``; ref:
TransformDSP.inl mapToLinearSpace :504-1135, mapAndTransformDFTFilters
:1297-1435). The CUDA sources are ``signalizer_tpu_torch/csrc/display_map.cu``
and ``csrc/display_decay_db.cu``; this module holds their wrappers, their
plain PyTorch versions and the remap/dB helpers the Spectrum functions
share. Three entries: :func:`display_map` (remap, decay and dB in one
launch, the Spectrum step), :func:`display_remap` (the remap alone:
``spectrum_values``), both in ``display_map.cu``, and
:func:`display_decay_db` (decay and dB alone, for values that are already
display values: ``post_process``, the resonator view), the kernel of
``display_decay_db.cu``.

Only the linear max-decay semantics exist here: the JAX package's log-domain
form is the same function evaluated another way on the TPU.
"""

from __future__ import annotations

import functools

import torch

from signalizer_tpu_torch.core.constant import SpectrumConstant, db_constants
from signalizer_tpu_torch.kernels import _build
from signalizer_tpu_torch.kernels.peak_decay import peak_decay_scan
from signalizer_tpu_torch.utils.diagnostics import count, span

# the most taps and line graphs one launch takes: 10 taps is the most any
# plan has (Lanczos, a = 5); more line graphs than 8 run as launches of up
# to 8 each (the line graphs' decays are independent)
MAX_TAPS = 10
MAX_LINE_GRAPHS = 8
# the decay-and-dB kernel's layout, copies of csrc/display_decay_db.cu's
# constants (its entry refuses a plan outside them): a thread takes 4 pixels
# of DECAY_FRAMES frames (kFrames; 1 frame for T <= DECAY_FRAMES), a warp
# DECAY_WARP_PIXELS pixels (4 * kWarp); the fold pass a chunk of up to
# DECAY_MAX_GROUPS such groups a block (kMaxGroups), groups x K <=
# DECAY_MAX_GROUPS_K (kMaxGroupsK)
DECAY_FRAMES = 8
DECAY_MAX_GROUPS = 16
DECAY_MAX_GROUPS_K = 64
DECAY_WARP_PIXELS = 128
# the fused entry's layout, copies of csrc/display_map.cu's constants: a
# block takes a tile of MAP_TILE_PIXELS pixels (kWarp), a warp
# MAP_GROUP_FRAMES frames (kGroup), a block a chunk of MAP_CHUNK_FRAMES
# (kGroup * kMaxGroups) at a time; an SM holds MAP_BLOCKS_AN_SM blocks
# (kMinBlocks, the launch bounds); a tile's frames split across a cluster
# of at most MAP_MAX_CLUSTER blocks (kMaxCluster)
MAP_TILE_PIXELS = 32
MAP_GROUP_FRAMES = 8
MAP_CHUNK_FRAMES = 64
MAP_BLOCKS_AN_SM = 4
MAP_MAX_CLUSTER = 16

# kernel launches count in the diagnostics registry, one counter an entry:
# display_map.launches (the fused entry; .split_launches those of them that
# split T across a cluster), .remap_launches (the remap alone),
# .decay_db_launches (decay and dB alone)


def _interp(values: torch.Tensor, constant: SpectrumConstant) -> torch.Tensor:
    """Weighted tap gather: values [..., n_values] -> [..., P]. Works on
    real or complex values (PHASE interpolates complex cells)."""
    g = values[..., constant.interp_indices]  # [..., P, taps]
    return (g * constant.interp_weights).sum(-1)


def _binmax_mag(mags: torch.Tensor, constant: SpectrumConstant) -> torch.Tensor:
    """Chunked bin-max for magnitude rows (ref: TransformDSP.inl:608-639):
    a banded gather of each pixel's contiguous chunk plus a masked max."""
    g = mags[..., constant.band_idx]  # [..., P, maxband]
    segmax = torch.where(constant.band_mask, g, -torch.inf).amax(-1)
    single = mags[..., constant.single_bin]
    return torch.where(constant.single_mask, single, segmax)


def _interp_mag(mags: torch.Tensor, constant: SpectrumConstant) -> torch.Tensor:
    """Magnitude interpolation with the |.| rectification applied (the
    Lanczos kernel has negative lobes)."""
    return _interp(mags, constant).abs()


def _remap_mag(mags: torch.Tensor, constant: SpectrumConstant) -> torch.Tensor:
    """Interpolate-vs-binmax pixel remap for magnitude rows
    (ref: mapToLinearSpace, TransformDSP.inl:562-639)."""
    return torch.where(
        constant.interp_mask, _interp_mag(mags, constant), _binmax_mag(mags, constant)
    )


def _db_map(constant: SpectrumConstant, magnitudes: torch.Tensor) -> torch.Tensor:
    """Normalized dB mapping (ref: TransformDSP.inl:1308-1346):
    ``log(slope * mag / lowerFrac) / log(upperFrac / lowerFrac)``, clipped to
    ``clip_db`` where the argument is non-positive. Output is display-space:
    0 at low_dbs, 1 at high_dbs."""
    lower, delta_y_recip = db_constants(constant.low_dbs, constant.high_dbs)
    x = constant.slope_map * magnitudes / lower
    return torch.where(
        x > 0, torch.log(torch.clamp(x, min=1e-38)) * delta_y_recip, constant.clip_db
    )


def decay_db(
    constant: SpectrumConstant, state: torch.Tensor, vals: torch.Tensor, valid=None
) -> torch.Tensor:
    """Peak decay + dB map of display values ``vals`` [..., T, rows, P]
    against ``state`` [..., K, rows, P]; returns [..., T, K, rows, P].
    ``state`` is updated in place (the JAX step donated it)."""
    seq = vals[..., :, None, :, :]  # [..., T, 1, rows, P]
    decayed, new_state = peak_decay_scan(
        state, seq, constant.decay_poles[:, None, None], time_axis=-4, valid=valid
    )
    state.copy_(new_state)
    return _db_map(constant, decayed)


def display_remap_plain(constant: SpectrumConstant, mags: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch remap: magnitudes [..., rows, nv] -> linear display
    values ``inv_size * _remap_mag`` [..., rows, P]."""
    return constant.inv_size * _remap_mag(mags, constant)


def display_map_plain(
    constant: SpectrumConstant, mags: torch.Tensor, state: torch.Tensor, valid=None
) -> torch.Tensor:
    """Plain PyTorch magnitude tail: ``inv_size * _remap_mag`` -> the
    sequential peak-decay loop -> ``_db_map``. ``mags`` [..., T, rows, nv],
    ``state`` [..., K, rows, P] updated in place; returns
    [..., T, K, rows, P]."""
    return decay_db(constant, state, display_remap_plain(constant, mags), valid)


def _valid_tensor(valid, t: int, device) -> torch.Tensor:
    v = torch.as_tensor(valid, dtype=torch.bool, device=device).reshape(-1)
    if v.numel() != t:
        raise ValueError(f"display_map: valid has {v.numel()} entries for T={t}")
    return v.contiguous()


def _checked(name: str, constant: SpectrumConstant, x: torch.Tensor, width: int, lead_axes: int):
    """The checks every entry makes of its input ``x`` [..., width] with at
    least ``lead_axes`` axes before the last; returns the product of the
    axes before those."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: input must be float32")
    if x.ndim < lead_axes + 1 or x.shape[-1] != width:
        raise ValueError(f"{name}: input must be [..., {width}] with {lead_axes + 1}+ axes, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if constant.device != x.device:
        raise ValueError(f"{name}: input and constant must share one device")
    batch = 1
    for d in x.shape[: x.ndim - 1 - lead_axes]:
        batch *= d
    return batch


def _rows_like(x: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """``x`` [..., rows, n] with its one row repeated for each of the
    state's rows (COMPLEX: one magnitude row feeds both state rows, which
    the plain versions get by broadcasting); other shapes as they are."""
    rows = state.shape[-2] if state.ndim >= 2 else 1
    if x.ndim >= 2 and x.shape[-2] == 1 and rows > 1:
        return x.expand(x.shape[:-2] + (rows, x.shape[-1])).contiguous()
    return x


def display_remap(constant: SpectrumConstant, mags: torch.Tensor) -> torch.Tensor:
    """The remap alone: magnitudes ``mags`` [..., rows, nv] f32 -> linear
    display values [..., rows, P], the values :func:`display_map` feeds its
    decay. CPU tensors take :func:`display_remap_plain`; CUDA tensors launch
    ``sig_display_remap`` of ``csrc/display_map.cu`` or raise."""
    with span("kernel.display_map"):
        if mags.device.type == "cpu":
            return display_remap_plain(constant, mags)
        c = constant
        frames = _checked("display_remap", c, mags, c.n_spectrum_values, 1)
        rows = mags.shape[-2]
        if c.interp_taps > MAX_TAPS:
            raise ValueError(f"display_remap: at most {MAX_TAPS} taps")
        out = torch.empty(mags.shape[:-1] + (c.axis_points,), dtype=torch.float32, device=mags.device)
        if frames == 0:
            return out
        _build.launch(
            "sig_display_remap", mags.device, mags.data_ptr(), c.interp_indices.data_ptr(), c.interp_weights.data_ptr(),
            c.interp_mask.data_ptr(), c.single_mask.data_ptr(), c.single_bin.data_ptr(), c.chunk_lo.data_ptr(),
            c.chunk_len.data_ptr(), c.display_scalars.data_ptr(), out.data_ptr(), frames, rows, c.axis_points,
            c.n_spectrum_values, c.interp_taps, name="display_remap",
        )
        count("display_map.remap_launches")
        return out


def _decay_inputs(name: str, constant: SpectrumConstant, x: torch.Tensor, width: int, state, valid):
    """What the two entries that carry the decay share: ``x`` [..., T, rows,
    width] (its one row repeated for COMPLEX) checked against ``state``
    [..., K, rows, P]; returns ``(x, out, valid tensor or None, pairs)`` with
    ``out`` [..., T, K, rows, P] allocated."""
    p, k = constant.axis_points, constant.num_line_graphs
    x = _rows_like(x, state)
    pairs = _checked(name, constant, x, width, 2)
    lead, t, rows = x.shape[:-3], x.shape[-3], x.shape[-2]
    if state.dtype != torch.float32 or tuple(state.shape) != tuple(lead) + (k, rows, p):
        raise ValueError(
            f"{name}: state must be float32 {tuple(lead) + (k, rows, p)}, "
            f"got {state.dtype} {tuple(state.shape)}"
        )
    if not state.is_contiguous() or state.device != x.device:
        raise ValueError(f"{name}: state must be contiguous and on the input's device")
    if constant.interp_taps > MAX_TAPS:
        raise ValueError(f"{name}: at most {MAX_TAPS} taps")
    out = torch.empty(tuple(lead) + (t, k, rows, p), dtype=torch.float32, device=x.device)
    v = None if valid is None else _valid_tensor(valid, t, x.device)
    return x, out, v, pairs


def _line_graph_groups(constant: SpectrumConstant, state: torch.Tensor, out: torch.Tensor):
    """Yield ``(poles, state, out, K)`` for each launch: all line graphs at
    once up to ``MAX_LINE_GRAPHS``, else groups of that many, whose state
    and output slices are contiguous copies written back after the launch."""
    k = constant.num_line_graphs
    if k <= MAX_LINE_GRAPHS:
        yield constant.decay_poles, state, out, k
        return
    for k0 in range(0, k, MAX_LINE_GRAPHS):
        k1 = min(k, k0 + MAX_LINE_GRAPHS)
        st = state[..., k0:k1, :, :].contiguous()
        o = torch.empty_like(out[..., k0:k1, :, :], memory_format=torch.contiguous_format)
        yield constant.decay_poles[k0:k1], st, o, k1 - k0
        state[..., k0:k1, :, :] = st
        out[..., k0:k1, :, :] = o


def decay_db_plan(pairs: int, t: int, k: int, rows: int, p: int, sms: int) -> tuple:
    """``(frames a group, groups a fold block, chunks)`` for the
    decay-and-dB kernel on ``vals`` [pairs, t, rows, p] with ``k`` line
    graphs on a card of ``sms`` multiprocessors: all of T in one chunk
    where that gives the fold pass a block an SM or more, else half as many
    groups a block until it does (more than one chunk: a launch before the
    fold writes each chunk's end values)."""
    frames = 1 if t <= DECAY_FRAMES else DECAY_FRAMES
    groups = min(DECAY_MAX_GROUPS, -(-t // frames), DECAY_MAX_GROUPS_K // k)
    tiles = -(-p // DECAY_WARP_PIXELS) * rows * pairs
    while groups > 1 and tiles * -(-t // (groups * frames)) < sms:
        groups //= 2
    return frames, groups, -(-t // (groups * frames))


def display_map_plan(pairs: int, t: int, k: int, rows: int, p: int, sms: int) -> int:
    """Blocks a pixel tile for the fused entry on magnitudes [pairs, t,
    rows, ...] to ``p`` pixels with ``k`` line graphs on a card of ``sms``
    multiprocessors: 1 (a block walks all of T) where the tiles cover the
    card or T fits one chunk; else a cluster splitting T, the largest power
    of two, at least 2 and at most ``MAP_MAX_CLUSTER`` and one group of
    frames a block, whose blocks fit the card's block slots
    (``MAP_BLOCKS_AN_SM`` an SM) in one wave. A tile's time is its frames'
    walk, so the split goes on past one block an SM: on an H100 at the
    spectrogram's 32 tiles x 512 frames, 8 blocks a tile (256 blocks) take
    64.5 us and 16 (512) 52.2 us. ``k`` leaves the rule alone."""
    tiles = -(-p // MAP_TILE_PIXELS) * rows * pairs
    if tiles >= sms or t <= MAP_CHUNK_FRAMES:
        return 1
    most = min(MAP_MAX_CLUSTER, -(-t // MAP_GROUP_FRAMES))
    cluster = 2
    while cluster * 2 <= most and tiles * cluster * 2 <= MAP_BLOCKS_AN_SM * sms:
        cluster *= 2
    return cluster


@functools.lru_cache(maxsize=None)
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_multiprocessors(device: torch.device) -> int:
    return _multiprocessors(device.index if device.index is not None else torch.cuda.current_device())


def display_decay_db(
    constant: SpectrumConstant, state: torch.Tensor, vals: torch.Tensor, valid=None
) -> torch.Tensor:
    """Decay and dB alone: linear display values ``vals`` [..., T, rows, P]
    f32 against ``state`` [..., K, rows, P] f32, updated in place; ``valid``
    (optional [T] bool) marks padded frames that leave the state untouched.
    Returns [..., T, K, rows, P]. CPU tensors take :func:`decay_db`; CUDA
    tensors launch ``sig_display_decay_db`` of ``csrc/display_decay_db.cu``
    (the fused kernel's arithmetic and its exact split of the decay, so the
    state is the sequential loop's bit for bit; a fold pass, then the
    outputs, laid out by :func:`decay_db_plan`) or raise."""
    with span("kernel.display_map"):
        if vals.device.type == "cpu":
            return decay_db(constant, state, vals, valid)
        c = constant
        vals, out, v, pairs = _decay_inputs("display_decay_db", c, vals, c.axis_points, state, valid)
        if out.numel() == 0:
            return out
        t, rows = vals.shape[-3], vals.shape[-2]
        sms = _device_multiprocessors(vals.device)
        for poles, st, o, k in _line_graph_groups(c, state, out):
            frames, groups, chunks = decay_db_plan(pairs, t, k, rows, c.axis_points, sms)
            # each group's start state when T takes more than one group;
            # each chunk's end values and the state's copy for more than one chunk
            groups_in_t = -(-t // frames)
            scratch = [
                torch.empty(shape, dtype=torch.float32, device=vals.device) if n > 1 else None
                for n, shape in ((groups_in_t, (pairs, groups_in_t, k, rows, c.axis_points)),
                                 (chunks, (chunks, pairs, k, rows, c.axis_points)))
            ]
            _build.launch(
                "sig_display_decay_db", vals.device, vals.data_ptr(), c.slope_map.data_ptr(), poles.data_ptr(),
                c.display_scalars.data_ptr(), None if v is None else v.data_ptr(), st.data_ptr(), o.data_ptr(),
                *(None if x is None else x.data_ptr() for x in scratch), pairs, t, k, rows, c.axis_points, frames,
                groups, name="display_decay_db",
            )
            count("display_map.decay_db_launches")
        return out


def display_map(
    constant: SpectrumConstant, mags: torch.Tensor, state: torch.Tensor, valid=None
) -> torch.Tensor:
    """Remap + peak decay + dB for magnitudes ``mags`` [..., T, rows, nv] f32.

    ``state`` [..., K, rows, P] f32 is updated in place (the JAX step
    donated it); ``valid`` (optional [T] bool) marks padded frames that
    leave the state untouched. Returns display values [..., T, K, rows, P].
    CPU tensors take :func:`display_map_plain`; CUDA tensors launch
    ``sig_display_map`` of ``csrc/display_map.cu`` (each tile's frames split
    across a cluster of :func:`display_map_plan`'s blocks) or raise.
    """
    with span("kernel.display_map"):
        if mags.device.type == "cpu":
            return display_map_plain(constant, mags, state, valid)
        c = constant
        mags, out, v, pairs = _decay_inputs("display_map", c, mags, c.n_spectrum_values, state, valid)
        if out.numel() == 0:
            return out
        t, rows = mags.shape[-3], mags.shape[-2]
        sms = _device_multiprocessors(mags.device)
        for poles, st, o, k in _line_graph_groups(c, state, out):
            cluster = display_map_plan(pairs, t, k, rows, c.axis_points, sms)
            _build.launch(
                "sig_display_map", mags.device, mags.data_ptr(), c.interp_indices.data_ptr(),
                c.interp_weights.data_ptr(), c.interp_mask.data_ptr(), c.single_mask.data_ptr(),
                c.single_bin.data_ptr(), c.chunk_lo.data_ptr(), c.chunk_len.data_ptr(), c.slope_map.data_ptr(),
                poles.data_ptr(), c.display_scalars.data_ptr(), None if v is None else v.data_ptr(), st.data_ptr(),
                o.data_ptr(), pairs, t, k, rows, c.axis_points, c.n_spectrum_values, c.interp_taps, cluster,
                name="display_map",
            )
            count("display_map.launches")
            if cluster > 1:
                count("display_map.split_launches")
        return out
