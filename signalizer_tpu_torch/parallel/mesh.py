"""Multi-device scaling: the mesh and the sharded analysis steps.

Counterpart of :mod:`signalizer_tpu.parallel.mesh`. The reference's
concurrency (a thread pool over channel pairs, and an in-process
multi-instance mix) maps to data parallelism over the pair batch axis: no
frame depends on another except through per-pair filter states, which stay
with their pairs.

* A mesh is an ordered list of torch devices (:func:`make_analysis_mesh`:
  every visible CUDA device). ``"cpu"`` entries are for the tests, which
  run two shards on one CPU.
* A value sharded over the mesh is cut on its leading axis into one
  contiguous chunk a device, in mesh order (:func:`shard_batch`). On a
  one-device mesh it is the tensor (or the tuple of tensors) itself; on n
  devices it is a list of n per-device values.
* Every step built here returns a callable with the arguments and outputs
  of the JAX step, in the same order. Sharded outputs come back in the
  same form as the inputs; each reduction across shards (the JAX code's
  ``pmax`` and ``psum``) is one tensor on the mesh's first device.
* Each shard runs the port's single-device functions (``analyze_frames``,
  ``osc_step``, ``vs_step``, ``rsnt_chunks``, ...) with its device as the
  current one, so that the hand-written kernels launch there. The host
  issues the shards one after the other; their kernels queue on each
  device's current stream, so the devices run together. Per-pair states are updated in
  place where the single-device function updates them in place (the JAX
  steps donate them).
* The scalars the JAX steps take as replicated f32 device values (window,
  transport position, new samples, poles, gains) are host numbers here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from signalizer_tpu_torch.core.constant import SpectrumConstant, check_device
from signalizer_tpu_torch.kernels.spectrum import analyze_frames, init_line_graph_state

Mesh = List[torch.device]


def make_analysis_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The first ``n_devices`` CUDA devices (None: every visible one).

    Raises without a CUDA device, and fails fast when fewer than
    ``n_devices`` exist: a smaller mesh would defer the failure to a shape
    check deep inside the first sharded step. (A mesh of ``"cpu"`` entries,
    for the tests, is written out as a list.)
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_analysis_mesh: no CUDA device is available "
            "(torch.cuda.is_available() is False)"
        )
    count = torch.cuda.device_count()
    if n_devices is not None:
        if count < n_devices:
            raise RuntimeError(
                f"make_analysis_mesh: requested {n_devices} devices but only "
                f"{count} CUDA devices are visible"
            )
        count = n_devices
    return [torch.device("cuda", i) for i in range(count)]


def mesh_devices(mesh: Sequence) -> Mesh:
    """The mesh as a list of torch devices (each checked to exist)."""
    devices = [check_device(d) for d in mesh]
    if not devices:
        raise ValueError("an analysis mesh needs at least one device")
    return devices


def _to(tree, device: torch.device):
    """A tensor, numpy array or tuple of them on ``device`` (no copy where
    a tensor is there already)."""
    if tree is None:
        return None
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(_to(leaf, device) for leaf in tree))


def _split(tree, n: int) -> list:
    """Cut every leaf's leading axis into n equal contiguous chunks."""
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        if tree.ndim == 0 or tree.shape[0] % n != 0:
            raise ValueError(
                f"a sharded value's leading axis ({tuple(tree.shape)}) must divide over {n} devices"
            )
        return list(torch.chunk(tree, n, dim=0))
    parts = [_split(leaf, n) for leaf in tree]
    return [type(tree)(*(p[i] for p in parts)) for i in range(n)]


def shard_batch(tree, mesh: Sequence):
    """Place a tensor (or a tuple of them, or a numpy array) with a leading
    batch axis on the mesh: on one device the value itself, moved there if
    it is elsewhere (no copy if it is there); on n devices a list of n
    contiguous chunks of the leading axis, each on its device."""
    devices = mesh_devices(mesh)
    if len(devices) == 1:
        return _to(tree, devices[0])
    return [_to(part, d) for part, d in zip(_split(tree, len(devices)), devices)]


def _shards(value, devices: Mesh) -> list:
    """A sharded value as its list of per-device values; a whole value is
    sharded first."""
    if len(devices) > 1 and isinstance(value, list):
        if len(value) != len(devices):
            raise ValueError(f"a value sharded {len(value)} ways on a mesh of {len(devices)} devices")
        return value
    sharded = shard_batch(value, devices)
    return sharded if len(devices) > 1 else [sharded]


def _join(parts: list, devices: Mesh):
    """Per-device outputs in the sharded form: the value itself on one
    device, else the list."""
    return parts[0] if len(devices) == 1 else list(parts)


def _pmax(values: list, devices: Mesh) -> torch.Tensor:
    """The JAX ``pmax``: the largest of the per-shard scalars, on the first
    device."""
    if len(values) == 1:
        return values[0]
    return torch.stack([v.to(devices[0]) for v in values]).amax()


def _psum(values: list, devices: Mesh) -> torch.Tensor:
    """The JAX ``psum``: the per-shard partials summed, on the first device."""
    total = values[0].to(devices[0])
    for v in values[1:]:
        total = total + v.to(devices[0])
    return total


def _on(obj, device: torch.device):
    """A frozen dataclass of configuration (a constant, a block plan) with
    every tensor field on ``device``: the object itself where they all are."""
    moved = {
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if f.init and isinstance(getattr(obj, f.name), torch.Tensor)
        and getattr(obj, f.name).device != device
    }
    return dataclasses.replace(obj, **moved) if moved else obj


def _valid_on(valid, device: torch.device):
    """``valid`` [T] as the single-device functions take it: host values as
    they are, a tensor on the shard's device."""
    if isinstance(valid, torch.Tensor):
        return valid.to(device)
    return valid


def _current(device: torch.device):
    """``device`` as the current CUDA device for a shard's launches (nothing
    to do for the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


@contextlib.contextmanager
def _full_f32():
    """Float32 matrix products in full float32 (TF32 off) for the block,
    as the JAX code's ``Precision.HIGHEST`` asks."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def sharded_spectrum_step(constant: SpectrumConstant, mesh: Sequence):
    """Multi-device spectrum step.

    Returns ``step(state, frames, valid) -> (results, new_state,
    global_peak)`` with frames [pairs, T, C, W] and the state sharded on
    their leading axis, pairs % n_devices == 0. ``valid`` [T] bool
    (replicated) masks host-padded frames out of the filter states: a
    pipeline that zero-pads a short batch must not decay its peak state on
    fabricated silence.
    """
    devices = mesh_devices(mesh)
    consts = [_on(constant, d) for d in devices]

    def step(state, frames, valid):
        results, states, peaks = [], [], []
        for c, s, f in zip(consts, _shards(state, devices), _shards(frames, devices)):
            with _current(c.device):
                r = analyze_frames(c, s, f, valid=_valid_on(valid, c.device))
            results.append(r.results)
            states.append(r.state)
            peaks.append(torch.amax(r.results))
        return _join(results, devices), _join(states, devices), _pmax(peaks, devices)

    return step


def global_peak_level(results) -> torch.Tensor:
    """Cross-shard diagnostic reduction: the largest value of a tensor or of
    a list of shards (on the first shard's device)."""
    if isinstance(results, list):
        return _pmax([torch.amax(r) for r in results], [results[0].device])
    return torch.amax(results)


def sharded_mix_step(mesh: Sequence, max_channels: int = 16):
    """The multi-instance mix gather as a sum across shards
    (ref: MixGraphListener::deliver's ring-gather into a ChannelMatrix,
    MixGraphListener.cpp:247-334; clock alignment stays on the host in
    stream/mix_graph.py).

    ``step(sources, routing) -> (mixed [out_ch, T], global peak)`` with
    sources [S, in_ch, T] (time-aligned source blocks) and routing [S,
    in_ch, out_ch] (per-edge gains, out_ch <= ``max_channels``) sharded on
    S. Each shard mixes its sources in float32 (TF32 off); the partial
    mixes are summed on the first device, which holds the whole block.
    """
    devices = mesh_devices(mesh)

    def step(sources, routing):
        partials = []
        for src, route in zip(_shards(sources, devices), _shards(routing, devices)):
            if route.shape[-1] > max_channels:
                raise ValueError(
                    f"routing out_ch ({route.shape[-1]}) exceeds max_channels ({max_channels})"
                )
            with _full_f32(), _current(src.device):
                partials.append(torch.einsum("sct,sco->ot", src, route))
        mixed = _psum(partials, devices)
        return mixed, torch.amax(torch.abs(mixed))

    return step


def sharded_oscilloscope_step(constant, mesh: Sequence, pairs: Optional[int] = None):
    """Multi-device oscilloscope step, data-parallel over channel pairs
    (ref: SpectrumDSP.cpp:83 parallel_for / CHANGELOG 0.4.0).

    Returns ``step(state, history, window, transport, new_samples) ->
    (frame, new_state, global_level)`` with state, history [pairs, 2, H] and
    frame sharded on their pairs axis; ``window``, ``transport`` and
    ``new_samples`` are host numbers.

    ``pairs``: the pair count across the mesh; when given, pairs beyond the
    first draw with hue-rotated key colours exactly as the single-device
    processor draws them, each shard taking its rows of the table by its
    place in the mesh.
    """
    from signalizer_tpu_torch.views.oscilloscope import make_pair_key_colours, osc_step

    devices = mesh_devices(mesh)
    consts = [_on(constant, d) for d in devices]
    table = make_pair_key_colours(constant, pairs or 1)
    tables = None if table is None else [table.to(d) for d in devices]

    def step(state, history, window, transport, new_samples):
        hists = _shards(history, devices)
        lp = hists[0].shape[0]
        if tables is not None and tables[0].shape[0] != lp * len(devices):
            raise ValueError(
                f"pairs ({tables[0].shape[0]}) != per-shard history rows "
                f"({lp}) x mesh devices ({len(devices)})"
            )
        frames, states, levels = [], [], []
        for i, (c, s, h) in enumerate(zip(consts, _shards(state, devices), hists)):
            keys = None if tables is None else tables[i][i * lp : (i + 1) * lp]
            with _current(c.device):
                frame, new_state = osc_step(c, s, h, float(window), float(transport), float(new_samples), keys)
            frames.append(frame)
            states.append(new_state)
            levels.append(torch.amax(torch.abs(h)))
        return _join(frames, devices), _join(states, devices), _pmax(levels, devices)

    return step


def sharded_vectorscope_step(mesh: Sequence, **static_kwargs):
    """Multi-device vectorscope step (pairs-parallel).

    ``static_kwargs``: ``mode``, ``autogain``, ``rotation`` and
    ``scale_to_fill``, as :func:`~signalizer_tpu_torch.views.vectorscope.vs_step`
    takes them. Returns ``step(state, peak_env, frames, envelope_pole,
    stereo_pole, user_gain, peak_coeff, new_samples) -> (frame, new_state,
    new_peak_env, global_level)``; the scalars are host numbers, and
    ``new_samples`` limits the meter filters to the window's trailing new
    samples (a rolling-history caller re-reads overlapping windows, and the
    reference's meters see each sample once, Vectorscope.cpp:319-342).
    """
    from signalizer_tpu_torch.views.vectorscope import vs_step

    devices = mesh_devices(mesh)
    rotation = static_kwargs.pop("rotation", 0.0)

    def step(state, peak_env, frames, envelope_pole, stereo_pole, user_gain, peak_coeff, new_samples):
        outs, states, peaks, levels = [], [], [], []
        for s, p, f in zip(_shards(state, devices), _shards(peak_env, devices), _shards(frames, devices)):
            with _current(f.device):
                frame, new_state, new_peak = vs_step(
                    s, p, f, envelope_pole, stereo_pole, user_gain, peak_coeff, rotation, new_samples,
                    **static_kwargs,
                )
            outs.append(frame)
            states.append(new_state)
            peaks.append(new_peak)
            levels.append(torch.amax(torch.abs(f)))
        return (_join(outs, devices), _join(states, devices), _join(peaks, devices),
                _pmax(levels, devices))

    return step


def sharded_spectrogram_step(constant: SpectrumConstant, mesh: Sequence):
    """Multi-device spectrogram step: the per-pair colour columns stay on
    their shards; the cross-pair blend is the one sum across shards. The
    blend ``1 - prod(1 - c)`` over pairs factors into per-shard partial
    products, summed as logs: ``1 - exp(sum log(clamp(1 - c, 1e-7, 1)))``,
    the JAX step's form, so that one and two shards agree.

    Returns ``step(state, frames, colours, ratios, valid) -> (columns
    [T, P, 4] u8 on the first device, new_state sharded)``; ``valid`` [T]
    masks zero-padded frames out of the filter state (padded slots still
    emit columns: consumers index real columns by the same mask).
    """
    from signalizer_tpu_torch.kernels.colormap import gradient_map, quantize_rgba8

    devices = mesh_devices(mesh)
    consts = [_on(constant, d) for d in devices]

    def step(state, frames, colours, ratios, valid):
        logs, states = [], []
        for c, s, f, col in zip(consts, _shards(state, devices), _shards(frames, devices),
                                _shards(colours, devices)):
            with _current(c.device):
                result = analyze_frames(c, s, f, valid=_valid_on(valid, c.device), decay_domain="linear")
                intensity = result.results[:, :, 0, 0, :]  # [local pairs, T, P]
                rgb = gradient_map(intensity, col, _to(ratios, c.device))  # [local pairs, T, P, 3]
                logs.append(torch.sum(torch.log(torch.clamp(1.0 - rgb, 1e-7, 1.0)), dim=0))
            states.append(result.state)
        blended = 1.0 - torch.exp(_psum(logs, devices))
        return quantize_rgba8(blended), _join(states, devices)

    return step


def sharded_fused_step(
    constant: SpectrumConstant,
    resample_matrix: torch.Tensor,
    mesh: Sequence,
    *,
    pixels: int = 1024,
    envelope_pole: float = 0.999,
    stereo_pole: float = 0.99,
):
    """The fused all-views step (bench cfg5) over a device mesh: spectrum,
    waveform resample, min-max envelopes and stereo meters per pair shard,
    with one cross-shard max as the diagnostic.

    Returns ``step(state, vstate, frames, valid) -> (results, wave, mins,
    maxs, corr, new_state, new_vstate, global_peak)``; ``valid`` [T] masks
    zero-padded frames out of the peak-decay state, and the meter update
    (which consumes the newest frame) holds when that frame is a pad. The
    meter poles go to each device once, here: a tick copies no host number.
    """
    from signalizer_tpu_torch.kernels.oscilloscope import minmax_decimate, sinc_resample_static
    from signalizer_tpu_torch.kernels.vectorscope import correlation, update_meters

    devices = mesh_devices(mesh)
    consts = [_on(constant, d) for d in devices]
    matrices = [resample_matrix.to(d) for d in devices]
    poles = [
        tuple(torch.tensor(p, dtype=torch.float32, device=d) for p in (envelope_pole, stereo_pole))
        for d in devices
    ]

    def step(state, vstate, frames, valid):
        outs = []
        for c, m, (ep, sp), s, vs, f in zip(consts, matrices, poles, _shards(state, devices),
                                            _shards(vstate, devices), _shards(frames, devices)):
            v = _valid_on(valid, c.device)
            with _current(c.device):
                r = analyze_frames(c, s, f, valid=v)
                corr = correlation(f)
                first = f[..., 0, :]
                wave = sinc_resample_static(first, m)
                mins, maxs = minmax_decimate(first, pixels)
                vupd = update_meters(vs, f[:, -1], envelope_pole=ep, stereo_pole=sp)
            if isinstance(v, torch.Tensor):
                vnew = type(vs)(*(torch.where(v[-1], a, b) for a, b in zip(vupd, vs)))
            else:
                vnew = vupd if (v is None or bool(np.asarray(v)[-1])) else vs
            outs.append((r.results, wave, mins, maxs, corr, r.state, vnew, torch.amax(r.results)))
        cols = list(zip(*outs))
        return (*(_join(list(col), devices) for col in cols[:7]), _pmax(list(cols[7]), devices))

    return step


def sharded_resonator_step(constant: SpectrumConstant, resonator, plan, mesh: Sequence):
    """The RSNT production tick over a device mesh: each shard runs mix ->
    resonate -> windowed readout -> decay and dB on its own pairs (the bank
    state [pairs, rows, P, V, 2] never leaves its device), with one
    cross-shard max as the diagnostic (ref: parallel_for over channel
    pairs, SpectrumDSP.cpp:83; continuous resonate, TransformDSP.inl:1163-1211).

    Returns ``step(res_state, graph_state, blocks, valid) -> (results,
    new_res_state, new_graph_state, global_peak)`` with blocks
    [pairs, 2, T, W] sharded on pairs and valid [T] host bools (or None)."""
    from signalizer_tpu_torch.views.spectrum import rsnt_chunks

    devices = mesh_devices(mesh)
    consts = [_on(constant, d) for d in devices]
    resonators = [_on(resonator, d) for d in devices]
    plans = [_on(plan, d) for d in devices]

    def step(res_state, graph_state, blocks, valid):
        results, res_states, graph_states, peaks = [], [], [], []
        for c, res, pl, rs, gs, b in zip(consts, resonators, plans, _shards(res_state, devices),
                                          _shards(graph_state, devices), _shards(blocks, devices)):
            with _current(c.device):
                out, st, g = rsnt_chunks(c, res, rs, gs, b, valid, pl)
            results.append(out)
            res_states.append(st)
            graph_states.append(g)
            peaks.append(torch.amax(out))
        return (_join(results, devices), _join(res_states, devices), _join(graph_states, devices),
                _pmax(peaks, devices))

    return step


def init_sharded_state(constant: SpectrumConstant, pairs: int, mesh: Sequence):
    """A fresh line-graph state for ``pairs`` pairs, sharded over the mesh."""
    devices = mesh_devices(mesh)
    state = init_line_graph_state(_on(constant, devices[0]), (pairs,))
    return shard_batch(state, devices)
