"""Complex resonator bank — the Spectrum's RSNT algorithm.

Counterpart of :mod:`signalizer_tpu.kernels.resonator`, a re-design of cpl's
``CComplexResonator`` (ref: usage at
Source/Spectrum/TransformConstant.h:44-45,120-123 remapResonator and
TransformDSP.inl:1213-1295 resonatingDispatch; the cpl submodule is absent,
so the filter design is re-derived from the documented behavior: a
per-display-pixel tuned complex one-pole bank with *windowed readout*
restricted to finite-cosine-sum windows, ref: SpectrumController.cpp:136-169).

Theory: a complex one-pole ``z[n] = c z[n-1] + x[n]`` with
``c = r e^{j w}`` is a sliding exponentially-weighted DFT at frequency w.
A cosine-sum window ``w[n] = sum_k (-1)^k a_k cos(2 pi k n / N)`` in the
frequency domain is a comb of 2K+1 Diracs, so the *windowed* sliding DFT
is a fixed linear combination of 2K+1 resonators offset by the bin spacing
— which is why the reference restricts RSNT to "finite DFT windows".

The reference advances the bank per sample. Per *block*, the recurrence has
the closed form

    z' = c^W z + sum_n c^(W-1-n) x[n]

so a whole W-sample block is one product of the input against a precomputed
[P*V, W] pole-power ramp: a plain float32 matrix product
(``torch.matmul``, full float32, never TF32), not a length-W sequential
dependency. States stay exact (the same recurrence, evaluated
associatively). Over T chunks the state recurrence and the readout are
kernel H on a GPU (:mod:`~signalizer_tpu_torch.kernels.resonator_scan`).
Complex values are kept as (re, im) float32 pairs at every boundary, as
the JAX package keeps them. The design math is host numpy in
float64, copied with its arithmetic unchanged; tests hold it bit-equal to
the original.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from signalizer_tpu_torch.core.constant import resolve_device
from signalizer_tpu_torch.core.windows import WindowType, window_coefficients
from signalizer_tpu_torch.kernels.resonator_scan import ScanResult, _advance, readout_complex_plain, resonator_scan


@dataclasses.dataclass(frozen=True, eq=False)
class ResonatorConstant:
    """Immutable resonator bank configuration.

    ``vectors`` = 2K+1 resonators per pixel (window order K). Tensors on
    one device:

    * poles [P, V, 2] float32 — r_k e^{j(w_k + m d_k)} as (re, im) pairs
    * combine [V] float32 — signed window combination coefficients
    * gain [P] float32 — per-pixel normalization so a full-scale sine at
      the pixel's frequency reads magnitude 1.0 (matching the FFT path's
      invSize convention, TransformDSP.inl:540)

    ``host_poles`` [P, V] complex128 is the design-time value of the poles,
    kept on the host for :func:`make_block_plan`.
    """

    num_pixels: int
    vectors: int
    poles: torch.Tensor
    combine: torch.Tensor
    gain: torch.Tensor
    host_poles: np.ndarray

    @property
    def device(self) -> torch.device:
        return self.poles.device


def design_resonator(
    mapped_frequencies: np.ndarray,
    sample_rate: float,
    window_size: int,
    *,
    window_type: WindowType = WindowType.HANN,
    free_q: bool = False,
    min_cycles: int = 8,
    min_window: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The bank's design in float64 numpy: ``(poles [P, V] complex128,
    combine [V], gain [P])`` (ref: Resonator mapSystemHz call,
    TransformConstant.h:120-123 — freeQ flag, the constant 8, windowSize).

    Per pixel k with frequency f_k:

    * effective window N_k = window_size (locked Q), or with ``free_q``
      N_k = clamp(min_cycles * fs / f_k, min_window, window_size) —
      constant-Q: every pixel integrates ``min_cycles`` cycles.
    * pole radius r_k = 1 - 2/N_k (exponential window with the same
      equivalent length), vector offsets d_k = 2 pi / N_k (the window's
      bin spacing).
    * gain calibrated analytically from the steady-state response of the
      combined bank to a unit complex exponential at f_k.
    """
    freqs = np.asarray(mapped_frequencies, np.float64)
    p = len(freqs)
    coeffs = np.asarray(window_coefficients(window_type), np.float64)
    k_order = len(coeffs) - 1
    v = 2 * k_order + 1
    offsets_m = np.arange(-k_order, k_order + 1)

    if free_q:
        n_k = np.clip(min_cycles * sample_rate / np.maximum(freqs, 1e-3), min_window, window_size)
    else:
        n_k = np.full(p, float(max(window_size, min_window)))

    r = 1.0 - 2.0 / n_k  # equivalent-length exponential window
    r = np.clip(r, 0.0, 0.999999)
    omega = 2.0 * np.pi * freqs / sample_rate
    delta = 2.0 * np.pi / n_k
    angles = omega[:, None] + offsets_m[None, :] * delta[:, None]
    poles = r[:, None] * np.exp(1j * angles)  # [P, V]

    # combination: cos(k t) = (e^{jkt} + e^{-jkt})/2 -> vector m = +-k gets
    # (-1)^k a_k / 2 (m != 0), center gets a_0
    comb = np.zeros(v)
    comb[k_order] = coeffs[0]
    for k in range(1, k_order + 1):
        comb[k_order + k] = ((-1.0) ** k) * coeffs[k] * 0.5
        comb[k_order - k] = ((-1.0) ** k) * coeffs[k] * 0.5

    # steady-state response of the combined bank to e^{j omega n}:
    # each vector resonator accumulates 1/(1 - c_m e^{-j omega})
    resp = np.zeros(p, np.complex128)
    for m in range(v):
        resp += comb[m] / (1.0 - poles[:, m] * np.exp(-1j * omega))
    # a real sine contributes half its amplitude at +omega
    gain = 1.0 / np.maximum(np.abs(resp) * 0.5, 1e-20)
    return poles, comb, gain


def _pairs_f32(z: np.ndarray) -> np.ndarray:
    """complex [..] -> float32 (re, im) pairs [.., 2]."""
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


def make_resonator_constant(
    mapped_frequencies: np.ndarray,
    sample_rate: float,
    window_size: int,
    *,
    device=None,
    window_type: WindowType = WindowType.HANN,
    free_q: bool = False,
    min_cycles: int = 8,
    min_window: int = 8,
) -> ResonatorConstant:
    """Design the bank (:func:`design_resonator`) and put it on ``device``
    (``None``: the GPU, raising without one)."""
    device = resolve_device(device)
    poles, comb, gain = design_resonator(
        mapped_frequencies, sample_rate, window_size,
        window_type=window_type, free_q=free_q, min_cycles=min_cycles, min_window=min_window,
    )
    return ResonatorConstant(
        num_pixels=poles.shape[0],
        vectors=poles.shape[1],
        poles=torch.from_numpy(_pairs_f32(poles)).to(device),
        combine=torch.from_numpy(comb.astype(np.float32)).to(device),
        gain=torch.from_numpy(gain.astype(np.float32)).to(device),
        host_poles=np.ascontiguousarray(poles, np.complex128),
    )


def init_resonator_state(
    constant: ResonatorConstant, batch_shape: Tuple[int, ...] = ()
) -> torch.Tensor:
    """Real (re, im) state pairs [..., P, V, 2] on the constant's device."""
    return torch.zeros(
        batch_shape + (constant.num_pixels, constant.vectors, 2),
        dtype=torch.float32, device=constant.device,
    )


def resonator_state_from_arrays(state, device=None) -> torch.Tensor:
    """A resonator state from carried (re, im) pairs given as an array
    (e.g. a JAX state read with ``np.asarray``), copied to ``device``
    (``None``: the GPU, raising without one)."""
    return torch.tensor(np.asarray(state), dtype=torch.float32, device=resolve_device(device))


@dataclasses.dataclass(frozen=True, eq=False)
class ResonatorBlockPlan:
    """Precomputed pole-power ramp for a fixed block length W.

    ``resonate_block``'s closed form needs ``c^(W-1-n)`` for every pole —
    P*V*W complex powers that depend only on (bank, W): designed once on
    the host in float64, rounded once, kept on the device in the layout the
    drive's matrix product reads.
    """

    block: int
    # [P*V*2, W]: row (p, v, re/im) holds c^(W-1-n), so that one product
    # with a block gives the state's own [P, V, 2] layout
    drive_matrix: torch.Tensor
    decay: torch.Tensor  # [P, V, 2] (re, im) = c^W

    @property
    def ramp(self) -> torch.Tensor:
        """[P, V, W, 2] (re, im) = c^(W-1-n), a view of ``drive_matrix``."""
        p, v = self.decay.shape[0], self.decay.shape[1]
        return torch.movedim(self.drive_matrix.reshape(p, v, 2, self.block), -2, -1)


def design_block_plan(poles: np.ndarray, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(ramp [P, V, W, 2], decay [P, V, 2])`` float32 (re, im) pairs of
    ``c^(W-1-n)`` and ``c^W`` for complex128 ``poles`` [P, V]."""
    n = np.arange(block)
    ramp = poles[..., None] ** (block - 1 - n)  # [P, V, W] complex128
    decay = poles**block
    return _pairs_f32(ramp), _pairs_f32(decay)


def _drive_layout(ramp):
    """ramp [P, V, W, 2] (numpy or tensor) -> contiguous [P*V*2, W]."""
    p, v, w, _ = ramp.shape
    if isinstance(ramp, np.ndarray):
        return np.ascontiguousarray(np.moveaxis(ramp, -1, -2)).reshape(p * v * 2, w)
    return torch.movedim(ramp, -1, -2).reshape(p * v * 2, w)


def make_block_plan(constant: ResonatorConstant, block: int) -> ResonatorBlockPlan:
    """The plan for ``block``-sample chunks, from the constant's host poles,
    on the constant's device."""
    ramp, decay = design_block_plan(constant.host_poles, int(block))
    return ResonatorBlockPlan(
        block=int(block),
        drive_matrix=torch.from_numpy(_drive_layout(ramp)).to(constant.device),
        decay=torch.from_numpy(decay).to(constant.device),
    )


def _full_f32_matmul(x: torch.Tensor) -> None:
    """The drive is a float32 product that must not lose bits: refuse to
    run it as TF32 on a GPU (the setting is read here, never written)."""
    if x.device.type == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "resonator: float32 matmul would run as TF32 "
            "(torch.backends.cuda.matmul.allow_tf32 or a lowered "
            "float32_matmul_precision); the bank needs full float32"
        )


def _ramp(constant: ResonatorConstant, w: int, plan: ResonatorBlockPlan):
    """``(drive matrix [P*V*2, W], decay_re [P, V], decay_im [P, V])`` for blocks of
    ``w`` samples: the plan's, or computed on the device from the float32
    poles when there is none (correct, but P*V*W transcendental operations
    per call)."""
    if plan is not None:
        if plan.block != w:
            raise ValueError(f"plan is for block {plan.block}, got {w}")
        return plan.drive_matrix, plan.decay[..., 0], plan.decay[..., 1]
    else:
        pr, pi = constant.poles[..., 0], constant.poles[..., 1]
        radius = torch.sqrt(pr * pr + pi * pi)
        angle = torch.atan2(pi, pr)
        n = (w - 1) - torch.arange(w, dtype=torch.float32, device=pr.device)
        mag = torch.pow(radius[..., None], n)
        ang = angle[..., None] * n
        ramp = torch.stack([mag * torch.cos(ang), mag * torch.sin(ang)], dim=-1)
        mag_w = torch.pow(radius, float(w))
        decay_re, decay_im = mag_w * torch.cos(angle * w), mag_w * torch.sin(angle * w)
    return _drive_layout(ramp), decay_re, decay_im


def _drive(ramp2: torch.Tensor, x: torch.Tensor, p: int, v: int) -> torch.Tensor:
    """x [..., W] -> sum_n c^(W-1-n) x[n] as pairs [..., P, V, 2]: one
    float32 matrix product for all leading axes. The blocks are folded to
    one [rows, W] matrix first (``torch.matmul`` on a strided view with
    leading axes runs a batch of one-row products instead, each reading the
    whole ramp)."""
    _full_f32_matmul(x)
    return torch.mm(x.reshape(-1, x.shape[-1]), ramp2.t()).reshape(x.shape[:-1] + (p, v, 2))


def resonate_block(
    constant: ResonatorConstant,
    state: torch.Tensor,
    x: torch.Tensor,
    plan: ResonatorBlockPlan = None,
) -> torch.Tensor:
    """Advance the bank over a block: state [..., P, V, 2], x [..., W] real.

    Closed form (see module docstring): one real [P*V*2, W] x [W] product
    per batch element for the drive (the input is real, so the re and im
    ramps are two real products, here one), then one complex
    multiply-add on pairs. ``plan``: precomputed ramp
    (:func:`make_block_plan`). Returns the new state; ``state`` is not
    modified."""
    ramp2, decay_re, decay_im = _ramp(constant, x.shape[-1], plan)
    drive = _drive(ramp2, x, constant.num_pixels, constant.vectors)
    return _advance(state, drive, decay_re, decay_im)


def resonate_chunks(
    constant: ResonatorConstant,
    state: torch.Tensor,
    chunks: torch.Tensor,
    valid=None,
    plan: ResonatorBlockPlan = None,
    emit_readouts: bool = False,
):
    """Advance the bank over T time-ordered chunks in one call.

    The production streaming path (ref: continuous resonate over blob
    chunks, TransformDSP.inl:1163-1211): a render tick consumes every
    pending chunk. One matrix product gives all T chunks' drives; the
    T-step recurrence ``z = z * c^W + drive_t`` then runs in order,
    skipping chunks that are not valid (on a GPU: kernel H, one launch,
    :func:`~signalizer_tpu_torch.kernels.resonator_scan.resonator_scan`).

    Args:
      chunks: [..., T, W] — T sequential blocks per batch element.
      valid: optional [T] bool; False chunks leave the state untouched
        (padding to a fixed T).
      plan: precomputed ramp for W (recommended: without it the ramp is
        recomputed on the device every call).
      emit_readouts: also return the windowed magnitude readout after
        every chunk [T, ..., P] (the RSNT spectrogram semantic — one
        column per blob).

    Returns final state, or ``(final_state, readouts)``.
    """
    scan = resonate_and_read(constant, state, chunks, valid, plan, emit_readouts)
    return (scan.state, scan.readouts) if emit_readouts else scan.state


def resonate_and_read(
    constant: ResonatorConstant,
    state: torch.Tensor,
    chunks: torch.Tensor,
    valid=None,
    plan: ResonatorBlockPlan = None,
    emit_readouts: bool = False,
) -> ScanResult:
    """:func:`resonate_chunks` and the windowed readout of the final state
    (``re``, ``im`` and the magnitude [..., P], as
    :func:`resonator_readout_complex` and :func:`resonator_readout` give
    them) in one :class:`~signalizer_tpu_torch.kernels.resonator_scan.ScanResult`."""
    ramp2, decay_re, decay_im = _ramp(constant, chunks.shape[-1], plan)
    drives = _drive(ramp2, chunks, constant.num_pixels, constant.vectors)  # [..., T, P, V, 2]
    return resonator_scan(
        state, drives, decay_re, decay_im, constant.combine, constant.gain, valid, emit_readouts
    )


def resonator_readout_complex(
    constant: ResonatorConstant, state: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed COMPLEX readout (re, im) [..., P] — the vectors before
    |.| (ref: copyResonatorStateInto / getWholeWindowedState; the Phase
    branch of mapResonatingSystem consumes these,
    TransformDSP.inl:1111-1127). Normalized by the bank gain. The sum over
    the 2K+1 vectors is an elementwise multiply and a sum (no matmul)."""
    return readout_complex_plain(state, constant.combine, constant.gain)


def resonator_readout(constant: ResonatorConstant, state: torch.Tensor) -> torch.Tensor:
    """Windowed magnitude readout (ref: getWholeWindowedState usage,
    TransformPair.h copyResonatorStateInto): combine the 2K+1 vectors with
    the window coefficients, normalize. state [..., P, V, 2] -> [..., P]."""
    z_re, z_im = resonator_readout_complex(constant, state)
    return torch.sqrt(z_re * z_re + z_im * z_im)
