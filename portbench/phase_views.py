"""The session of the Spectrum's PHASE view: what a cell of a PHASE
configuration calls in its window, what it reads back, and how its outputs
are judged.

:class:`PhaseBatch` drives ``SpectrumProcessor.process`` in PHASE on
``[pairs, T, 2, W]`` frames cut as a strided view from resident audio, as
:class:`portbench.spectrum_views.SpectrumBatch` does for the magnitude
modes, and reads back the newest display row of each pair
``[pairs, K, 2, P]``: the mid's decayed peak and the smoothed phase
cancellation. Both carried states, the magnitude's and the phase's, are
judged after the window.

The reference (:mod:`portbench.reference.phase`) follows the states from
zero over the ``horizon_frames`` frames before each checked call. The phase
state forgets only by ``pole ** (0.3 * frames)``: 7.6e-6 for the 1 s line
graph after 1024 frames, 6e-11 after 2048, which the cell's traffic sets.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.phase import PhaseReference, phase_design
from portbench.reference.spectrum import db_map
from portbench.spectrum_views import F32, PortSpectrum, SpectrumBatch, rows_of, widest_gap

# A display value (1 = the 96 dB display range) this far from the reference
# is more than float32's rounding explains where no argbin decides: the
# interpolation region's widest gaps read ~2e-5 at the cell's geometry. In
# the bin-max region it marks a flipped argbin's trace (two bins of noise
# whose float64 powers agree to float32's rounding: the program may take the
# other one, which moves that pixel's mid by up to 6 dB and its cancellation
# by O(0.1) for a frame, and the states after it for some frames), or a
# fault; such values are counted as a share with a limit of its own.
OFF = 1e-3
# The phase row of the stream's first frames is not judged. From a zero
# state the phase state is the sum of a few frames' cancellations,
# ``1 - |L + R| / (|L| + |R|)``, which float32 rounds to ~6e-8 absolute: where
# the channels happen to agree in phase at each of those frames, that is the
# whole value, and its logarithm is any number (on the card: up to 382 display
# units at frame 0, 1.7e-3 at frame 1, under 2e-4 from frame 2). For a gap of
# 1e-3 every one of n cancellations must fall under ~5e-6, a chance of ~2e-3
# each: after 8 frames, ~1e-21 a pixel.
YOUNG = 8


class PortPhase(PortSpectrum):
    """The program: ``SpectrumProcessor.process`` in PHASE; both states
    carry."""

    def state_phase(self) -> torch.Tensor:
        return self.processor.state.phase


class ReferencePhase:
    """The reference in ``dtype`` in the program's place (the control)."""

    def __init__(self, d, pairs: int, dtype, device):
        self.ref = PhaseReference(d, pairs, dtype, device)

    def process(self, frames):
        return self.ref.process(frames.contiguous()).float()

    def state_magnitude(self) -> torch.Tensor:
        return self.ref.state.float()

    def state_phase(self) -> torch.Tensor:
        return self.ref.phase.float()


def _gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in float64; a NaN on either side counts as inf."""
    gap = (got.double() - want.double()).abs()
    return torch.where(torch.isnan(gap), math.inf, gap)


def _widest(gap: torch.Tensor) -> float:
    return float(gap.max()) if gap.numel() else 0.0


class PhaseBatch(SpectrumBatch):
    """``pairs`` x ``frames_per_call`` frames a call at hop ``hop`` in
    PHASE, cut from ``spans`` consecutive spans of resident audio in turn."""

    def __init__(self, cfg: dict, traffic: dict, device, seed: int, program=None, build=None):
        if cfg["view"]["channels"] != "PHASE":
            raise ValueError(f"PhaseBatch runs the PHASE view, not {cfg['view']['channels']!r}")
        # the base class's design and program are the SEPARATE view's; both are replaced below
        separate = {**cfg, "view": {**cfg["view"], "channels": "SEPARATE"}}
        super().__init__(separate, traffic, device, seed, program=_NONE)
        self.view = cfg["view"]
        self.design = phase_design(self.view)
        if program == "control":
            program = ReferencePhase(self.design, self.pairs, torch.bfloat16, self.device)
        self.program = program if program is not None else PortPhase(build(self.view, self.pairs, self.device))

    def reference_at(self, k: int):
        """``(output, reference)`` of call ``k`` by the float64 reference,
        replayed from zero over the calls of the horizon that end at it."""
        ref = PhaseReference(self.design, self.pairs, torch.float64, self.device)
        for j in range(max(0, k - self.horizon_calls + 1), k + 1):
            out = ref.process(self.frames(j))
        return out, ref

    def final_state(self) -> dict:
        return {"magnitude": self.program.state_magnitude().clone(), "phase": self.program.state_phase().clone()}

    def work(self) -> dict:
        """Each stage's least work a call. ``phase_decay_db`` (kernel G): the
        values [pairs, T, 2, P] read once, the display values
        [pairs, T, K, 2, P] written once, the magnitude state's row 0 and the
        phase state [pairs, K, P] each read and written once, the slope map
        read once; ~30 operations a display value. ``step``, the whole call:
        the audio span read once, the display values written once, both
        states read and written once, the newest rows across the host
        link."""
        v, t = self.view, self.frames_per_call_of_pair
        k, p, pairs = int(v.get("line_graphs", 2)), int(v["axis_points"]), self.pairs
        vals = pairs * t * 2 * p * F32
        out = pairs * t * k * 2 * p * F32
        states = 2 * pairs * k * p * F32
        g = {"bytes": float(vals + out + 2 * states + p * F32), "flops": 30.0 * out / F32}
        audio = pairs * 2 * self.span_len * F32
        carried = pairs * k * (rows_of(v) + 1) * p * F32
        step = {"bytes": float(audio + out + 2 * carried), "flops": g["flops"],
                "pcie_bytes": float(pairs * k * 2 * p * F32)}
        return {"phase_decay_db": g, "step": step}

    def check(self, kept: dict, host: dict, final: dict, calls: int) -> dict:
        """The numbers compared, all in display units (1 = the display's dB
        range) but the share:

        * ``mid_gap``, ``phase_gap``: the widest gap of the mid row and of
          the phase row of any kept call, over the interpolation region's
          pixels (no argbin decides there);
        * ``state_gap``, ``phase_state_gap``: the widest gap of the carried
          magnitude state and phase state, over the same pixels;
        * ``binmax_off``: the share of the bin-max region's values (both
          rows of every kept call, both states) off by more than ``OFF``;
        * ``readback_gap``: a read-back row against the device's.

        The phase row of the stream's first ``YOUNG`` frames is left out."""
        interp = torch.from_numpy(self.design.plan.interp_mask).to(self.device)
        mid = phase = readback = 0.0
        binmax = []
        refs = {}
        for k in sorted(kept):
            want, refs[k] = self.reference_at(k)
            gap = _gaps(kept[k], want)  # [pairs, T, K, 2, P]
            gm, gp = gap[..., 0, :], gap[..., 1, :]
            gp = gp[:, max(0, YOUNG - k * self.frames_per_call_of_pair):]
            mid = max(mid, _widest(gm[..., interp]))
            phase = max(phase, _widest(gp[..., interp]))
            binmax += [gm[..., ~interp].flatten(), gp[..., ~interp].flatten()]
            if k in host:
                readback = max(readback, widest_gap(torch.from_numpy(host[k]), kept[k][:, -1].cpu()))
        ref = refs[calls - 1] if calls - 1 in refs else self.reference_at(calls - 1)[1]
        t = ref.tables
        sm = _gaps(db_map(t, final["magnitude"].double()), db_map(t, ref.state))  # [pairs, K, 2, P]
        sp = _gaps(db_map(t, final["phase"].double()), db_map(t, ref.phase))  # [pairs, K, P]
        binmax += [sm[..., ~interp].flatten(), sp[..., ~interp].flatten()]
        binmax = torch.cat(binmax)
        return {"mid_gap": mid, "phase_gap": phase, "state_gap": _widest(sm[..., interp]),
                "phase_state_gap": _widest(sp[..., interp]),
                "binmax_off": float((binmax > OFF).double().mean()) if binmax.numel() else 0.0,
                "readback_gap": readback}


_NONE = object()  # stands in for the program while the base class is set up
