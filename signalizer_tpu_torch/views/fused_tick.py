"""All-views session tick over the shared device ring.

The reference renders every view off the same retained history ring each
frame (ref: Source/Spectrum/SpectrumRendering.cpp:620-635 re-reading
history per render frame; all views consume one presentation stream).

The port's counterpart of :mod:`signalizer_tpu.views.fused_tick`. The JAX
module fuses spectrum + oscilloscope + vectorscope into one jitted step;
here nothing is traced, so :func:`run_fused_tick` is a plain function that
runs the three steps back to back on the device ring's windows, with no
host synchronization between them, and reads back once at the end: the
spectrum row (and, in the Cycles time mode with the spectral trigger, the
oscilloscope's cycle feedback). The per-view path reads the spectrum back
before it launches the oscilloscope, so there the device idles while the
host prepares the next step.

Parity contract: outputs and carried states are bit-equal to the per-view
path. Mechanism: the same step functions (``analyze_frames``, ``osc_step``,
``vs_step``) on the same windows of the ring, copied to contiguous rows
where the per-view processors copy them (the spectrum's frames, the
oscilloscope's history), and the host-side bucket and scalar prep shared
with the processors (their ``_prep_step``), so both paths launch the same
kernels on the same inputs. Locked by tests/test_torch_fused_tick.py.
"""

from __future__ import annotations

import numpy as np

from signalizer_tpu_torch.kernels.spectrum import analyze_frames
from signalizer_tpu_torch.views.oscilloscope import osc_step
from signalizer_tpu_torch.views.vectorscope import vs_step


def run_fused_tick(session, dh, new_samples: int, transport: float):
    """Run one all-views tick for ``session`` off device history ``dh``.

    Returns ``(spectrum [K, rows, P] np.ndarray, OscilloscopeFrame,
    VectorscopeFrame)`` with all three processors' states advanced, or
    ``None`` when the fused path is ineligible (a view missing, an RSNT
    spectrum — it consumes the continuous stream, not the ring — or a
    window exceeding the ring), so that the caller takes the per-view path
    for this tick.
    """
    from signalizer_tpu_torch.views.spectrum import SpectrumProcessor

    sproc = session._processors.get("spectrum")
    oproc = session._processors.get("oscilloscope")
    vproc = session._processors.get("vectorscope")
    if sproc is None or oproc is None or vproc is None:
        return None
    if not isinstance(sproc, SpectrumProcessor):
        return None
    ring = dh.ring
    if ring is None or ring.shape[0] < 2:
        return None
    h = dh.history
    spec_w = sproc.constant.window_size
    # oscilloscope history need: same pow2 bucketing as the per-view path
    cap = session.engine.presentation_output.info.audio_history_capacity
    win = float(oproc.effective_window_samples())
    need = max(16384, 1 << int(np.ceil(np.log2(max(2.0 * win, 1.0)))))
    osc_n = min(need, cap)
    vs_w = session._vs_window()
    if spec_w > h or osc_n > h or vs_w > h:
        return None
    osc_ns = min(int(new_samples), osc_n)
    window, chunk, env_os, cycles_live = oproc._prep_step(osc_n, osc_ns)
    vs_mw = session._vs_meter_window(new_samples, vs_w)
    vs_frames = dh.window(vs_w, lead=1)
    vs_scalars, vs_ns = vproc._prep_step(vs_w, new_samples, meter_w=vs_mw)

    # kernel A takes contiguous rows, as SpectrumProcessor._frames gives them
    spec_frames = dh.window(spec_w, lead=2, pad_to=2).contiguous()
    res = analyze_frames(sproc.constant, sproc._state, spec_frames).results
    osc_frame, oproc._state = osc_step(
        oproc.constant, oproc._state, dh.window(osc_n, lead=1).contiguous(),
        window, float(transport), float(osc_ns), oproc._pair_keys,
        trigger_chunk=chunk, env_os=env_os,
    )
    vs_frame, vproc._state, vproc._peak_env = vs_step(
        vproc._state, vproc._peak_env, vs_frames, *vs_scalars, vs_ns,
        dh.window(vs_mw, lead=1),
        mode=vproc.mode, autogain=vproc.autogain, scale_to_fill=vproc.scale_to_fill,
    )
    if cycles_live:
        oproc._post_cycle_feedback(osc_frame)
    return res[0, -1].cpu().numpy(), osc_frame, vs_frame
