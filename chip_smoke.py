#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU: the Spectrum
view (FFT path and resonator bank), the Oscilloscope, the Vectorscope, the
Spectrogram, the live ingest path that feeds them from an audio stream, the
engine and session tick that a user drives, the multi-device pipeline on a
one-GPU mesh, and the front ends (the CLI and the browser editor).

    python3 chip_smoke.py

Phases, each printing one informational line:

1. device — name, CUDA version, ``nvidia-smi`` name and power limit, TF32 off;
2. build — the kernel sources in ``signalizer_tpu_torch/csrc`` with ``nvcc``
   (one process per source, all started together);
3. kernel A (window -> FFT -> |.|) against its plain PyTorch version at the
   headline shape, at small COMPLEX, PHASE and zero-padded shapes, in every
   real mode at a small N, at N = 32, 16384 and 32768, with an odd window
   length, and with an all-zero channel beside a loud one (exactly zero
   out); ``torch.fft.rfft`` of the already windowed rows is timed beside it
   as the one library call that does part of its work;
4. kernel B (remap -> decay -> dB) against its plain version at the
   headline shape, at T=1, at T=127 and T=128 with padded (invalid) frames,
   with no valid frame at all, and with 1 and 8 line graphs at a small
   shape; in every case the carried state must equal the plain version's
   bit for bit on the pixels whose remapped value has no tap sum;
5. the slice end to end: a seeded 48 kHz stereo stream for 16 channel
   pairs, framed at hop 800 (60 fps), through ``SpectrumProcessor`` in three
   T=128 calls and three T=1 calls, held against the plain functions on the
   same CUDA tensors, with launch counts, finiteness, sine-peak and silence
   checks;
6. kernel C (banded resample) against its plain version at the
   oscilloscope's cfg3 shape (Lanczos with the nearest pick, linear,
   nearest), a 160-pixel tail block, a 16384-sample window over 1024 px,
   positions off both edges, the colour track's six rows, a = 5 and a = 16
   (the form with a run-time a), one pixel, and positions on samples and
   within 1e-6 of them; at cfg3, the edges and the zoom-out the kernel
   forming its positions itself is held against the same kernel reading
   them from a tensor;
7. the oscilloscope slice: a seeded 96 kHz stereo stream for 16 pairs,
   advanced 1600 samples (60 fps) per call over a 16384-sample history,
   through ``OscilloscopeProcessor`` at cfg3 (ZERO_CROSSING), cfg3b
   (SPECTRAL) and cfg3 with the colour track, three calls each, each call
   held against the same step with its resamples on kernel C's plain
   version from the same carried state, with launch counts, finiteness,
   trigger, fundamental and silence checks (with the colour track, kernel E
   once a call on the main path, and the call timed: it must fit a 60 fps
   frame; at cfg3b kernel F once a call, the walk's plain version in the
   call it is held to (the median history equal too), the passes a call
   from kernel F's device counter); the synchronizing operations of one
   more call of each and their sites (cfg3b: as many as cfg3's, none in the
   oscilloscope's modules); then cfg3 with the
   ENVELOPE_HOLD trigger (kernel D's fused entry, once a call), three calls
   each held to the same step with the trigger's plain version (every
   frame field and the fire queue bit-equal), and the call timed: it must
   fit a 60 fps frame (16.7 ms);
8. kernel B's other two entries (after phase 4): the remap alone at the
   headline shape and at T=1, decay-and-dB alone on the headline's remapped
   values, at T=1, with 127 of 128 frames valid, a ragged T=127, no valid
   frame, 1, 8 and 11 line graphs and the spectrogram's cfg4 shape (1 pair x
   512 frames x 1 row, where the kernel splits T into chunks) (state
   bit-equal to the plain loop everywhere), and the two in turn against the
   fused entry (bit-equal);
   then ``spectrum_values`` + ``post_process`` on the slice's frames against
   ``analyze_frames`` (after phase 5);
9. the Vectorscope at the bench geometry (bench.py:743-767: 256 stereo
   streams x 4096 samples), every mode and autogain, against the same
   processor on the CPU, with the balance, correlation and silence checks;
10. the Spectrogram: the batched step (bench.py:881-924: 16384-point
   window, 1024 px, 1 pair x T=512 with a validity mask) against the plain
   versions by bytes, and the production tick (bench.py:940-992: 240 pushes
   of 800 samples, a pull each) by both ingest routes, byte-equal, with
   launches, readbacks (syncs) and p50/p99 ms per pull, the sine's pixel,
   black silence, the lag under one hop and no drops; 16 pairs against the
   CPU by bytes;
11. the resonator Spectrum at the headline constant, 16 pairs: six ticks of
   800 samples and a backlog of T=16 chunks of 512 with the last 3 invalid
   (bench.py:1052-1114), each call against the same step with the plain
   ``decay_db`` tail and kernel H's plain loop on the same tensors (the
   bank bit-equal; kernel H once a call), the two tones' pixels, and the
   invalid chunks' guarantees; then kernel H (phase 22);
12. kernel A on rows above 32768 points (COMPLEX above 16384): the cluster
   form (a thread-block cluster a row, to 131072 points, COMPLEX 65536)
   against its plain version at N = 65536 and 131072, COMPLEX at 32768 and
   65536, every mode at 65536, W < N and odd W, and the two-pass form
   (through a scratch tensor) at N = 262144 and 2^20 and COMPLEX 131072,
   each case on the counter of its form, silent channels beside loud ones
   (exactly zero out); the cluster form timed at 16 pairs x 16 frames of
   48000 samples with 2, 4 and 8 blocks a cluster (and at 16 pairs x 4
   frames of N = 131072 with 4 and 8), the two-pass form's kernels called
   on the same rows as a yardstick, and ``torch.fft.rfft`` of the already
   windowed rows beside it; then the Spectrum at a
   200000-sample window (N = 262144) for 16 pairs, three calls through
   ``SpectrumProcessor.process``, the two-pass form's main path; and the
   two-pass form on one pair at N = 2^20 and 2^21, timed beside
   ``torch.fft.rfft`` and its bound;
13. the live ingest path: a threaded 16-channel ``AudioStream`` at 48 kHz
   with the default 48000-sample history (native packet queue and native
   ring, required here), a second stereo instance mixed into the last pair
   through ``HostGraph.connect`` and ``MixGraph``, and a
   ``DevicePresentationHistory`` on the card; 240 ticks of 800-sample
   blocks, each a ``sync`` and then the Spectrum at the headline constant
   and at a 48000-sample window (the cluster form), the Oscilloscope on 16384
   samples and the Vectorscope on 4096, all reading windows of the device
   ring; every window equal to ``get_history`` bit for bit at every tick
   and after a stall longer than the ring (one re-prime); bytes uploaded a
   tick, ``sync`` µs, ms a tick (p50, p99), launches and syncs a tick, the
   long Spectrum's sine peaks (the last pair's from the mixed-in peer), both
   Spectrum processors against their plain versions;
14. the session: ``SignalizerEngine`` on the card at the factory default
   preset (2 channels, 48 kHz, a 48000-sample history: a 4096-point LEFT
   spectrum on a 1024-px LOGARITHMIC axis, a Lanczos oscilloscope, a
   4096-sample Lissajous vectorscope) with the frequency tracker on its
   Transform source, and ``AnalysisSession`` with all four views at 1024 px
   and the fused tick; 240 ticks of 800 samples of a seeded stereo pair of
   sines (1000 and 1500 Hz) in noise, each tick checked (finite outputs, a
   column array; from the tick the spectrum's window is full, the left
   sine's pixel and the tracker within one bin of 1000 Hz); ms a tick (p50,
   p99), kernels A, B and C launched on it (the ``kernels`` line's counts for
   them), syncs a tick on the last 10, every tick fused, no fallback and no
   contained failure; the same blocks through a per-view session (every
   frame bit-equal), the first 24 through a CPU session (the kernels' plain
   versions, each view within its kernels' card tolerance); 24 ticks of an
   RSNT session against the same on the CPU (kernel B's decay-and-dB entry
   once a tick with a chunk; its count is the ``kernels`` line's), of a
   ZERO_CROSSING trigger with RMS vectorscope autogain and a window-size
   change (``reconfigure``) fused against per-view, and of an engine
   serialized, closed and restored into a fresh one (the same frames);
   and a session at the factory preset ``peak trigger.oscilloscope`` (the
   ENVELOPE_HOLD trigger: kernel D's fused entry once a tick), 24 ticks
   against the same on the CPU, with ms a tick (p50, p99), kernel D's
   launches, over 4 more ticks syncs a tick and their sites; a session at
   the factory preset ``coloured.oscilloscope`` (the spectral-energy
   colour track: kernel E's fused entry once a tick) the same way, its
   colours within 1e-3 of the CPU session's; a session at the factory
   preset ``cycles.oscilloscope`` (the SPECTRAL trigger in the Cycles time
   mode: kernel F's filtered entry once a tick), 24 ticks bit-equal to the
   same session with the walk's plain version on the card and against the
   CPU (fundamentals and Cycles windows within rtol 1e-5, the waveform
   within ``CYCLES_WAVE_TOL`` x gain, the envelopes' distance reported,
   the other views at their tolerances; the CPU's resample at the card's
   window start within kernel C's tolerance of the card's); and over 40 more
   ticks ms a tick of
   the three side sessions timed in turns with the main session (the
   median of the pairwise differences; the coloured tick's p50 must fit a
   60 fps frame); the main session makes 3 syncs a tick (its readbacks),
   the `cycles` session one more (the Cycles window's readback);
15. profile — ``torch.profiler`` over 20 T=128 and 20 T=1 calls of the
   Spectrum slice on device-resident frames and 20 cfg3 oscilloscope calls
   gives the device time per kernel; the same 20 calls timed again without
   the profiler give the host wall time per call, and the device busy
   share is kernel time over that wall time; the cfg3 Lanczos resample
   alone is profiled by both routes (positions formed in the kernel, and a
   position tensor built by torch operations) to count the launches of
   each; one Vectorscope call, the Spectrogram's batched step and one pull,
   the ring's window copy alone, one resonator tick and one backlog call,
   decay-and-dB alone at T = 1 and at cfg4, the two-pass form at N = 2^20
   and 2^21, the cluster form at its timed shape, the two-pass form's
   kernels on the same rows, the 200000-sample Spectrum call, one live
   tick, one session tick, the ENVELOPE_HOLD cfg3 call, kernel D's two
   entries alone, the cfg3 call with the colour track, kernel E's two
   entries alone at cfg3, the cfg3b call, kernel F's filtered entry alone
   at cfg3b and on one row, the ``peak trigger``, ``coloured`` and
   ``cycles`` session ticks and (over 3 calls) the pipeline's cfg5 tick are
   profiled the same way; a ``trigger_profile`` line sets the launches,
   device µs and wall µs of the ENVELOPE_HOLD call and the ``peak trigger``
   session tick beside cfg3's ZERO_CROSSING call and the default session
   tick, a ``colour_profile`` line those of the colour track's call and
   session tick beside the same, and a ``spectral_profile`` line those of
   the cfg3b call and the ``cycles`` session tick;
16. kernel D (the envelope-hold scan; after phase 6), both entries against
   their plain versions on the same CUDA tensors, bit for bit: the
   function entry (fires, state, holding) against the loop and the fused
   entry (state, holding, the fire-age queue, found, the window start)
   against ``envelope_hold_trigger_plain``, at 16 rows with 1600 of 2048
   samples consumed (cfg3's tick) and all of 8192, 1 row of 1 sample, 33
   rows of 1600, 16 rows of 8192 with 1 and with none consumed, hysteresis
   0 and 0.5, three calls each with the state carried; the fused entry also
   with a fractional ``new_samples``, more new samples than the chunk, more
   than 8 fires in a row, no fire, and carried ages out of order that pass
   the history's length; a NaN sample and a row of NaN, a held peak falling
   at sample 0, device scalars over rows strided out of a history, and (the
   function entry) a device mask; the largest errors and the mismatched
   bytes are printed; each entry timed at cfg3's tick and lookahead beside
   its plain version, the bound and the serial chain's estimate, and
   profiled alone there (phase 15);
17. the multi-device pipeline (after phase 14): ``ShardedAnalysisPipeline``
   on a one-GPU mesh fed by ``push``, the fused view at cfg5
   (bench.py:994-1050: 4 pairs x 128 frames of a 4096-point SEPARATE
   spectrum at 192 kHz, LINEAR, a LOGARITHMIC axis of 1024 px, 1024 px of
   waveform and envelopes, the meters), the spectrum (headline), the
   spectrogram (cfg4), the oscilloscope (cfg3) and the vectorscope (cfg2),
   three ticks each, each tick held against the same step built from the
   plain versions on the tensors it uploaded (the vectorscope against the
   pipeline on the CPU); launches, ms a tick, the device's busy share;
18. the front ends: ``python -m signalizer_tpu_torch analyze-batch`` on 4
   seeded WAV files, ``analyze --npz`` on one of them (kernels A, B and C
   counted), and an ``EditorShell`` on localhost at the factory default
   preset serving a payload of each view and the spectrogram PNG;
19. kernel E (the colour track: the 3-band crossover, the band energies'
   smoothers, the colour mix; after phase 16), both entries against their
   plain versions (the doubling scans) on the same CUDA tensors and a
   float64 oracle (scipy's ``lfilter``): the split (bands, crossover
   state) and the fused colour track (colours, both states), at cfg3's 16
   pairs x 2 rows x 16384 from a zero and a carried state, one pair's two
   rows of 16384 (the session's history) and 3 x 2 x 3001 (W no multiple
   of the chunk), two calls each with the states carried, a silent row in
   each and a denormal row where there are four rows or more; and the
   fused entry on bands it is given; colours within 1e-3 of the
   plain version's, bands and states no further from the oracle than 2x
   the plain version's own error; each case's row split (``colour_plan``:
   threads, blocks a cluster) reported; timed at cfg3 beside the plain
   version and the bound, and profiled alone there (phase 15);
20. kernel F (the spectral trigger's walk and median filter; after phase
   19), its four entries against their plain versions on the same CUDA
   tensors, bit for bit (record, passes, history): the spectrum entries
   (which form each bin's magnitude and quadratic offset from the rfft)
   against ``spec.abs()``, ``_quad_delta`` and the plain loop, the bins
   entries against the plain loop (then ``median_record_filter``): the
   rfft of 1, 16 and 33 lookaheads of 8192 samples (sines, harmonics,
   chords, the last row silent), threshold and hysteresis 0 and (0.1,
   0.4), as host numbers and device scalars, the filtered entries over
   three calls with a history holding -1 sentinels; spectra with zeros,
   NaN, +-inf and (1, -1) denominators, every other row of a batch, and
   the 280-pass cap through a real spectrum rising 1.01 a bin; bins fed
   directly: the longest chain float32 allows (276 doublings from the
   smallest subnormal), one from the smallest normal, a chain of 36 bins
   4x apart, and the 280-pass cap; the spectrum entry timed at cfg3b (16
   x 4094 bins) and on one row beside the plain version, the bound, the
   chain's estimate (its passes times a pass's device cost, profiled at
   the 280-pass cap in phase 15), and profiled alone there (phase 15);
21. kernel G (the PHASE display tail: the mid row's decay, the phase
   smoothing, the dB map; after phase 11) against its plain version (the
   loops over T) on the same CUDA tensors: the headline in PHASE at T = 128
   and T = 1, with its last 3 frames invalid, cfg4's 1 pair x 512 frames,
   a ragged P = 1001, K = 1, 2 and 11 line graphs; both states bit-equal
   (row 1 of the magnitude untouched), the display within 1e-5; each
   case's plan (``phase_plan``: frames a chunk, chunks; cfg4 in 16 chunks
   behind a walk pass, T = 1 by the tick kernel) reported; timed at the
   headline, T = 1 and cfg4 beside the plain loops and the bound; then
   the PHASE Spectrum at the headline through ``SpectrumProcessor`` (three
   T = 128 and three T = 1 calls: kernel A, the PHASE values and kernel G
   once a call, B never, against kernel A's output through the plain values
   and the plain tail, states bit-equal) and the spectrogram's cfg4 step in
   PHASE with its host mask (the values and kernel G once, the columns
   within a byte of the plain tail's), each with 0 syncs, timed;
22. kernel H (the resonator bank's chunk recurrence and readouts) against
   its plain loop on the same drives: the cfg6 tick and backlog (the last 3
   chunks invalid) from the bank's state, with and without a readout after
   every chunk (state bit-equal, readouts within 1e-6 of each row's peak),
   timed at the backlog beside the plain loop and the bound; a PHASE bank at
   the headline constant (kernels H and G once a call, against the plain
   scan and tail); the RSNT session (phase 14) runs H once a bank call and
   its tick is timed. The profile phase adds the PHASE calls, G and H
   alone (G by the device functions each call runs), the PHASE backlog and
   the RSNT session tick, and a
   ``tail_profile`` line sets their launches (the PHASE T = 128 call at
   most 5, the cfg6 backlog 25, the tick 12), device µs and wall µs beside
   the default session tick's;
23. the PHASE values kernel (before phase 21) against ``phase_values_plain``
   on the same CUDA spectra, bit for bit: kernel A's PHASE output of the
   headline's 16 pairs x 128 frames, then seeded spectra at the sizes of
   kernel A's cluster and two-pass forms (65536 and 2^21 points, where the
   chunks reach 249 and 7948 bins and the kernel walks each with 8 and 32
   lanes) at T = 1 and 128; each timed beside the plain path and the
   bound; the profile phase adds its device time in the PHASE T = 128,
   T = 1 and cfg4 calls.

The Spectrum headline geometry is the repo's bench cell (bench.py:240-266):
a 4096-sample window at 48 kHz, SEPARATE stereo, LINEAR bin interpolation, a
LOGARITHMIC axis of 1024 pixels, 2 line graphs, 16 pairs x 128 frames. The
oscilloscope's cfg3 is the repo's bench geometry (bench.py:769-822): 16
SEPARATE stereo pairs at 96 kHz, ZERO_CROSSING at 0.1 over an 8192-sample
lookahead, LANCZOS (a = 10) of a 1024-sample window upsampled to 8192
pixels, PEAK_DECAY autogain; cfg3b swaps in the SPECTRAL trigger
(bench.py:824-879). Kernel times (``ms``, ``plain_ms``, ``library_ms``) are medians of
CUDA-event timings over four calls queued back to back; ``profile_us`` is
the kernel's device time per launch on the main path, from the profile
phase; call times are medians of host-clock timings ending in a
synchronize. Each
kernel's ``bound_ms`` is the least time the card could take for the call it
was timed on: the larger of its bytes (every input read once, every output
written once) over 3.35 TB/s and its float32 operations over 67 TFLOP/s,
both counted from the shapes. The last three lines are a JSON object of the
kernels, the card's name and power limit, and a JSON object
``{"ok": true, "device": ...}``; any failed check raises and exits non-zero
before them. Without a CUDA
device the script exits non-zero and prints no result. It imports no jax.
"""

from __future__ import annotations

import collections
import contextlib
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

sys.modules["jax"] = None  # any jax import below fails loudly

from signalizer_tpu_torch.utils.diagnostics import count, counter, reset_counters  # noqa: E402

FS = 48_000.0
WINDOW = 4096
AXIS_POINTS = 1024
PAIRS = 16
T = 128
HOP = 800  # 48 kHz / 60 fps
REPS = 25
# the card's published peaks (H100 SXM): device memory rate, float32 rate
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
KERNELS = {
    "window_fft_mag": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/window_fft_mag.cu",
        replaces="signalizer_tpu/kernels/pallas_spectrum.py:147",
    ),
    "display_map": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/display_map.cu",
        replaces="tools/pallas_display_map.py:233",
    ),
    # kernel B's two other entries: the remap alone and decay-and-dB alone
    # (the latter a kernel of its own)
    "display_remap": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/display_map.cu",
        replaces="tools/pallas_display_map.py:233",
    ),
    "display_decay_db": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/display_decay_db.cu",
        replaces="tools/pallas_display_map.py:233",
    ),
    "banded_resample": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/banded_resample.cu",
        replaces="signalizer_tpu/kernels/pallas_resample.py:185",
    ),
    # kernel A's two-pass form: rows above 131072 points (COMPLEX 65536)
    "window_fft_mag_long": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/window_fft_mag_long.cu",
        replaces="signalizer_tpu/kernels/pallas_spectrum.py:147",
    ),
    # kernel A's cluster form: rows above 32768 points (COMPLEX 16384) up
    # to 131072 (65536), a thread-block cluster a row
    "window_fft_mag_cluster": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/window_fft_mag_cluster.cu",
        replaces="signalizer_tpu/kernels/pallas_spectrum.py:147",
    ),
    # kernel D: the envelope-hold trigger's scan (a lax.scan, not Pallas)
    "peak_hold": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/peak_hold.cu",
        replaces="signalizer_tpu/kernels/oscilloscope.py:94",
    ),
    # kernel E: the colour track's scans (lax.associative_scans, not Pallas:
    # _recurrence_scan under three_band_split, onepole_smooth under
    # signalizer_tpu/kernels/oscilloscope.py:726 spectral_colour_track)
    "colour_track": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/colour_track.cu",
        replaces="signalizer_tpu/kernels/filters.py:66",
    ),
    # kernel F: the spectral trigger's walk (the lax.while_loop of
    # spectral_fundamental, not Pallas) and the median filter after it
    "spectral_walk": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/spectral_walk.cu",
        replaces="signalizer_tpu/kernels/oscilloscope.py:280",
    ),
    # kernel G: the PHASE display tail (the lax.scan of the phase smoothing
    # and peak_decay_scan's lax.associative_scan, peak_decay.py:93, under
    # post_process; not Pallas)
    "phase_decay_db": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/phase_decay_db.cu",
        replaces="signalizer_tpu/kernels/spectrum.py:575",
    ),
    # kernel H: the resonator bank's chunk recurrence and readout (the
    # lax.scan of resonate_chunks; not Pallas)
    "resonator_scan": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/resonator_scan.cu",
        replaces="signalizer_tpu/kernels/resonator.py:313",
    ),
    # the spectrogram's colour map: the gradient walk, the pair blend and the
    # RGBA8 quantize in one launch (the JAX package maps with plain jnp,
    # signalizer_tpu/kernels/colormap.py: no TPU kernel is replaced)
    "colormap": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/colormap.cu",
        replaces=None,
    ),
    # the PHASE values: each pixel's mid and cancellation from kernel A's
    # complex half spectra (the JAX package runs spectrum_values' PHASE
    # branch as XLA operations: no TPU kernel is replaced)
    "phase_values": dict(
        route="cuda",
        source="signalizer_tpu_torch/csrc/phase_values.cu",
        replaces=None,
    ),
}
# each kernel's device functions, as the profiler names them
DEVICE_FUNCTIONS = {
    "window_fft_mag": ("window_fft_mag_kernel",),
    "display_map": ("display_map_kernel",),
    "display_remap": ("display_remap_kernel",),
    "display_decay_db": ("display_decay_db_fold_kernel", "display_decay_db_kernel"),
    "banded_resample": ("banded_resample_kernel",),
    "window_fft_mag_long": ("long_columns_kernel", "long_rows_kernel"),
    "window_fft_mag_cluster": ("window_fft_mag_cluster_kernel",),
    "peak_hold": ("peak_hold_kernel",),
    "colour_track": ("colour_track_kernel",),
    "spectral_walk": ("spectral_walk_kernel",),
    "phase_decay_db": ("phase_decay_db_kernel", "phase_walk_kernel", "phase_tick_kernel"),
    "resonator_scan": ("resonator_scan_kernel",),
    "colormap": ("colormap_kernel",),
    "phase_values": ("phase_values_kernel",),
}
OWN_DEVICE_FUNCTIONS = sorted({fn for fns in DEVICE_FUNCTIONS.values() for fn in fns})
# the oscilloscope's cfg3 (bench.py:769-822)
OSC_FS = 96_000.0
OSC_HISTORY = 16384
OSC_PIXELS = 8192
OSC_WINDOW = 1024.0
OSC_HOP = 1600  # 96 kHz / 60 fps
OSC_CALLS = 3


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def headline(**overrides) -> dict:
    """The headline constant's keywords (bench.py:240-266)."""
    from signalizer_tpu_torch import BinInterpolation, SpectrumChannels, ViewScaling

    kw = dict(
        axis_points=AXIS_POINTS,
        window_size=WINDOW,
        sample_rate=FS,
        configuration=SpectrumChannels.SEPARATE,
        bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LOGARITHMIC,
    )
    kw.update(overrides)
    return kw


def info(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def median_ms(torch, fn, reps: int = REPS, inner: int = 4) -> float:
    """Median over ``reps`` CUDA-event timings of ``fn`` after a warm-up,
    each over ``inner`` calls queued back to back (so that a kernel longer
    than its wrapper's host time is timed without the gap before it),
    divided by ``inner``."""
    return statistics.median(event_ms(torch, fn, reps, inner))


def event_ms(torch, fn, reps: int = REPS, inner: int = 4) -> list:
    """The ``reps`` timings that :func:`median_ms` takes the median of."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return times


def roofline(bytes_moved: float, flops: float) -> dict:
    """``bound_ms`` and ``bound_by`` of a call that must move
    ``bytes_moved`` bytes and do ``flops`` float32 operations."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_flops = flops / F32_FLOPS_PER_S * 1e3
    return dict(
        bound_ms=max(by_bytes, by_flops),
        bound_by="bytes" if by_bytes >= by_flops else "operations",
        bound_bytes=bytes_moved,
        bound_flops=flops,
    )


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def row_rel_err(got, want) -> float:
    err = (got - want).abs().amax(-1)
    return float((err / want.abs().amax(-1).clamp(min=1e-30)).max())


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    info({
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvidia_smi": smi,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    })
    return smi


def phase_build():
    from signalizer_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    # per kernel (and template instantiation): registers, spills, shared memory
    ptxas = []
    for ln in _build.build_info["log"].splitlines():
        entry = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)(I\w+?E)?E", ln)
        if entry:
            ptxas.append(entry.group(1) + (" " + entry.group(2) if entry.group(2) else ""))
        elif "Used" in ln or "spill" in ln:
            ptxas.append(ln.strip().removeprefix("ptxas info    : "))
    info({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "nvcc_seconds": _build.build_info["seconds"],
        "library": _build.build_info["path"],
        "ptxas": ptxas,
    })


def _frames(torch, shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32)).to(dev)


def fft_bound(c, frames, out) -> dict:
    """Kernel A's least time for this call: it reads the frames, the window
    and the twiddle table once and writes its rows once; a packed real row
    is an N/2-point complex transform (5 L log2 L flops) and a split of ten
    flops a bin, a COMPLEX row an N-point transform."""
    from signalizer_tpu_torch import SpectrumChannels as SC

    n = c.transform_size
    length = n if c.configuration == SC.COMPLEX else n // 2
    n_rows = out.numel() // out.shape[-1]
    flops = n_rows * (5.0 * length * np.log2(length) + 10.0 * out.shape[-1] + 2.0 * c.window_size)
    return roofline(nbytes(frames, c.window_kernel, c.fft_twiddles, out), flops)


def phase_kernel_a(torch, dev, results):
    from signalizer_tpu_torch import SpectrumChannels as SC
    from signalizer_tpu_torch.core.constant import make_spectrum_constant
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm

    report = {"phase": "kernel_a", "bound": "row-relative error <= 5e-6; a silent row exactly 0", "cases": {}}
    real_modes = [SC.LEFT, SC.RIGHT, SC.MERGE, SC.SIDE, SC.PHASE, SC.SEPARATE, SC.MIDSIDE]
    cases = [  # name, constant keywords, frames shape, timed
        ("headline", headline(), (PAIRS, T, 2, WINDOW), True),
        ("complex", headline(window_size=1024, configuration=SC.COMPLEX), (4, 8, 2, 1024), True),
        ("phase", headline(window_size=1024, configuration=SC.PHASE), (4, 8, 2, 1024), True),
        ("zero_pad", headline(window_size=3000), (4, 8, 2, 3000), True),
        ("n32", headline(window_size=24), (4, 8, 2, 24), False),
        ("odd_w701", headline(window_size=701), (4, 8, 2, 701), False),
        ("n16384", headline(window_size=16384), (2, 4, 2, 16384), True),
        ("n32768", headline(window_size=32768), (2, 4, 2, 32768), True),
        ("complex_n16384", headline(window_size=16384, configuration=SC.COMPLEX), (2, 4, 2, 16384), False),
    ]
    cases += [
        (f"mode_{m.name.lower()}_n256", headline(window_size=256, configuration=m), (4, 8, 2, 256), False)
        for m in real_modes
    ]
    for i, (name, kw, shape, timed) in enumerate(cases):
        c = make_spectrum_constant(device=dev, **kw)
        frames = _frames(torch, shape, seed=10 + i, dev=dev)
        got = wfm.window_fft_mag(c, frames)
        want = wfm.window_fft_mag_plain(c, frames)
        torch.cuda.synchronize()
        rel = row_rel_err(got, want)
        require(got.shape == want.shape and got.dtype == want.dtype, f"kernel A {name} shape")
        require(rel <= 5e-6, f"kernel A {name}: row-relative error {rel} > 5e-6")
        report["cases"][name] = {"shape": list(shape), "row_rel_err": rel}
        if timed:
            ms = median_ms(torch, lambda: wfm.window_fft_mag(c, frames))
            plain_ms = median_ms(torch, lambda: wfm.window_fft_mag_plain(c, frames))
            report["cases"][name].update(ms=ms, plain_ms=plain_ms)
        if name == "headline":
            # the one library call that does part of the kernel's work: the
            # transform alone, of rows that are already packed and windowed
            # (no packing, window, DC/Nyquist halving or magnitude)
            rows = frames * c.window_kernel
            library_ms = median_ms(torch, lambda: torch.fft.rfft(rows, n=c.transform_size, dim=-1))
            del rows
            results["window_fft_mag"] = dict(
                max_abs_err=float((got - want).abs().max()), ms=ms, plain_ms=plain_ms,
                **fft_bound(c, frames, got), library_ms=library_ms,
                library="torch.fft.rfft of already windowed rows: less than the kernel does",
            )
            headline_mags = got
            headline_constant = c
    # an all-zero channel beside a loud one comes out exactly zero
    for name, kw, shape in (
        ("silent_separate", headline(), (4, 2, WINDOW)),
        ("silent_phase_n32", headline(window_size=32, configuration=SC.PHASE), (4, 2, 32)),
        ("silent_separate_n32768", headline(window_size=32768), (2, 2, 32768)),
    ):
        c = make_spectrum_constant(device=dev, **kw)
        frames = _frames(torch, shape, seed=90, dev=dev) * 3.0
        frames[:, 1] = 0.0
        got = wfm.window_fft_mag(c, frames)
        want = wfm.window_fft_mag_plain(c, frames)
        torch.cuda.synchronize()
        require(bool((got[:, 1] == 0).all()), f"kernel A {name}: the silent channel is not exactly zero")
        rel = row_rel_err(got[:, 0], want[:, 0])
        require(rel <= 5e-6, f"kernel A {name}: loud row error {rel} > 5e-6")
        report["cases"][name] = {"shape": list(shape), "row_rel_err": rel, "silent_row_max": 0.0}
    info(report)
    return headline_constant, headline_mags


def phase_kernel_b(torch, dev, c, mags, results):
    from signalizer_tpu_torch.core.constant import make_spectrum_constant
    from signalizer_tpu_torch.kernels import display_map as dm

    report = {
        "phase": "kernel_b",
        "bound": "display <= 1e-5; state rel <= 1e-6, and bit-equal on chunk-max and single-bin pixels",
        "cases": {},
    }
    rng = np.random.default_rng(20)

    def state_for(constant, pairs):
        shape = (pairs, constant.num_line_graphs, constant.state_channels, constant.axis_points)
        return torch.from_numpy((rng.random(shape) * 0.5).astype(np.float32)).to(dev)

    valid = rng.random(T) > 0.25
    valid[0] = False
    small = {
        k: make_spectrum_constant(device=dev, **headline(axis_points=200, window_size=1024, num_line_graphs=k))
        for k in (1, 8, 11)
    }
    small_mags = {
        k: torch.from_numpy(
            (np.abs(rng.standard_normal((3, 40, 2, sc.n_spectrum_values))) * 40.0).astype(np.float32)
        ).to(dev)
        for k, sc in small.items()
    }
    cases = [  # name, constant, mags, valid, timed
        ("headline", c, mags, None, True),
        ("t1", c, mags[:, :1].contiguous(), None, True),
        ("valid_mask", c, mags, torch.from_numpy(valid).to(dev), True),
        ("t127_ragged", c, mags[:, :127].contiguous(), torch.from_numpy(valid[:127]).to(dev), False),
        ("none_valid", c, mags, torch.zeros(T, dtype=torch.bool, device=dev), False),
        ("k1_small", small[1], small_mags[1], None, False),
        ("k8_small", small[8], small_mags[8], torch.from_numpy(valid[:40]).to(dev), False),
        ("k11_small", small[11], small_mags[11], torch.from_numpy(valid[:40]).to(dev), False),  # two launches
    ]
    for name, cc, m, v, timed in cases:
        state0 = state_for(cc, m.shape[0])
        s_kernel, s_plain = state0.clone(), state0.clone()
        got = dm.display_map(cc, m, s_kernel, v)
        want = dm.display_map_plain(cc, m, s_plain, v)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        state_rel = float(((s_kernel - s_plain).abs() / s_plain.abs().clamp(min=1e-30)).max())
        require(got.shape == want.shape, f"kernel B {name} shape")
        require(err <= 1e-5, f"kernel B {name}: display error {err} > 1e-5")
        require(state_rel <= 1e-6, f"kernel B {name}: state relative error {state_rel} > 1e-6")
        # no tap sum on these pixels, and the split of the decay over groups
        # of frames is exact: the state is the plain loop's bit for bit
        exact = ~cc.interp_mask
        require(bool(exact.any()), f"kernel B {name}: no chunk-max or single-bin pixel")
        require(torch.equal(s_kernel[..., exact], s_plain[..., exact]),
                f"kernel B {name}: state differs from the plain loop on a pixel without a tap sum")
        if name == "none_valid":
            require(torch.equal(s_kernel, state0), "kernel B none_valid: the state moved")
        report["cases"][name] = {
            "shape": list(m.shape), "line_graphs": cc.num_line_graphs, "max_abs_err": err,
            "state_rel_err": state_rel, "state_bit_equal_pixels": int(exact.sum()),
        }
        if timed:
            scratch = state0.clone()
            ms = median_ms(torch, lambda: dm.display_map(cc, m, scratch, v))
            plain_ms = median_ms(torch, lambda: dm.display_map_plain(cc, m, scratch, v))
            report["cases"][name].update(ms=ms, plain_ms=plain_ms)
        if name == "headline":
            # reads the magnitudes, the state and the plan once, writes the
            # display values and the state once; per output a multiply and
            # max, the dB map's multiply, divide, log and scale (~30 flops
            # with the log's polynomial), per pixel and frame its taps
            tables = (cc.interp_indices, cc.interp_weights, cc.interp_mask, cc.single_mask,
                      cc.single_bin, cc.chunk_lo, cc.chunk_len, cc.slope_map)
            moved = nbytes(m, got, *tables) + 2 * nbytes(state0)
            flops = 30.0 * got.numel() + 2.0 * m.numel()
            results["display_map"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, **roofline(moved, flops), library_ms=None
            )
    info(report)


def display_tables(c):
    """The plan tables kernel B's remap reads."""
    return (c.interp_indices, c.interp_weights, c.interp_mask, c.single_mask,
            c.single_bin, c.chunk_lo, c.chunk_len)


def phase_kernel_b_entries(torch, dev, c, mags, results):
    """Kernel B's remap-only and decay-and-dB entries against their plain
    versions, and the two in turn against the fused entry. Returns the
    decay-and-dB calls the profile phase times."""
    from signalizer_tpu_torch import SpectrumChannels as SC
    from signalizer_tpu_torch.core.constant import make_spectrum_constant
    from signalizer_tpu_torch.kernels import display_map as dm

    report = {
        "phase": "kernel_b_entries",
        "bound": "remap: rel <= 1e-6 of the largest value, bit-equal on chunk-max and single-bin pixels; "
                 "decay_db: display <= 1e-5, state bit-equal everywhere; remap then decay_db: bit-equal to the fused entry",
        "cases": {},
    }
    rng = np.random.default_rng(21)

    # the remap alone, at the headline shape and at T = 1
    exact = ~c.interp_mask
    for name, m in (("remap_headline", mags), ("remap_t1", mags[:, :1].contiguous())):
        got = dm.display_remap(c, m)
        want = dm.display_remap_plain(c, m)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        require(got.shape == want.shape, f"{name} shape")
        require(rel <= 1e-6, f"{name}: error {rel} of the largest value > 1e-6")
        require(torch.equal(got[..., exact], want[..., exact]), f"{name}: differs on a pixel without a tap sum")
        ms = median_ms(torch, lambda: dm.display_remap(c, m))
        plain_ms = median_ms(torch, lambda: dm.display_remap_plain(c, m))
        report["cases"][name] = {"shape": list(m.shape), "max_abs_err": err, "err_of_max": rel, "ms": ms, "plain_ms": plain_ms}
        if name == "remap_headline":
            # reads the magnitudes and the plan once, writes the values once;
            # two multiply-adds a tap, an abs and a scale
            results["display_remap"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **roofline(nbytes(m, got, *display_tables(c)), 6.0 * got.numel()), library_ms=None,
            )
            vals = got

    # decay and dB alone, on the headline's remapped values
    def state_for(constant, pairs):
        shape = (pairs, constant.num_line_graphs, constant.state_channels, constant.axis_points)
        return torch.from_numpy((rng.random(shape) * 0.5).astype(np.float32)).to(dev)

    valid = rng.random(T) > 0.25
    valid[0] = False
    one_invalid = np.ones(T, bool)
    one_invalid[57] = False
    small = {
        k: make_spectrum_constant(device=dev, **headline(axis_points=200, window_size=1024, num_line_graphs=k))
        for k in (1, 8, 11)
    }
    small_vals = torch.from_numpy((np.abs(rng.standard_normal((3, 40, 2, 200))) * 0.3).astype(np.float32)).to(dev)
    # the spectrogram's cfg4 shape: 1 pair x 512 frames x 1 row, the last 3
    # invalid (a split T shows here)
    c4 = make_spectrum_constant(device=dev, **headline(configuration=SC.LEFT))
    cfg4_vals = torch.from_numpy((np.abs(rng.standard_normal((1, 512, 1, AXIS_POINTS))) * 0.3).astype(np.float32)).to(dev)
    cfg4_valid = np.ones(512, bool)
    cfg4_valid[-3:] = False
    cases = [  # name, constant, vals, valid, timed
        ("decay_db_headline", c, vals, None, True),
        ("decay_db_t1", c, vals[:, :1].contiguous(), None, True),
        ("decay_db_127_of_128_valid", c, vals, torch.from_numpy(one_invalid).to(dev), False),
        ("decay_db_t127_ragged", c, vals[:, :127].contiguous(), torch.from_numpy(valid[:127]).to(dev), False),
        ("decay_db_none_valid", c, vals, torch.zeros(T, dtype=torch.bool, device=dev), False),
        ("decay_db_k1_small", small[1], small_vals, None, False),
        ("decay_db_k8_small", small[8], small_vals, torch.from_numpy(valid[:40]).to(dev), False),
        ("decay_db_k11_small", small[11], small_vals, torch.from_numpy(valid[:40]).to(dev), False),
        ("decay_db_cfg4", c4, cfg4_vals, torch.from_numpy(cfg4_valid).to(dev), True),
    ]
    profiled = {}
    for name, cc, v, mask, timed in cases:
        state0 = state_for(cc, v.shape[0])
        s_kernel, s_plain = state0.clone(), state0.clone()
        got = dm.display_decay_db(cc, s_kernel, v, mask)
        want = dm.decay_db(cc, s_plain, v, mask)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(got.shape == want.shape, f"{name} shape")
        require(err <= 1e-5, f"{name}: display error {err} > 1e-5")
        require(torch.equal(s_kernel, s_plain), f"{name}: state differs from the plain loop")
        if name == "decay_db_none_valid":
            require(torch.equal(s_kernel, state0), f"{name}: the state moved")
        report["cases"][name] = {"shape": list(v.shape), "line_graphs": cc.num_line_graphs, "max_abs_err": err,
                                 "state_bit_equal": True}
        if timed:
            scratch = state0.clone()
            ms = median_ms(torch, lambda: dm.display_decay_db(cc, scratch, v, mask))
            plain_ms = median_ms(torch, lambda: dm.decay_db(cc, scratch, v, mask))
            # the kernel's layout: frames a group, groups a block, chunks
            plan = dm.decay_db_plan(v.shape[0], v.shape[1], cc.num_line_graphs, v.shape[2], cc.axis_points,
                                    torch.cuda.get_device_properties(dev).multi_processor_count)
            report["cases"][name].update(
                ms=ms, plain_ms=plain_ms, plan=list(plan),
                **roofline(nbytes(v, got, cc.slope_map) + 2 * nbytes(state0), 30.0 * got.numel()))
            profiled[name] = lambda cc=cc, scratch=scratch, v=v, mask=mask: dm.display_decay_db(cc, scratch, v, mask)
        if name == "decay_db_headline":
            # reads the values, the state and the slope once, writes the
            # display values and the state once; ~30 flops an output (the dB
            # map's multiply, divide, log and scale, the decay's multiply and max)
            moved = nbytes(v, got, cc.slope_map) + 2 * nbytes(state0)
            results["display_decay_db"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, **roofline(moved, 30.0 * got.numel()), library_ms=None,
            )

    # the two halves in turn are the fused entry, bit for bit
    for name, m, mask in (("halves_headline", mags, torch.from_numpy(valid).to(dev)),
                          ("halves_t1", mags[:, :1].contiguous(), None)):
        state0 = state_for(c, m.shape[0])
        s_fused, s_halves = state0.clone(), state0.clone()
        fused = dm.display_map(c, m, s_fused, mask)
        halves = dm.display_decay_db(c, s_halves, dm.display_remap(c, m), mask)
        torch.cuda.synchronize()
        require(torch.equal(fused, halves), f"{name}: display differs from the fused entry")
        require(torch.equal(s_fused, s_halves), f"{name}: state differs from the fused entry")
        report["cases"][name] = {"shape": list(m.shape), "equal_to_fused": True}
    info(report)
    # decay-and-dB alone at T = 1 and at cfg4, for the profile (the headline
    # is the halves' call)
    return [("decay_db_t1", profiled["decay_db_t1"]), ("decay_db_cfg4", profiled["decay_db_cfg4"])]


def phase_halves_slice(torch, dev, proc, x, tick, launches_out, calls_out):
    """``spectrum_values`` then ``post_process`` (the Spectrum step as two
    public calls) on the slice's device-resident frames: kernel A, kernel
    B's remap entry and its decay-and-dB entry, held against
    ``analyze_frames`` from the same state."""
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import spectrum as ts
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm

    c = proc.constant
    frames = [x, x.flip(1), tick[:, None]]
    state = ts.init_line_graph_state(c, (PAIRS,))
    fused_state = ts.init_line_graph_state(c, (PAIRS,))
    reset_counters("window_fft_mag.launches", "display_map.launches", "display_map.remap_launches",
                   "display_map.decay_db_launches")
    outs = [ts.post_process(c, state, ts.spectrum_values(c, f)).results for f in frames]
    torch.cuda.synchronize()
    launches = {"window_fft_mag": counter("window_fft_mag.launches"), "display_map": counter("display_map.launches"),
                "display_remap": counter("display_map.remap_launches"),
                "display_decay_db": counter("display_map.decay_db_launches")}
    require(launches == {"window_fft_mag": 3, "display_map": 0, "display_remap": 3, "display_decay_db": 3},
            f"halves launch counts {launches}")
    for f, out in zip(frames, outs):
        want = ts.analyze_frames(c, fused_state, f).results
        torch.cuda.synchronize()
        require(torch.equal(out, want), "spectrum_values + post_process differ from analyze_frames")
        require(bool(torch.isfinite(out).all()), "halves output finite")
    require(torch.equal(state.magnitude, fused_state.magnitude), "halves state differs from analyze_frames'")
    launches_out["display_remap"] = launches["display_remap"]
    calls_out["display_remap"] = 3
    scratch = ts.init_line_graph_state(c, (PAIRS,))
    info({
        "phase": "halves_slice", "calls": [list(f.shape) for f in frames], "launches": launches,
        "equal_to_analyze_frames": True,
        "t128_call_ms": median_ms(torch, lambda: ts.post_process(c, scratch, ts.spectrum_values(c, x)), reps=10),
        "t1_call_ms": median_ms(torch, lambda: ts.post_process(c, scratch, ts.spectrum_values(c, tick[:, None]))),
    })
    return lambda: ts.post_process(c, scratch, ts.spectrum_values(c, x))


# kernel G's cases against its plain version: name -> (pairs, T, K, P, mask)
PHASE_CASES = {
    "headline_t128": (PAIRS, T, 2, AXIS_POINTS, None),
    "headline_t1": (PAIRS, 1, 2, AXIS_POINTS, None),
    "headline_last_frames_invalid": (PAIRS, T, 2, AXIS_POINTS, "last"),
    "cfg4_1x512": (1, 512, 2, AXIS_POINTS, "last"),
    "ragged_p1001": (3, 9, 2, 1001, "some"),
    "k1": (2, 7, 1, 256, None),
    "k2": (2, 7, 2, 256, "some"),
    "k11": (2, 33, 11, 200, "some"),
}


# the PHASE values' cases beside the headline's: (window, pairs, T), at the
# sizes of kernel A's cluster and two-pass forms
PHASE_VALUE_CASES = ((WINDOW, PAIRS, 1), (65536, PAIRS, T), (65536, PAIRS, 1), (65536, 1, 1),
                     (1 << 21, 1, T), (1 << 21, PAIRS, 1), (1 << 21, 1, 1))


def phase_kernel_values(torch, dev, results):
    """The PHASE values kernel against ``phase_values_plain`` on the same
    CUDA spectra, bit for bit: at the headline, kernel A's PHASE output of
    16 pairs x 128 frames ([16, 128, 2, 2049] complex64); then seeded
    spectra at each case of ``PHASE_VALUE_CASES``. Each timed by CUDA events
    beside the plain path, with the bound: the spectra read once and the
    values written once (the plan's tables besides), about eleven flops a
    complex value (a hypotf and a compare a bin and channel)."""
    from signalizer_tpu_torch import SpectrumChannels
    from signalizer_tpu_torch.core.constant import make_spectrum_constant
    from signalizer_tpu_torch.kernels import phase_values as pv
    from signalizer_tpu_torch.kernels import spectrum as ts
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm

    report = {"phase": "phase_values", "bound": "bit-equal to phase_values_plain", "cases": {}}
    gen = torch.Generator(device=dev)

    def case(name, c, spec):
        got = pv.phase_values(c, spec)
        want = ts.phase_values_plain(c, spec)
        torch.cuda.synchronize()
        require(got.shape == want.shape and torch.equal(got, want),
                f"PHASE values {name}: differ from the plain path by {float((got - want).abs().max())}")
        long_case = c.window_size > WINDOW
        ms = median_ms(torch, lambda: pv.phase_values(c, spec), reps=10 if long_case else REPS)
        plain_ms = median_ms(torch, lambda: ts.phase_values_plain(c, spec), reps=5 if long_case else REPS,
                             inner=1 if long_case else 4)
        tables = nbytes(c.interp_indices, c.interp_weights, c.interp_mask, c.single_mask, c.single_bin,
                        c.chunk_lo, c.chunk_len)
        bound = roofline(nbytes(spec, got) + tables, 11.0 * spec.numel())
        row = {"shape": list(spec.shape), "longest_chunk": int(c.band_idx.shape[-1]), "bit_equal": True,
               "ms": ms, "plain_ms": plain_ms, **bound}
        report["cases"][name] = row
        return row

    c = make_spectrum_constant(device=dev, **headline(configuration=SpectrumChannels.PHASE))
    spec = wfm.window_fft_mag(c, _frames(torch, (PAIRS, T, 2, WINDOW), seed=47, dev=dev))
    require(spec.dtype == torch.complex64 and tuple(spec.shape) == (PAIRS, T, 2, c.n_spectrum_values),
            f"kernel A's PHASE output: {spec.dtype} {tuple(spec.shape)}")
    row = case("headline_t128", c, spec)
    results["phase_values"] = dict(max_abs_err=0.0, ms=row["ms"], plain_ms=row["plain_ms"],
                                   bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None)
    del spec
    for window, pairs, t in PHASE_VALUE_CASES:
        cw = c if window == WINDOW else make_spectrum_constant(
            device=dev, **headline(window_size=window, configuration=SpectrumChannels.PHASE))
        gen.manual_seed(window + 7 * pairs + t)
        shape = (pairs, t, 2, cw.n_spectrum_values)
        spec = torch.complex(torch.randn(shape, generator=gen, device=dev),
                             torch.randn(shape, generator=gen, device=dev))
        name = f"n{window}_{pairs}x{t}"
        row = case(name, cw, spec)
        for key in ("ms", "plain_ms", "bound_ms"):
            results["phase_values"][f"{name}_{key}"] = row[key]
        del spec
    torch.cuda.empty_cache()
    info(report)


def phase_kernel_g(torch, dev, results, launches_out, calls_out):
    """Kernel G (the PHASE display tail) against its plain version on the
    same CUDA tensors in every case of ``PHASE_CASES`` (states bit-equal,
    display within 1e-5); then the PHASE Spectrum at the headline geometry
    through ``SpectrumProcessor`` (three T = 128 and three T = 1 calls,
    kernel A and kernel G once a call, against stage 1 and the plain tail
    from the same state) and the spectrogram's cfg4 step in PHASE (1 pair x
    T = 512, a host mask), each with its synchronizing calls counted and
    timed, and the PHASE values kernel launched once a call on both; the
    yardstick takes kernel A's output through the plain values and the
    plain tail. Returns the calls the profile phase profiles."""
    from signalizer_tpu_torch import DisplayMode, SpectrumChannels, SpectrumProcessor
    from signalizer_tpu_torch.core.constant import make_spectrum_constant
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import phase_decay_db as pd
    from signalizer_tpu_torch.kernels import spectrum as ts
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm
    from signalizer_tpu_torch.kernels.colormap import gradient_bounds, normalize_ratios, spectrogram_columns_plain
    from signalizer_tpu_torch.views import spectrogram as tv

    report = {"phase": "kernel_g", "bound": "states bit-equal to the plain loop, display <= 1e-5", "cases": {}}
    rng = np.random.default_rng(2032)

    def inputs(pairs, t, k, p, mask):
        c = make_spectrum_constant(device=dev, **headline(axis_points=p, configuration=SpectrumChannels.PHASE,
                                                          num_line_graphs=k))
        mid = np.abs(rng.standard_normal((pairs, t, p))) * 0.3
        vals = np.stack([mid, rng.random((pairs, t, p))], axis=-2).astype(np.float32)
        mag = (rng.random((pairs, k, 2, p)) * 0.05).astype(np.float32)
        phase = (rng.random((pairs, k, p)) * 0.05).astype(np.float32)
        valid = None
        if mask == "last":
            valid = np.ones(t, bool)
            valid[-3:] = False
        elif mask == "some":
            valid = rng.random(t) > 0.3
        return c, *(torch.from_numpy(a).to(dev) for a in (vals, mag, phase)), valid

    def state_of(mag, phase):
        return ts.LineGraphState(mag.clone(), phase.clone())

    for name, case in PHASE_CASES.items():
        c, vals, mag, phase, valid = inputs(*case)
        s_kernel, s_plain = state_of(mag, phase), state_of(mag, phase)
        got = pd.phase_decay_db(c, s_kernel, vals, valid)
        want = pd.phase_decay_db_plain(c, s_plain, vals, valid)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(got.shape == want.shape, f"kernel G {name}: shape {tuple(got.shape)}")
        require(err <= 1e-5, f"kernel G {name}: display error {err} > 1e-5")
        require(torch.equal(s_kernel.magnitude, s_plain.magnitude) and torch.equal(s_kernel.phase, s_plain.phase),
                f"kernel G {name}: states differ from the plain loop")
        require(torch.equal(s_kernel.magnitude[:, :, 1], mag[:, :, 1]), f"kernel G {name}: row 1 moved")
        report["cases"][name] = {"shape": list(vals.shape), "line_graphs": c.num_line_graphs,
                                 "valid_frames": None if valid is None else int(valid.sum()),
                                 "max_abs_err": err, "states_bit_equal": True,
                                 "plan": pd.phase_plan(vals.shape[0], vals.shape[1], c.num_line_graphs,
                                                       c.axis_points, torch.cuda.get_device_properties(dev)
                                                       .multi_processor_count)}
        if name in ("headline_t128", "headline_t1", "cfg4_1x512"):
            scratch = state_of(mag, phase)
            ms = median_ms(torch, lambda: pd.phase_decay_db(c, scratch, vals, valid))
            plain_ms = median_ms(torch, lambda: pd.phase_decay_db_plain(c, scratch, vals, valid), reps=5, inner=1)
            # each value read once, each output written once, the states
            # read and written once; ~30 flops an output, as kernel B's
            # decay-and-dB (the decay, the smoothing, a divide, a log, a scale)
            bound = roofline(nbytes(vals, got, c.slope_map) + 2 * nbytes(mag[:, :, 0], phase), 30.0 * got.numel())
            report["cases"][name].update(ms=ms, plain_ms=plain_ms, **bound)
            if name == "headline_t128":
                results["phase_decay_db"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound, library_ms=None)
                alone = (lambda c=c, scratch=scratch, vals=vals, valid=valid:
                         pd.phase_decay_db(c, scratch, vals, valid))
            else:
                results.setdefault("phase_decay_db", {})
                results["phase_decay_db"][f"{name}_ms"] = ms
                results["phase_decay_db"][f"{name}_plain_ms"] = plain_ms
                results["phase_decay_db"][f"{name}_bound_ms"] = bound["bound_ms"]
    info(report)

    # the main path: the PHASE Spectrum at the headline geometry, as a user
    # calls it; counts set to 0 just before, read just after
    proc = SpectrumProcessor.create(pairs=PAIRS, device=dev, **headline(configuration=SpectrumChannels.PHASE))
    c = proc.constant
    x = _frames(torch, (PAIRS, 4 * T, 2, WINDOW), seed=45, dev=dev)
    calls = [x[:, i * T : (i + 1) * T].contiguous() for i in range(3)]
    calls += [x[:, 3 * T + i : 3 * T + i + 1].contiguous() for i in range(3)]
    plain = ts.init_line_graph_state(c, (PAIRS,))
    worst, outs = 0.0, []
    reset_counters("window_fft_mag.launches", "display_map.launches", "display_map.decay_db_launches",
                   "phase_decay_db.launches", "phase_values.launches")
    for frames in calls:
        outs.append(proc.process(frames))
    counted = {"window_fft_mag": counter("window_fft_mag.launches"), "display_map": counter("display_map.launches"),
               "display_decay_db": counter("display_map.decay_db_launches"),
               "phase_decay_db": counter("phase_decay_db.launches"), "phase_values": counter("phase_values.launches")}
    require(counted == {"window_fft_mag": 6, "display_map": 0, "display_decay_db": 0, "phase_decay_db": 6,
                        "phase_values": 6}, f"PHASE headline calls launched {counted}")
    for frames, out in zip(calls, outs):
        # the yardstick: kernel A's output through the plain values and the
        # plain tail (no PHASE values kernel in it)
        want = pd.phase_decay_db_plain(c, plain, ts.phase_values_plain(c, wfm.window_fft_mag(c, frames)))
        torch.cuda.synchronize()
        require(out.shape == (PAIRS, frames.shape[1], 2, 2, AXIS_POINTS) and bool(torch.isfinite(out).all()),
                "PHASE headline output")
        worst = max(worst, float((out - want).abs().max()))
    require(worst <= 1e-5, f"PHASE headline calls vs the plain tail: {worst} > 1e-5")
    require(torch.equal(proc.state.magnitude, plain.magnitude) and torch.equal(proc.state.phase, plain.phase),
            "PHASE headline states differ from the plain tail's")
    launches_out["phase_decay_db"] = counted["phase_decay_db"]
    calls_out["phase_decay_db"] = len(calls)
    launches_out["phase_values"] = counted["phase_values"]
    calls_out["phase_values"] = len(calls)
    x128, x1 = calls[0], calls[3]
    syncs = {}
    for name, frames in (("t128", x128), ("t1", x1)):
        with SyncCounter(torch) as sc:
            proc.process(frames)
        torch.cuda.synchronize()
        syncs[name] = sc.count
        require(sc.count == 0, f"PHASE headline {name} call: {sc.count} syncs at {dict(sc.sites)}")

    # the spectrogram's cfg4 step in PHASE, with the host mask of the bench
    c4 = make_spectrum_constant(device=dev, **headline(
        window_size=16384, configuration=SpectrumChannels.PHASE, display_mode=DisplayMode.COLOUR_SPECTRUM))
    frames4 = _frames(torch, (1, 512, 2, 16384), seed=46, dev=dev)
    valid4 = np.ones(512, bool)
    valid4[-3:] = False
    colours = torch.from_numpy(tv.DEFAULT_GRADIENT[None]).to(dev)
    ratios = torch.from_numpy(normalize_ratios(tv.DEFAULT_RATIOS).astype(np.float32)).to(dev)
    bounds = gradient_bounds(ratios)
    s4, p4 = ts.init_line_graph_state(c4, (1,)), ts.init_line_graph_state(c4, (1,))
    reset_counters("phase_decay_db.launches", "phase_values.launches")
    cols, _ = tv.spectrogram_step(c4, s4, frames4, colours, ratios, valid4, bounds)
    g4, v4 = counter("phase_decay_db.launches"), counter("phase_values.launches")
    want4 = pd.phase_decay_db_plain(c4, p4, ts.phase_values_plain(c4, wfm.window_fft_mag(c4, frames4)), valid4)
    want_cols = spectrogram_columns_plain(want4[:, :, 0, 0, :], colours, ratios)
    torch.cuda.synchronize()
    require((g4, v4) == (1, 1), f"cfg4 PHASE step: kernel G launched {g4} times, the PHASE values {v4}")
    diff = (cols.to(torch.int16) - want_cols.to(torch.int16)).abs()
    require(int(diff.max()) <= 1 and float((diff != 0).float().mean()) <= 1e-3,
            f"cfg4 PHASE columns vs the plain tail: max byte difference {int(diff.max())}")
    require(torch.equal(s4.magnitude, p4.magnitude) and torch.equal(s4.phase, p4.phase),
            "cfg4 PHASE states differ from the plain tail's")
    with SyncCounter(torch) as sc:
        tv.spectrogram_step(c4, s4, frames4, colours, ratios, valid4, bounds)
    torch.cuda.synchronize()
    syncs["cfg4"] = sc.count
    require(sc.count == 0, f"cfg4 PHASE step: {sc.count} syncs at {dict(sc.sites)}")

    def cfg4():
        return tv.spectrogram_step(c4, s4, frames4, colours, ratios, valid4, bounds)

    info({
        "phase": "phase_slice", "launches": counted, "max_abs_err_vs_plain_tail": worst, "syncs": syncs,
        "t128_call_ms": call_ms(torch, lambda: proc.process(x128)), "t1_call_ms": call_ms(torch, lambda: proc.process(x1)),
        "cfg4_step_ms": call_ms(torch, cfg4), "cfg4_byte_differences": float((diff != 0).float().mean()),
    })
    return [("phase_t128", lambda: proc.process(x128)), ("phase_t1", lambda: proc.process(x1)),
            ("phase_cfg4", cfg4), ("phase_decay_db_t128", alone)]


def phase_vectorscope(torch, dev):
    """VectorscopeProcessor at the vectorscope bench geometry
    (bench.py:743-767, cfg2): 256 stereo streams x 4096 samples, envelope
    pole 0.999, stereo pole 0.99; every mode and autogain, three calls each
    on a seeded stream (the third with new_samples and a meter slice), held
    against the same processor on the CPU; then the physical checks."""
    from signalizer_tpu_torch import OperationalMode, VectorscopeAutoGain, VectorscopeProcessor

    streams, w, hop = 256, 4096, 800
    rng = np.random.default_rng(2028)
    n = np.arange(w + 2 * hop)
    stream = (rng.standard_normal((streams, 2, w + 2 * hop)) * 0.25).astype(np.float32)
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * n / FS)).astype(np.float32)
    stream[0] = [tone, 1e-4 * tone]  # hard left, right merely tiny
    stream[1] = [tone, tone]  # centre / mono
    stream[2] = [1e-4 * tone, tone]  # hard right
    stream[3] = [tone, 0 * tone]  # right exactly silent
    stream[4] = [tone, -tone]  # inverted
    stream[5] = 0.0  # silence
    on_card = torch.from_numpy(stream).to(dev)
    report = {"phase": "vectorscope", "streams": streams, "samples": w, "configs": {}}
    keep = None
    for mode in OperationalMode:
        for gain in VectorscopeAutoGain:
            procs = []
            for device in (dev, "cpu"):
                proc = VectorscopeProcessor(pairs=streams, device=device, sample_rate=FS, mode=mode, autogain=gain)
                proc.envelope_pole, proc.stereo_pole = 0.999, 0.99
                procs.append(proc)
            proc, ref = procs
            worst = 0.0
            for i in range(3):
                lo = i * hop
                kw = dict(new_samples=hop, meter_frames=on_card[..., lo + w - 1024 : lo + w]) if i == 2 else {}
                frame = proc.process(on_card[..., lo : lo + w], **kw)
                if "meter_frames" in kw:
                    kw["meter_frames"] = stream[..., lo + w - 1024 : lo + w]
                want = ref.process(stream[..., lo : lo + w], **kw)
                torch.cuda.synchronize()
                require(frame.vertices.shape == (streams, w, 3) and frame.vertices.device.type == "cuda",
                        "vectorscope vertices on the card")
                for key in ("vertices", "balance", "correlation_bars", "gain"):
                    require(bool(torch.isfinite(getattr(frame, key)).all()), f"vectorscope {key} finite")
                g = max(float(want.gain.max()), 1.0)
                err = float((frame.vertices.cpu() - want.vertices).abs().max()) / g
                bars = max(float((frame.balance.cpu() - want.balance).abs().max()),
                           float((frame.correlation_bars.cpu() - want.correlation_bars).abs().max()))
                gerr = float(((frame.gain.cpu() - want.gain).abs() / want.gain.abs()).max())
                require(err <= 5e-6, f"vectorscope {mode.name} {gain.name}: vertices differ from the CPU's by {err} x gain")
                require(bars <= 5e-6, f"vectorscope {mode.name} {gain.name}: bars differ from the CPU's by {bars}")
                require(gerr <= 1e-5, f"vectorscope {mode.name} {gain.name}: gain differs from the CPU's by {gerr}")
                worst = max(worst, err, bars)
            bal = frame.balance[:, 0].cpu().numpy()
            corr = frame.correlation_bars[:, 0].cpu().numpy()
            require(bal[0] < 0.01 and abs(bal[1] - 0.5) < 0.01 and bal[2] > 0.99,
                    f"balance bars {bal[:3]} for hard-left, centre, hard-right")
            require(bal[3] == 0.5, f"an exactly silent right reads {bal[3]}, not 0.5")
            require(abs(corr[1] - 1.0) < 0.01 and abs(corr[4]) < 0.01,
                    f"correlation bars {corr[1]}, {corr[4]} for mono, inverted")
            require(bool((frame.vertices[5, :, :2] == 0).all()), "silence draws the origin")
            if gain != VectorscopeAutoGain.NONE:
                require(float(frame.gain[5]) == 1.0, f"silence moved the held gain to {float(frame.gain[5])}")
            x = on_card[..., :w]
            ms = call_ms(torch, lambda: proc.process(x))
            ms_new = call_ms(torch, lambda: proc.process(x, new_samples=hop, meter_frames=x[..., -1024:]))
            report["configs"][f"{mode.name.lower()}_{gain.name.lower()}"] = {
                "max_err_vs_cpu": worst, "ms_per_call": ms, "ms_per_call_meter_slice": ms_new,
                "frames_per_s": streams / (ms / 1e3),
            }
            if mode == OperationalMode.LISSAJOUS and gain == VectorscopeAutoGain.PEAK_DECAY:
                keep = (proc, x)
    report["checks"] = "balance 0/0.5/1, silent right 0.5, correlation 1/0, silence finite with held gain"
    info(report)
    return keep


def phase_spectrogram(torch, dev, results, launches_out, calls_out):
    """The Spectrogram at full width: (a) the bench's batched step
    (bench.py:881-924, cfg4): LEFT, 16384-point window, 1024 px,
    LOGARITHMIC, 1 pair x T = 512 with the validity mask; (b) the
    production tick (bench.py:940-992, cfg4b): 240 pushes of 800 samples,
    a pull each, by both ingest routes, and a 16-pair run; (c) the colour
    map's kernel alone at the redraw's 512 x 1024 pixels, read from kernel
    B's strided output row, against its plain version."""
    from signalizer_tpu_torch import DisplayMode, SpectrogramProcessor, SpectrumChannels
    from signalizer_tpu_torch.core.constant import make_spectrum_constant
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import spectrum as ts
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm
    from signalizer_tpu_torch.kernels.colormap import (
        gradient_bounds, normalize_ratios, spectrogram_columns, spectrogram_columns_plain)
    from signalizer_tpu_torch.stream.device_ring import extract_frames
    from signalizer_tpu_torch.views import spectrogram as tv

    report = {"phase": "spectrogram"}
    # (a) cfg4
    c4 = make_spectrum_constant(device=dev, **headline(
        window_size=16384, configuration=SpectrumChannels.LEFT, display_mode=DisplayMode.COLOUR_SPECTRUM))
    t4 = 512
    frames = _frames(torch, (1, t4, 2, 16384), seed=44, dev=dev)
    valid = np.ones(t4, bool)
    valid[-3:] = False
    colours = torch.from_numpy(tv.DEFAULT_GRADIENT[None]).to(dev)
    ratios = torch.from_numpy(normalize_ratios(tv.DEFAULT_RATIOS).astype(np.float32)).to(dev)
    bounds = gradient_bounds(ratios)
    state, plain_state = ts.init_line_graph_state(c4, (1,)), ts.init_line_graph_state(c4, (1,))
    reset_counters("window_fft_mag.launches", "display_map.launches", "colormap.launches")
    cols, _ = tv.spectrogram_step(c4, state, frames, colours, ratios, valid, bounds)
    a_launches, b_launches = counter("window_fft_mag.launches"), counter("display_map.launches")
    map_launches = counter("colormap.launches")
    plain = dm.display_map_plain(c4, wfm.window_fft_mag_plain(c4, frames), plain_state.magnitude, valid)
    want = spectrogram_columns_plain(plain[:, :, 0, 0, :], colours, ratios)
    torch.cuda.synchronize()
    require((a_launches, b_launches, map_launches) == (1, 1, 1),
            f"cfg4: kernels A, B and the colour map launched {a_launches}, {b_launches}, {map_launches} times")
    require(cols.shape == (t4, AXIS_POINTS, 4) and cols.dtype == torch.uint8, f"cfg4 columns {tuple(cols.shape)}")
    diff = (cols.to(torch.int16) - want.to(torch.int16)).abs()
    require(int(diff.max()) <= 1 and float((diff != 0).float().mean()) <= 1e-3 and bool((cols[..., 3] == 255).all()),
            f"cfg4 columns vs plain: max byte difference {int(diff.max())}, {float((diff != 0).float().mean()):.2%} differ")
    require(torch.equal(cols[-3:], cols[-4:-3].expand(3, -1, -1)), "cfg4: a padded frame repeats the last column")
    scratch = ts.init_line_graph_state(c4, (1,))
    step_ms = call_ms(torch, lambda: tv.spectrogram_step(c4, scratch, frames, colours, ratios, valid, bounds))
    # kernel B's least time here: one row of magnitudes a frame in, K rows of
    # display values out, the state twice
    out_values = t4 * c4.num_line_graphs * AXIS_POINTS
    b_bound = roofline(4.0 * (t4 * c4.n_spectrum_values + out_values + 2 * state.magnitude.numel()), 30.0 * out_values)
    report["cfg4"] = {
        "frames": list(frames.shape), "frames_mb": nbytes(frames) / 1e6, "launches": {"a": a_launches, "b": b_launches},
        "kernel_b_bound_ms": b_bound["bound_ms"], "kernel_b_blocks": (AXIS_POINTS // 32) * c4.state_channels,
        "byte_differences_vs_plain": float((diff != 0).float().mean()), "ms_per_step": step_ms,
        "frames_per_s": t4 / (step_ms / 1e3),
    }
    cfg4_call = lambda: tv.spectrogram_step(c4, scratch, frames, colours, ratios, valid, bounds)  # noqa: E731

    # (b) cfg4b, both routes on the same seeded stream
    ticks, tick_n, hop = 240, 800, 480
    rng = np.random.default_rng(2029)
    n = np.arange(ticks * tick_n)
    tone_hz = 3000.0
    audio = (rng.standard_normal((2, ticks * tick_n)) * 0.003).astype(np.float32)
    audio[0] += (0.5 * np.sin(2 * np.pi * tone_hz * n / FS)).astype(np.float32)
    audio[:, 100 * tick_n : 140 * tick_n] = 0.0  # a stretch of digital silence
    kw = dict(pairs=1, blob_ms=10.0, axis_points=256, window_size=4096, sample_rate=FS)
    columns, per_route = {}, {}
    for route in ("device", "host"):
        sp = SpectrogramProcessor(device=dev, device_ingest=(route == "device"), **kw)
        reset_counters("window_fft_mag.launches", "display_map.launches", "colormap.launches")
        cols_out, ms, lags = [], [], []
        for i in range(ticks):
            sp.push(audio[:, i * tick_n : (i + 1) * tick_n])
            t0 = time.perf_counter()
            cols_out.append(sp.pull())
            ms.append((time.perf_counter() - t0) * 1e3)
            lag = sp.freshness_lag()
            if lag is not None:
                lags.append(lag)
        pulls = sum(1 for c_ in cols_out if c_.shape[0])
        columns[route] = np.concatenate(cols_out)
        a_pulled, b_pulled = counter("window_fft_mag.launches"), counter("display_map.launches")
        map_pulled = counter("colormap.launches")
        require(a_pulled == b_pulled == map_pulled == sp.readbacks,
                f"cfg4b {route}: launches {a_pulled}, {b_pulled}, {map_pulled}, readbacks {sp.readbacks}")
        # the colour map's main-path launches: the cfg4 step's one, then each route's pulls
        launches_out["colormap"] = launches_out.get("colormap", 1) + map_pulled
        calls_out["colormap"] = calls_out.get("colormap", 1) + sp.readbacks
        require(counter("window_fft_mag.launches") >= pulls > 200,
                f"cfg4b {route}: {counter('window_fft_mag.launches')} launches in {pulls} pulls with frames")
        require(max(lags) < hop, f"cfg4b {route}: freshness lag {max(lags)} >= one hop")
        require(sp.batcher.dropped_frames == 0, f"cfg4b {route}: dropped {sp.batcher.dropped_frames} frames")
        steady = ms[20:]
        per_route[route] = {
            "pull_p50_ms": float(np.percentile(steady, 50)), "pull_p99_ms": float(np.percentile(steady, 99)),
            "kernel_a_launches_per_pull": counter("window_fft_mag.launches") / pulls,
            "kernel_b_launches_per_pull": counter("display_map.launches") / pulls,
            "syncs_per_pull": sp.readbacks / pulls, "columns": int(columns[route].shape[0]),
            "lag_max_samples": float(max(lags)),
        }
        if route == "device":
            keep = sp
    require(np.array_equal(columns["device"], columns["host"]), "cfg4b: the two ingest routes' columns differ")
    cols = columns["device"]
    require(cols.shape == (1 + (ticks * tick_n - 4096) // hop, 256, 4), f"cfg4b columns {cols.shape}")
    require(bool((cols[..., 3] == 255).all()), "cfg4b alpha")
    mapped = keep.constant.mapped_frequencies.cpu().numpy()
    expect = int(np.argmin(np.abs(mapped - tone_hz)))
    bright = cols[50, :, :3].astype(int).sum(-1)
    require(abs(int(np.argmax(bright)) - expect) <= 1, f"cfg4b: column peaks at {int(np.argmax(bright))}, sine at {expect}")
    # frames lying wholly inside the silent stretch (after the decay let go) are black
    first_silent = -(-(100 * tick_n) // hop)
    last_silent = (140 * tick_n - 4096) // hop
    require(last_silent - first_silent > 20, "silent stretch covers whole frames")
    silent = cols[last_silent - 3 : last_silent]
    require(bool((silent[..., :3] == 0).all()), "cfg4b: silence is not the black column")
    report["cfg4b"] = dict(per_route, byte_equal_routes=True, sine_pixel=expect)

    # 16 pairs: the per-pair colour rotation and the blend
    sp16 = SpectrogramProcessor(device=dev, **dict(kw, pairs=PAIRS))
    ref16 = SpectrogramProcessor(device="cpu", **dict(kw, pairs=PAIRS))
    audio16 = (rng.standard_normal((2 * PAIRS, 24 * tick_n)) * 0.01).astype(np.float32)
    for ch in range(2 * PAIRS - 2):
        audio16[ch] += (0.4 * np.sin(2 * np.pi * (300.0 + 400.0 * ch) * n[: 24 * tick_n] / FS)).astype(np.float32)
    audio16[-2:] = 0.0
    got16, want16, ms16 = [], [], []
    for i in range(24):
        block = audio16[:, i * tick_n : (i + 1) * tick_n]
        sp16.push(block)
        ref16.push(block)
        t0 = time.perf_counter()
        got16.append(sp16.pull())
        ms16.append((time.perf_counter() - t0) * 1e3)
        want16.append(ref16.pull())
    got16, want16 = np.concatenate(got16), np.concatenate(want16)
    d16 = np.abs(got16.astype(np.int16) - want16.astype(np.int16))
    require(got16.shape == want16.shape and got16.shape[0] > 30, f"16 pairs: columns {got16.shape}")
    require(d16.max() <= 1 and (d16 != 0).mean() <= 1e-3, f"16 pairs vs the CPU: max {d16.max()}, {(d16 != 0).mean():.2%} differ")
    require(len(np.unique(got16[..., :3].reshape(-1, 3), axis=0)) > 2, "16 pairs: the blend shows one colour")
    report["pairs16"] = {"columns": int(got16.shape[0]), "byte_differences_vs_cpu": float((d16 != 0).mean()),
                         "pull_p50_ms": float(np.percentile(ms16[8:], 50))}
    info(report)

    block = audio[:, :tick_n]

    def tick():
        keep.push(block)
        keep.pull()

    def windows_copy():
        # the one copy the device route makes: two hop-spaced windows off the
        # ring into the contiguous frames kernel A's wrapper takes
        return extract_frames(keep.ring, 4096, hop, 2, frame_axis=-3).contiguous()

    # (c) the colour map alone at the redraw's geometry: 1 pair, 512 x 1024
    # pixels, the [:, :, 0, 0, :] view of a [1, 512, 2, 2, 1024] tensor as
    # kernel B leaves it; the kernel's bytes are the plain version's
    rows = np.random.default_rng(47).uniform(-0.2, 1.2, (1, t4, 2, 2, AXIS_POINTS)).astype(np.float32)
    shades = torch.from_numpy(rows).to(dev)[:, :, 0, 0, :]
    reset_counters("colormap.launches")
    got = spectrogram_columns(shades, colours, ratios, bounds)
    want = spectrogram_columns_plain(shades, colours, ratios, bounds)
    torch.cuda.synchronize()
    require(counter("colormap.launches") == 1, "the colour map did not launch its kernel once")
    require(torch.equal(got, want), f"the colour map: {int((got != want).sum())} bytes differ from the plain version")
    # least time: each intensity read once, each pixel's 4 bytes written once
    bound = roofline(4.0 * t4 * AXIS_POINTS + 4.0 * t4 * AXIS_POINTS, 0.0)
    map_call = lambda: spectrogram_columns(shades, colours, ratios, bounds)  # noqa: E731
    results["colormap"] = dict(
        pixels=[t4, AXIS_POINTS], intensity_strides=list(shades.stride()), byte_equal_to_plain=True,
        ms=median_ms(torch, map_call),
        plain_ms=median_ms(torch, lambda: spectrogram_columns_plain(shades, colours, ratios, bounds)),
        **bound, library_ms=None,
    )
    info({"phase": "colormap", **results["colormap"]})
    return cfg4_call, tick, windows_copy, map_call


def phase_resonator(torch, dev, launches_out, calls_out, results):
    """ResonatorSpectrumProcessor over the Spectrum headline constant, 16
    pairs: ticks of one 800-sample chunk, then the bench's backlog shape
    (bench.py:1052-1114, cfg6: T = 16 chunks of 512) with the last 3 chunks
    invalid; each call held against the same step with the display tail on
    the plain ``decay_db`` and the recurrence on kernel H's plain loop, on
    the same CUDA tensors (the bank bit-equal); kernel H once a call. Then
    kernel H's phase (:func:`phase_kernel_h`)."""
    from signalizer_tpu_torch import ResonatorSpectrumProcessor
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import resonator as rz
    from signalizer_tpu_torch.kernels import resonator_scan as rs
    from signalizer_tpu_torch.kernels import spectrum as ts

    proc = ResonatorSpectrumProcessor.create(pairs=PAIRS, device=dev, **headline())
    plain = ResonatorSpectrumProcessor.create(pairs=PAIRS, device=dev, **headline())
    c = proc.constant
    f = c.host_frequencies
    px = (400, 700)
    total = 6 * 800 + 16 * 512
    n = np.arange(total)
    rng = np.random.default_rng(2030)
    stream = (rng.standard_normal((PAIRS, 2, total)) * 0.002).astype(np.float32)
    stream[:, 0] += (0.7 * np.sin(2 * np.pi * f[px[0]] * n / FS)).astype(np.float32)
    stream[:, 1] += (0.4 * np.sin(2 * np.pi * f[px[1]] * n / FS)).astype(np.float32)
    stream[-1] = 0.0
    x = torch.from_numpy(stream).to(dev)
    backlog_valid = np.ones(16, bool)
    backlog_valid[-3:] = False
    calls = [(x[..., i * 800 : (i + 1) * 800][:, :, None, :], None) for i in range(6)]
    calls.append((x[..., 4800:].reshape(PAIRS, 2, 16, 512), backlog_valid))

    worst = 0.0
    reset_counters("display_map.decay_db_launches", "resonator_scan.launches")
    scan_launches = 0
    for blocks, valid in calls:
        plain.load_state(proc.res_state, ts.LineGraphState(*(t.clone() for t in proc.graph_state)))
        before = counter("resonator_scan.launches")
        out = proc.process_chunks(blocks, valid=valid)
        scan_launches += counter("resonator_scan.launches") - before
        counted = (counter("display_map.decay_db_launches"), counter("resonator_scan.launches"))
        # the plain tail and the plain scan, on the same CUDA tensors
        tail, scan = ts.display_decay_db, rz.resonator_scan
        ts.display_decay_db, rz.resonator_scan = dm.decay_db, rs.resonator_scan_plain
        try:
            want = plain.process_chunks(blocks, valid=valid)
        finally:
            ts.display_decay_db, rz.resonator_scan = tail, scan
        torch.cuda.synchronize()
        require((counter("display_map.decay_db_launches"), counter("resonator_scan.launches")) == counted,
                "the plain tail or scan launched a kernel")
        require(out.shape == (PAIRS, 1, 2, 2, AXIS_POINTS) and bool(torch.isfinite(out).all()), "resonator output")
        require(torch.equal(proc.res_state, plain.res_state), "resonator bank differs from the plain scan's")
        require(torch.equal(proc.graph_state.magnitude, plain.graph_state.magnitude),
                "resonator graph state differs from the plain tail's")
        worst = max(worst, float((out - want).abs().max()))
        require(bool((out[-1] == float(c.clip_db)).all()), "silent pair reads clip_db")
    launches = counter("display_map.decay_db_launches")
    require(launches == len(calls), f"decay_db launched {launches} times in {len(calls)} calls")
    require(scan_launches == len(calls), f"kernel H launched {scan_launches} times in {len(calls)} calls")
    require(worst <= 1e-5, f"resonator display vs the plain tail {worst} > 1e-5")
    launches_out["display_decay_db"] = launches
    calls_out["display_decay_db"] = len(calls)
    launches_out["resonator_scan"] = scan_launches
    calls_out["resonator_scan"] = len(calls)
    h_report = phase_kernel_h(torch, dev, proc, calls, results)
    main = out[0, 0, 0].cpu().numpy()  # LineMain [rows, P]
    peaks = [int(np.argmax(main[0])), int(np.argmax(main[1]))]
    require(abs(peaks[0] - px[0]) <= 1 and abs(peaks[1] - px[1]) <= 1, f"two tones peak at {peaks}, not {px}")

    # invalid chunks: what they hold does not matter, and a call with no
    # valid chunk leaves the bank as it was
    bank, graph = proc.res_state.clone(), proc.graph_state.magnitude.clone()
    blocks = calls[-1][0]
    other = blocks.clone()
    other[:, :, -3:] = 9.0
    proc.process_chunks(blocks, valid=backlog_valid)
    a_bank, a_graph = proc.res_state.clone(), proc.graph_state.magnitude.clone()
    proc.load_state(bank.clone(), ts.LineGraphState(graph.clone(), proc.graph_state.phase))
    proc.process_chunks(other, valid=backlog_valid)
    require(torch.equal(proc.res_state, a_bank) and torch.equal(proc.graph_state.magnitude, a_graph),
            "an invalid chunk's samples changed the states")
    before = proc.res_state.clone()
    proc.process_chunks(blocks, valid=np.zeros(16, bool))
    require(torch.equal(proc.res_state, before), "a call with no valid chunk moved the bank")

    tick = calls[0][0]
    tick_ms = call_ms(torch, lambda: proc.process_chunks(tick))
    backlog_ms = call_ms(torch, lambda: proc.process_chunks(blocks, valid=backlog_valid))
    plan = proc.block_plan(800)
    # information only: the tick's drive, a float32 product of height 32
    # (16 pairs x 2 rows) against the [6144, 800] ramp, as the library runs it
    # from the plan's layout and from the transposed one; it must read the
    # ramp once
    rows = tick.reshape(-1, 800)
    transposed = plan.drive_matrix.t().contiguous()
    drive = {
        "rows_ramp_t_ms": median_ms(torch, lambda: torch.matmul(rows, plan.drive_matrix.t())),
        "rows_transposed_ms": median_ms(torch, lambda: torch.matmul(rows, transposed)),
        "ramp_rows_t_ms": median_ms(torch, lambda: torch.matmul(plan.drive_matrix, rows.t())),
        **roofline(nbytes(rows, plan.drive_matrix) + rows.shape[0] * plan.drive_matrix.shape[0] * 4,
                   2.0 * rows.shape[0] * plan.drive_matrix.numel()),
    }
    info({
        "phase": "resonator", "pairs": PAIRS, "pixels": AXIS_POINTS, "vectors": proc.resonator.vectors,
        "calls": [list(b.shape) for b, _ in calls], "decay_db_launches": launches,
        "max_abs_err_vs_plain_tail": worst, "two_tone_pixels": peaks,
        "ramp_mb": {"w800": nbytes(plan.drive_matrix) / 1e6, "w512": nbytes(proc.block_plan(512).drive_matrix) / 1e6},
        "tick_ms": tick_ms, "backlog_t16_ms": backlog_ms, "readouts_per_s_backlog": PAIRS * 16 / (backlog_ms / 1e3),
        "tick_drive_product": drive, "resonator_scan_launches": scan_launches,
    })
    return [("resonator_tick", lambda: proc.process_chunks(tick)),
            ("resonator_backlog_t16", lambda: proc.process_chunks(blocks, valid=backlog_valid)), *h_report]


def scan_args(torch, proc, state, blocks, valid, emit=False):
    """Kernel H's arguments for a resonator processor's call on ``blocks``
    [pairs, 2, T, W] from ``state``, formed as ``rsnt_chunks`` forms them
    (the channel mix, then the drives' one matrix product)."""
    from signalizer_tpu_torch.kernels import resonator as rz
    from signalizer_tpu_torch.views.spectrum import _mix_rsnt

    plan = proc.block_plan(blocks.shape[-1])
    mixed = _mix_rsnt(proc.constant.configuration, blocks)
    drives = rz._drive(plan.drive_matrix, mixed, proc.resonator.num_pixels, proc.resonator.vectors)
    return (state, drives, plan.decay[..., 0], plan.decay[..., 1], proc.resonator.combine, proc.resonator.gain,
            valid, emit)


def phase_kernel_h(torch, dev, proc, calls, results):
    """Kernel H (the resonator bank's chunk recurrence and readouts) against
    its plain loop on the same drives: the cfg6 tick and backlog (the last 3
    chunks invalid) from the bank's state, both with a readout after every
    chunk, and a PHASE bank at the headline constant on the backlog (kernel
    H and kernel G once a call, against the plain scan and tail); the state
    bit-equal, the readouts within 1e-6 of each row's peak. Timed at the
    backlog beside the plain loop. Returns the calls the profile phase
    profiles."""
    from signalizer_tpu_torch import ResonatorSpectrumProcessor, SpectrumChannels
    from signalizer_tpu_torch.kernels import phase_decay_db as pd
    from signalizer_tpu_torch.kernels import resonator as rz
    from signalizer_tpu_torch.kernels import resonator_scan as rs
    from signalizer_tpu_torch.kernels import spectrum as ts

    report = {"phase": "kernel_h", "bound": "state bit-equal to the plain loop, readouts <= 1e-6 of each row's peak",
              "cases": {}}
    state0 = proc.res_state.clone()
    for (blocks, valid), name in ((calls[0], "cfg6_tick"), (calls[-1], "cfg6_backlog_last3_invalid")):
        for emit in (False, True):
            args = scan_args(torch, proc, state0, blocks, valid, emit)
            got, want = rs.resonator_scan(*args), rs.resonator_scan_plain(*args)
            torch.cuda.synchronize()
            require(torch.equal(got.state, want.state), f"kernel H {name}: state differs from the plain loop")
            require(torch.equal(state0, proc.res_state), f"kernel H {name}: the input state moved")
            errs = {k: row_rel_err(getattr(got, k), getattr(want, k))
                    for k in ("re", "im", "magnitude") + (("readouts",) if emit else ())}
            require(max(errs.values()) <= 1e-6, f"kernel H {name}: readouts {errs} > 1e-6 of the peak")
            key = name + ("_readouts" if emit else "")
            report["cases"][key] = {"drives": list(args[1].shape), "state_bit_equal": True, "err_of_peak": errs}
            if name.startswith("cfg6_backlog") and not emit:
                ms = median_ms(torch, lambda: rs.resonator_scan(*args))
                plain_ms = median_ms(torch, lambda: rs.resonator_scan_plain(*args))
                b, p, v = args[0].shape[0] * args[0].shape[1], args[0].shape[2], args[0].shape[3]
                t = args[1].shape[2]
                # the drives read once, the state read and written once, the
                # readouts written once; 8 flops a step a vector, 4v + 4 a readout
                bound = roofline(nbytes(args[1], got.re, got.im, got.magnitude) + 2 * nbytes(args[0]),
                                 8.0 * b * t * p * v + (4.0 * v + 4.0) * b * p)
                results["resonator_scan"] = dict(
                    max_abs_err=max(float((getattr(got, k) - getattr(want, k)).abs().max())
                                    for k in ("re", "im", "magnitude")),
                    ms=ms, plain_ms=plain_ms, **bound, library_ms=None,
                )
                report["cases"][key].update(ms=ms, plain_ms=plain_ms, **bound)
                alone = (lambda args=args: rs.resonator_scan(*args))

    # the PHASE configuration: the bank's (re, im) readouts feed kernel G
    ph = ResonatorSpectrumProcessor.create(pairs=PAIRS, device=dev, **headline(configuration=SpectrumChannels.PHASE))
    ref = ResonatorSpectrumProcessor.create(pairs=PAIRS, device=dev, **headline(configuration=SpectrumChannels.PHASE))
    for blocks, valid in (calls[0], calls[-1], calls[-1]):
        ref.load_state(ph.res_state.clone(), ts.LineGraphState(*(t.clone() for t in ph.graph_state)))
        before = (counter("resonator_scan.launches"), counter("phase_decay_db.launches"))
        out = ph.process_chunks(blocks, valid=valid)
        after = (counter("resonator_scan.launches"), counter("phase_decay_db.launches"))
        scan, tail = rz.resonator_scan, ts.phase_decay_db
        rz.resonator_scan, ts.phase_decay_db = rs.resonator_scan_plain, pd.phase_decay_db_plain
        try:
            want = ref.process_chunks(blocks, valid=valid)
        finally:
            rz.resonator_scan, ts.phase_decay_db = scan, tail
        torch.cuda.synchronize()
        require(tuple(b - a for a, b in zip(before, after)) == (1, 1), "PHASE bank: kernels H and G not once each")
        require((counter("resonator_scan.launches"), counter("phase_decay_db.launches")) == after,
                "the plain scan or tail launched a kernel")
        require(torch.equal(ph.res_state, ref.res_state), "PHASE bank differs from the plain scan's")
        require(torch.equal(ph.graph_state.magnitude, ref.graph_state.magnitude)
                and torch.equal(ph.graph_state.phase, ref.graph_state.phase), "PHASE bank's tail states differ")
        err = float((out - want).abs().max())
        require(err <= 1e-5, f"PHASE bank display vs the plain scan and tail: {err} > 1e-5")
        report["cases"].setdefault("phase_bank", {"calls": 0, "max_abs_err": 0.0})
        report["cases"]["phase_bank"]["calls"] += 1
        report["cases"]["phase_bank"]["max_abs_err"] = max(report["cases"]["phase_bank"]["max_abs_err"], err)
    blocks, valid = calls[-1]
    report["phase_backlog_ms"] = call_ms(torch, lambda: ph.process_chunks(blocks, valid=valid))
    info(report)
    return [("resonator_scan_backlog", alone),
            ("resonator_phase_backlog_t16", lambda: ph.process_chunks(blocks, valid=valid))]


def make_stream(pairs: int, n_frames: int):
    """Seeded stereo stream [pairs, 2, L] at 48 kHz: pair i carries a sine
    on an exact FFT bin between 100 Hz and 15 kHz (both channels, the right
    one phase-shifted) plus independent noise 40 dB below it; the last pair
    is silent. Returns the stream and each sounding pair's frequency."""
    rng = np.random.default_rng(2026)
    length = HOP * (n_frames - 1) + WINDOW
    n = np.arange(length)
    bins = np.unique(np.round(np.geomspace(100.0, 15_000.0, pairs - 1) * WINDOW / FS).astype(int))
    require(len(bins) == pairs - 1, "distinct sine bins")
    freqs = bins * FS / WINDOW
    amp = 0.5
    noise_std = amp / np.sqrt(2.0) * 10 ** (-40 / 20)
    stream = np.zeros((pairs, 2, length), np.float32)
    for i, f in enumerate(freqs):
        for ch, phase in ((0, 0.0), (1, 0.3)):
            tone = amp * np.sin(2 * np.pi * f * n / FS + phase)
            stream[i, ch] = tone + rng.standard_normal(length) * noise_std
    return stream, freqs


def frame_stream(stream, n_frames: int):
    """[pairs, 2, L] -> [pairs, n_frames, 2, WINDOW] at hop HOP."""
    view = np.lib.stride_tricks.sliding_window_view(stream, WINDOW, axis=-1)[:, :, ::HOP]
    return np.ascontiguousarray(view[:, :, :n_frames].transpose(0, 2, 1, 3))


def phase_slice(torch, dev, launches_out, calls_out):
    from signalizer_tpu_torch import SpectrumProcessor
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm

    n_frames = 3 * T + 3
    stream, freqs = make_stream(PAIRS, n_frames)
    frames = frame_stream(stream, n_frames)
    proc = SpectrumProcessor.create(pairs=PAIRS, device=dev, **headline())
    c = proc.constant
    clip_db = float(c.clip_db)
    plain_state = proc.state.magnitude.clone()
    calls = [frames[:, i * T : (i + 1) * T] for i in range(3)]
    calls += [frames[:, 3 * T + i] for i in range(3)]  # per-tick [pairs, 2, W]

    worst = 0.0
    reset_counters("window_fft_mag.launches")
    reset_counters("display_map.launches")
    for chunk in calls:
        out = proc.process(chunk)
        x = torch.from_numpy(chunk).to(dev)
        if x.ndim == 3:
            x = x[:, None]
        want = dm.display_map_plain(c, wfm.window_fft_mag_plain(c, x), plain_state)
        torch.cuda.synchronize()
        require(out.shape == want.shape, "slice output shape")
        require(bool(torch.isfinite(out).all()), "slice output finite")
        worst = max(worst, float((out - want).abs().max()))
        require(bool((out[-1] == clip_db).all()), "silent pair reads clip_db everywhere")
    launches = {"window_fft_mag": counter("window_fft_mag.launches"), "display_map": counter("display_map.launches")}
    launches_out.update(launches)
    calls_out.update({name: len(calls) for name in launches})
    require(worst <= 2e-4, f"slice vs plain display error {worst} > 2e-4")
    require(launches == {"window_fft_mag": len(calls), "display_map": len(calls)},
            f"launch counts {launches} != {len(calls)} calls each")
    state_err = float(((proc.state.magnitude - plain_state).abs()).max())
    require(state_err <= 1e-5 * float(plain_state.abs().max()), f"slice state error {state_err}")

    # each sounding pair's LineMain peak lies within one pixel of its sine
    mapped = c.mapped_frequencies.cpu().numpy()
    last = out[:, -1, 0].cpu().numpy()  # [pairs, rows, P], LineMain
    peaks = []
    for i, f in enumerate(freqs):
        expect = int(np.argmin(np.abs(mapped - f)))
        for r in range(2):
            got = int(np.argmax(last[i, r]))
            require(abs(got - expect) <= 1, f"pair {i} row {r}: peak pixel {got}, sine at {expect} ({f} Hz)")
        peaks.append([float(f), expect, int(np.argmax(last[i, 0]))])

    # information only: throughput on device-resident frames
    x = torch.from_numpy(calls[0]).to(dev)
    scratch = proc.state.magnitude.clone()
    slice_ms = median_ms(torch, lambda: proc.process(x), reps=10)
    plain_ms = median_ms(
        torch, lambda: dm.display_map_plain(c, wfm.window_fft_mag_plain(c, x), scratch), reps=10
    )
    tick = torch.from_numpy(calls[3]).to(dev)
    tick_ms = median_ms(torch, lambda: proc.process(tick))
    info({
        "phase": "slice",
        "calls": [list(np.shape(ch)) for ch in calls],
        "max_abs_err_vs_plain": worst,
        "state_max_abs_err": state_err,
        "launches": launches,
        "peaks_hz_expected_got": peaks,
        "frames_per_s": PAIRS * T / (slice_ms / 1e3),
        "plain_frames_per_s": PAIRS * T / (plain_ms / 1e3),
        "t128_call_ms": slice_ms,
        "plain_t128_call_ms": plain_ms,
        "t1_call_ms": tick_ms,
    })
    return proc, x, tick


def osc_kwargs(**overrides) -> dict:
    """The oscilloscope's cfg3 constant keywords (bench.py:769-822)."""
    from signalizer_tpu_torch import AutoGain, OscChannels, SubSampleInterpolation, TriggerMode

    kw = dict(
        sample_rate=OSC_FS,
        channel_mode=OscChannels.SEPARATE,
        trigger_mode=TriggerMode.ZERO_CROSSING,
        interpolation=SubSampleInterpolation.LANCZOS,
        pixels=OSC_PIXELS,
        lookahead=8192,
        trigger_threshold=0.1,
        autogain=AutoGain.PEAK_DECAY,
    )
    kw.update(overrides)
    return kw


# each resample kind's position clip range (kernels/oscilloscope.py), by a and W
CLIP = {
    "lanczos": lambda a, w: (-(a + 1.0), w - 1.0 + a),
    "linear": lambda a, w: (-2.0, float(w)),
    "nearest": lambda a, w: (-1.0, float(w)),
}


def resample_case(torch, dev, kind, a, rows, p, step, where, seed):
    """x [16, rows, 16384], f32 positions start + k * step [16, p], clipped
    as the callers clip them, and the f32 starts [16]; ``where`` is "inside"
    (seeded starts within the history), "edges" (even pairs start off the
    left edge, odd pairs run off the right one) or "samples" (positions on
    samples, within 1e-6 either side of them and on half samples, about
    samples spread over the row and at both of its ends)."""
    rng = np.random.default_rng(seed)
    w = OSC_HISTORY
    x = (rng.standard_normal((PAIRS, rows, w)) * 0.4).astype(np.float32)
    lo, hi = CLIP[kind](a, w)
    span = step * (p - 1)
    if where == "edges":
        starts = np.where(np.arange(PAIRS) % 2 == 0, lo - 2.7, hi - span / 2 + 0.21)
    else:
        starts = rng.uniform(0.0, w - 1.0 - span, PAIRS) + 0.3137
    k = np.arange(p, dtype=np.float64)
    pos = np.float32(starts)[:, None].astype(np.float64) + k * np.float64(np.float32(step))
    if where == "samples":
        off = np.array([0.0, 1e-7, -1e-7, 5e-7, -5e-7, 9e-7, -9e-7, 1.1e-6, -1.1e-6, 1e-5, -1e-5,
                        0.5, 0.5 - 1e-7, 0.5 + 1e-7, -0.5, 0.25])
        base = np.concatenate([[0.0, 1.0, w - 2.0, w - 1.0], rng.integers(2, w - 2, p // len(off) - 4)])
        pos = np.tile((base[:, None] + off[None, :]).reshape(-1), (PAIRS, 1))
    pos = np.clip(pos.astype(np.float32), lo, hi).astype(np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(pos).to(dev), torch.from_numpy(np.float32(starts)).to(dev)


def phase_kernel_c(torch, dev, results):
    from signalizer_tpu_torch.kernels import banded_resample as br

    up = (OSC_WINDOW - 1.0) / (OSC_PIXELS - 1)  # cfg3's 8x upsample step
    zoom_out = (OSC_HISTORY - 1.0) / 1023  # 16384 samples over 1024 px
    cases = [  # name, kind, a, with_nearest, rows, P, step, where
        ("cfg3", "lanczos", 10, True, 2, OSC_PIXELS, up, "inside"),
        ("cfg3_linear", "linear", 1, False, 2, OSC_PIXELS, up, "inside"),
        ("cfg3_nearest", "nearest", 1, False, 2, OSC_PIXELS, up, "inside"),
        ("tail_p160", "lanczos", 10, True, 2, 160, 0.8, "inside"),
        ("global_step16", "lanczos", 10, True, 2, 1024, zoom_out, "inside"),
        ("edges", "lanczos", 10, True, 2, OSC_PIXELS, up, "edges"),
        ("edges_linear", "linear", 1, False, 2, OSC_PIXELS, up, "edges"),
        ("edges_nearest", "nearest", 1, False, 2, OSC_PIXELS, up, "edges"),
        ("colour_rows6", "nearest", 1, False, 6, OSC_PIXELS, up, "inside"),
        ("a5", "lanczos", 5, True, 2, OSC_PIXELS, up, "inside"),
        ("a16", "lanczos", 16, True, 2, OSC_PIXELS, up, "inside"),
        ("a16_edges", "lanczos", 16, False, 2, OSC_PIXELS, up, "edges"),
        ("one_pixel", "lanczos", 10, True, 2, 1, up, "inside"),
        ("on_samples", "lanczos", 10, True, 2, 1024, 1.0, "samples"),
        ("on_samples_a16", "lanczos", 16, True, 2, 1024, 1.0, "samples"),
        ("on_samples_linear", "linear", 1, True, 2, 1024, 1.0, "samples"),
    ]
    affine_cases = {"cfg3", "cfg3_linear", "cfg3_nearest", "global_step16", "edges", "edges_linear",
                    "edges_nearest", "a16_edges"}
    report = {"phase": "kernel_c",
              "bound": "max|kernel - plain| / max|x|: <= 1e-5 lanczos and linear, 0 nearest and the nearest pick, "
                       "for positions read from a tensor and for positions formed in the kernel; "
                       "positions formed in the kernel against the same positions read from a tensor: "
                       "<= 1e-6 lanczos and linear, 0 nearest and the nearest pick",
              "cases": {}}
    for i, (name, kind, a, dual, rows, p, step, where) in enumerate(cases):
        x, pos, start = resample_case(torch, dev, kind, a, rows, p, step, where, seed=30 + i)

        def kernel():
            return br.banded_resample(x, pos, a=a, kind=kind, with_nearest=dual)

        def plain():
            return br.banded_resample_plain(x, pos, a=a, kind=kind, with_nearest=dual)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        scale = float(x.abs().max())
        affine_err = affine_plain_err = None
        if name in affine_cases:
            # the entry the oscilloscope step calls: the kernel forming these
            # positions itself, held against its plain version and against
            # itself reading them (the same f32 values but for a rare
            # double-rounding tie of the tensor's float64 sum)
            lo, hi = CLIP[kind](a, OSC_HISTORY)
            host_step = float(np.float32(step))

            def affine():
                return br.banded_resample_affine(x, start, host_step, p, lo, hi, a=a, kind=kind, with_nearest=True)

            def affine_plain():
                return br.banded_resample_affine_plain(
                    x, start, host_step, p, lo, hi, a=a, kind=kind, with_nearest=True
                )

            formed, formed_want = affine(), affine_plain()
            same = torch.equal(pos, br.affine_positions(x, start, host_step, p, lo, hi))
            require(same, f"kernel C {name}: the case's positions are not affine_positions' tensor")
            read = br.banded_resample(x, pos, a=a, kind=kind, with_nearest=True)
            torch.cuda.synchronize()
            affine_plain_abs = float((formed[0] - formed_want[0]).abs().max())
            affine_plain_err = affine_plain_abs / scale
            require(affine_plain_err <= (0.0 if kind == "nearest" else 1e-5),
                    f"kernel C {name}: positions formed in the kernel, error {affine_plain_err} of max|x| "
                    "against the plain version")
            require(torch.equal(formed[1], formed_want[1]),
                    f"kernel C {name}: nearest pick at positions formed in the kernel against the plain version")
            affine_err = float((formed[0] - read[0]).abs().max()) / scale
            require(affine_err <= (0.0 if kind == "nearest" else 1e-6),
                    f"kernel C {name}: positions formed in the kernel differ by {affine_err} of max|x|")
            require(torch.equal(formed[1], read[1]), f"kernel C {name}: nearest pick at positions formed in the kernel")
        near_err = 0.0
        if dual:
            near_err = float((got[1] - want[1]).abs().max())
            got, want = got[0], want[0]
        require(got.shape == (PAIRS, rows, p), f"kernel C {name} shape {tuple(got.shape)}")
        require(bool(torch.isfinite(got).all()), f"kernel C {name}: not finite")
        abs_err = float((got - want).abs().max())
        rel = abs_err / scale
        bound = 0.0 if kind == "nearest" else 1e-5
        require(rel <= bound, f"kernel C {name}: error {rel} of max|x| > {bound}")
        require(near_err == 0.0, f"kernel C {name}: nearest pick differs by {near_err}")
        ms = median_ms(torch, kernel)
        plain_ms = median_ms(torch, plain)
        report["cases"][name] = {
            "kind": kind, "a": a, "with_nearest": dual, "shape": [PAIRS, rows, OSC_HISTORY], "P": p,
            "step": step, "where": where, "max_abs_err": abs_err, "err_of_max_x": rel,
            "nearest_max_abs_err": near_err, "affine_err_of_max_x": affine_err,
            "affine_err_of_max_x_against_plain": affine_plain_err, "ms": ms, "plain_ms": plain_ms,
        }
        if name == "cfg3":
            # The `kernels` line's row is the entry the main path launches:
            # positions formed in the kernel. It reads x and the starts once
            # and writes the wave and the nearest pick once. Operations the
            # function needs: per pixel three trigonometric values (~20 each)
            # and 2a weights of ~10 (a rotation, a reciprocal, three
            # multiplies), per row 2a multiply-adds. (Counting two sines and a
            # division for every weight, 50 operations, as this script did for
            # the first kernel C, gives 2.11 us: more than the function needs.)
            affine_ms = median_ms(torch, affine)
            affine_plain_ms = median_ms(torch, affine_plain)
            report["cases"][name].update(affine_ms=affine_ms, affine_plain_ms=affine_plain_ms)
            moved = nbytes(x, start) + 2 * PAIRS * rows * p * 4
            flops = PAIRS * p * (3 * 20.0 + 2 * a * 10.0 + rows * 2 * a * 2.0)
            results["banded_resample"] = dict(
                max_abs_err=max(abs_err, affine_plain_abs), ms=affine_ms, plain_ms=affine_plain_ms,
                **roofline(moved, flops), library_ms=None,
            )
    info(report)


@contextlib.contextmanager
def plain_resample():
    """Route the oscilloscope functions' resamples to kernel C's plain
    version on the same tensors: the plain path each call is held to."""
    from signalizer_tpu_torch.kernels import banded_resample as br
    from signalizer_tpu_torch.kernels import oscilloscope as tk

    kernels = tk.banded_resample, tk.banded_resample_affine
    tk.banded_resample, tk.banded_resample_affine = br.banded_resample_plain, br.banded_resample_affine_plain
    try:
        yield
    finally:
        tk.banded_resample, tk.banded_resample_affine = kernels


def make_osc_stream():
    """Seeded stereo stream [16, 2, L] at 96 kHz, L covering OSC_CALLS
    histories OSC_HOP apart: pair i carries a sine (150 Hz to 4 kHz, the
    right channel phase-shifted) plus independent noise 40 dB below it; the
    last pair is silent. Returns the stream and the sounding pairs'
    frequencies."""
    rng = np.random.default_rng(2027)
    length = OSC_HISTORY + OSC_HOP * (OSC_CALLS - 1)
    n = np.arange(length)
    freqs = np.geomspace(150.0, 4000.0, PAIRS - 1)
    amp = 0.5
    noise_std = amp / np.sqrt(2.0) * 10 ** (-40 / 20)
    stream = np.zeros((PAIRS, 2, length), np.float32)
    for i, f in enumerate(freqs):
        for ch, phase in ((0, 0.0), (1, 0.3)):
            stream[i, ch] = amp * np.sin(2 * np.pi * f * n / OSC_FS + phase) + rng.standard_normal(length) * noise_std
    return stream, freqs


def call_ms(torch, fn, reps: int = 10) -> float:
    """Median host-clock ms of ``fn()`` followed by a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_osc_slice(torch, dev, launches_out, calls_out):
    from signalizer_tpu_torch import OscilloscopeProcessor, TriggerMode
    from signalizer_tpu_torch.kernels import banded_resample as br
    from signalizer_tpu_torch.kernels import colour_track as ct
    from signalizer_tpu_torch.kernels import spectral_walk as sw

    stream, freqs = make_osc_stream()
    hist = torch.from_numpy(stream).to(dev)
    calls = [hist[..., i * OSC_HOP : i * OSC_HOP + OSC_HISTORY].contiguous() for i in range(OSC_CALLS)]
    scale = float(hist.abs().max())
    bin_hz = OSC_FS / 8192
    report = {"phase": "osc_slice", "pairs": PAIRS, "history": OSC_HISTORY, "pixels": OSC_PIXELS,
              "hop": OSC_HOP, "calls": OSC_CALLS, "configs": {}}
    total = 0
    cfg3_proc = None
    for name, over in (
        ("cfg3", {}),
        ("cfg3b", dict(trigger_mode=TriggerMode.SPECTRAL)),
        ("cfg3_colour", dict(colour_enabled=True)),
    ):
        kw = dict(pairs=PAIRS, device=dev, window_samples=OSC_WINDOW, **osc_kwargs(**over))
        proc = OscilloscopeProcessor.create(**kw)
        plain = OscilloscopeProcessor.create(**kw)
        colour = bool(over.get("colour_enabled", False))
        spectral = over.get("trigger_mode") == TriggerMode.SPECTRAL
        wave_err = 0.0
        frames = []
        walks = []  # kernel F's passes a call (the most of any row), from its device counter
        reset_counters("banded_resample.launches")
        colour_launches = 0  # kernel E on the main path (the plain-resample run also launches it)
        walk_launches = 0  # kernel F likewise (the plain run takes the plain walk)
        spectrum_launches = 0  # of which through its spectrum entry (the rfft in)
        for h in calls:
            plain.state = proc.state
            before = counter("colour_track.launches")
            walk_before, spectrum_before = counter("spectral_walk.launches"), counter("spectral_walk.spectrum_launches")
            frame = proc.process(h, new_samples=OSC_HOP)
            colour_launches += counter("colour_track.launches") - before
            walk_launches += counter("spectral_walk.launches") - walk_before
            spectrum_launches += counter("spectral_walk.spectrum_launches") - spectrum_before
            passes = sw.last_passes if spectral else None
            with plain_resample(), plain_walk():
                want = plain.process(h, new_samples=OSC_HOP)
            torch.cuda.synchronize()
            if spectral:
                walks.append(int(passes.max()))
                require(torch.equal(proc.state.median_history, plain.state.median_history),
                        f"{name} median history vs the plain walk")
            require(frame.waveform.shape == (PAIRS, 2, OSC_PIXELS), f"{name} waveform shape")
            require(frame.colours.shape == (PAIRS, 2, OSC_PIXELS, 3), f"{name} colours shape")
            for key in ("waveform", "envelope_min", "envelope_max", "colours", "gain"):
                require(bool(torch.isfinite(getattr(frame, key)).all()), f"{name} {key} finite")
            require(torch.equal(frame.trigger_found, want.trigger_found), f"{name} trigger_found")
            require(torch.equal(frame.fundamental, want.fundamental), f"{name} fundamental")
            err = float((frame.waveform - want.waveform).abs().max())
            bound = 1e-5 * scale * float(frame.gain.max())
            require(err <= bound, f"{name} waveform vs plain {err} > {bound}")
            wave_err = max(wave_err, err)
            for key in ("envelope_min", "envelope_max", "colours"):
                require(torch.equal(getattr(frame, key), getattr(want, key)), f"{name} {key} vs plain")
            require(bool((frame.waveform[-1] == 0).all()), f"{name} silent pair draws zero")
            frames.append(frame)
        launches = counter("banded_resample.launches")
        require(launches == OSC_CALLS * (1 + int(colour)),
                f"{name}: kernel C launched {launches} times in {OSC_CALLS} calls")
        require(colour_launches == OSC_CALLS * int(colour),
                f"{name}: kernel E launched {colour_launches} times in {OSC_CALLS} calls")
        require(walk_launches == spectrum_launches == OSC_CALLS * int(spectral),
                f"{name}: kernel F launched {walk_launches} times ({spectrum_launches} through its spectrum "
                f"entry) in {OSC_CALLS} calls")
        total += launches
        # the synchronizing operations of one more call, and their sites
        # (the second of two: the first counter in a process also meets
        # torch's one-time set-up)
        for _ in range(2):
            with SyncCounter(torch) as sc:
                proc.process(calls[-1], new_samples=OSC_HOP)
            torch.cuda.synchronize()

        last = frames[-1]
        found = last.trigger_found.cpu().numpy()
        checks = {}
        if over.get("trigger_mode") == TriggerMode.SPECTRAL:
            fund = last.fundamental.cpu().numpy()
            off = np.abs(fund[:-1] - freqs)
            require(bool((off <= bin_hz).all()), f"{name}: fundamentals {fund[:-1]} vs sines {freqs}")
            checks["max_fundamental_off_hz"] = float(off.max())
            checks["walk_passes_per_call"] = walks
        else:
            require(bool(found[:-1].all()) and not found[-1], f"{name}: trigger_found {found}")
            # a rising crossing of each pair's sine at the window's centre:
            # negative an eighth of a cycle before it, positive after
            wave = last.waveform[:, 0].cpu().numpy()
            step = (OSC_WINDOW - 1.0) / (OSC_PIXELS - 1)
            mid = (OSC_PIXELS - 1) / 2.0
            for i, f in enumerate(freqs):
                d = OSC_FS / f / 8.0 / step
                before, after = wave[i, int(np.floor(mid - d))], wave[i, int(np.ceil(mid + d))]
                require(before < 0.0 < after, f"{name} pair {i}: {before} .. {after} around the centre")
            checks["rising_crossing_centred"] = PAIRS - 1
        ms = call_ms(torch, lambda: proc.process(calls[0], new_samples=OSC_HOP))
        with plain_resample():
            plain_ms = call_ms(torch, lambda: plain.process(calls[0], new_samples=OSC_HOP))
        report["configs"][name] = {
            "launches": launches, "max_wave_err_vs_plain": wave_err, "checks": checks,
            "syncs_per_call": sc.count, "sync_sites": dict(sc.sites),
            "ms_per_call": ms, "plain_ms_per_call": plain_ms,
            "frames_per_s": PAIRS / (ms / 1e3), "plain_frames_per_s": PAIRS / (plain_ms / 1e3),
        }
        if name == "cfg3":
            cfg3_proc = proc
        if spectral:
            # no host sync in the walk: none in the oscilloscope's modules,
            # and no more than cfg3's call makes
            cfg3 = report["configs"]["cfg3"]
            walk_sites = [k for k in sc.sites if k.startswith(("oscilloscope.py", "spectral_walk.py"))]
            require(sc.count <= cfg3["syncs_per_call"] and not walk_sites,
                    f"{name}: syncs {dict(sc.sites)}, cfg3's {cfg3['sync_sites']}")
            report["configs"][name]["walk_launches"] = walk_launches
            launches_out["spectral_walk"] = launches_out.get("spectral_walk", 0) + walk_launches
            calls_out["spectral_walk"] = calls_out.get("spectral_walk", 0) + OSC_CALLS
            spectral_proc = proc
        if colour:
            # the colour track's cost in the call: kernel E once, then kernel
            # C's pick; it must fit a 60 fps frame
            report["configs"][name]["colour_track_launches"] = colour_launches
            require(ms <= FRAME_MS, f"{name} call takes {ms} ms, over a {FRAME_MS:.1f} ms frame")
            colour_proc = proc
            launches_out["colour_track"] = launches_out.get("colour_track", 0) + colour_launches
            calls_out["colour_track"] = calls_out.get("colour_track", 0) + OSC_CALLS
    launches_out["banded_resample"] = total
    calls_out["banded_resample"] = 3 * OSC_CALLS  # three configurations

    # cfg3 with the ENVELOPE_HOLD trigger: kernel D's main path
    report["envelope_hold"], hold_call = envelope_hold_calls(torch, dev, calls, launches_out, calls_out)
    info(report)
    return (cfg3_proc, calls[0], hold_call, lambda: colour_proc.process(calls[0], new_samples=OSC_HOP),
            lambda: spectral_proc.process(calls[0], new_samples=OSC_HOP))


# kernel A above one block's rows, timed at 16 pairs x T = 16 frames of the
# engine's default 48000-sample history (N = 65536: the cluster form)
LONG_WINDOW = 48_000
LONG_T = 16
# the two-pass form's main path: the Spectrum at a 200000-sample window
# (N = 262144; 131073 samples and up take the form), 16 pairs, a frame a call
TWO_PASS_WINDOW = 200_000
TWO_PASS_CALLS = 3


def kernel_a_entry(torch, c, frames, out, log2s=None, scratch=None):
    """One call of a C entry of kernel A on the wrapper's arguments: the
    cluster kernel with 2^log2s blocks a row, or (with ``scratch``) the
    two-pass form's kernels. A yardstick for the timings, not a route of
    the port: it counts no launch."""
    from signalizer_tpu_torch.kernels import _build

    batch = frames.numel() // (frames.shape[-1] * frames.shape[-2])
    head = (frames.data_ptr(), c.window_kernel.data_ptr(), c.fft_twiddles.data_ptr())
    tail = (batch, frames.shape[-2], c.window_size, c.transform_size.bit_length() - 1, int(c.configuration))
    if scratch is None:
        _build.launch("sig_window_fft_mag_cluster", frames.device, *head, out.data_ptr(), *tail, log2s,
                      name="kernel A entry")
    else:
        _build.launch("sig_window_fft_mag_long", frames.device, *head, scratch.data_ptr(), out.data_ptr(), *tail,
                      name="kernel A entry")


def phase_kernel_a_long(torch, dev, results, launches_out, calls_out):
    """Kernel A on rows above one block: the cluster form against its plain
    version at N = 65536 (every mode, W < N, odd W) and 131072, COMPLEX at
    32768 and 65536, the two-pass form at N = 262144 and 2^20 and COMPLEX
    131072, silent channels; the cluster form timed at 16 pairs x 16 frames
    x 2 x 48000 samples with 2, 4 and 8 blocks a cluster, the two-pass
    kernels on the same rows and ``torch.fft.rfft`` of the already windowed
    rows beside it; then the two-pass form's main path, the Spectrum at a
    200000-sample window. Returns the calls the profile phase times."""
    from signalizer_tpu_torch import SpectrumChannels as SC
    from signalizer_tpu_torch import SpectrumProcessor
    from signalizer_tpu_torch.core.constant import make_spectrum_constant
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm

    report = {"phase": "kernel_a_long", "bound": "row-relative error <= 5e-6; a silent row exactly 0", "cases": {}}
    counters = {"cluster": "window_fft_mag.cluster_launches", "two_pass": "window_fft_mag.long_launches"}

    def counts():
        return {route: counter(name) for route, name in counters.items()}

    cases = [  # name, constant keywords, frames shape, form
        ("n65536_w48000", headline(window_size=LONG_WINDOW), (PAIRS, 4, 2, LONG_WINDOW), "cluster"),
        ("n65536_w40001", headline(window_size=40_001), (4, 2, 2, 40_001), "cluster"),
        ("n131072", headline(window_size=131072), (4, 2, 2, 131072), "cluster"),
        ("complex_n32768", headline(window_size=32768, configuration=SC.COMPLEX), (4, 2, 2, 32768), "cluster"),
        ("complex_n32768_w20001", headline(window_size=20_001, configuration=SC.COMPLEX), (4, 2, 2, 20_001),
         "cluster"),
        ("complex_n65536", headline(window_size=65536, configuration=SC.COMPLEX), (4, 2, 2, 65536), "cluster"),
        ("n262144", headline(window_size=262144), (2, 2, 2, 262144), "two_pass"),
        ("n1048576", headline(window_size=1 << 20), (1, 2, 2, 1 << 20), "two_pass"),
        ("complex_n131072", headline(window_size=131072, configuration=SC.COMPLEX), (2, 2, 2, 131072), "two_pass"),
    ]
    cases += [(f"mode_{m.name.lower()}_n65536", headline(window_size=65536, configuration=m), (2, 2, 2, 65536),
               "cluster") for m in SC if m.name not in ("MID", "OFFSET_FOR_MONO")]
    for i, (name, kw, shape, route) in enumerate(cases):
        c = make_spectrum_constant(device=dev, **kw)
        require(wfm.form(c) == route, f"kernel A {name}: takes the {wfm.form(c)} form, not the {route} form")
        frames = _frames(torch, shape, seed=200 + i, dev=dev)
        before = counts()
        got = wfm.window_fft_mag(c, frames)
        want = wfm.window_fft_mag_plain(c, frames)
        torch.cuda.synchronize()
        require(counts() == {r: v + (r == route) for r, v in before.items()}, f"kernel A {name}: launches")
        rel = row_rel_err(got, want)
        require(got.shape == want.shape and got.dtype == want.dtype, f"kernel A {name} shape")
        require(rel <= 5e-6, f"kernel A {name}: row-relative error {rel} > 5e-6")
        report["cases"][name] = {"shape": list(shape), "n": c.transform_size, "form": route, "row_rel_err": rel}
    for name, kw, shape in (
        ("silent_separate_n65536", headline(window_size=65536), (4, 2, 65536)),
        ("silent_phase_n131072", headline(window_size=131072, configuration=SC.PHASE), (2, 2, 131072)),
        ("silent_separate_n262144", headline(window_size=262144), (2, 2, 262144)),
    ):
        c = make_spectrum_constant(device=dev, **kw)
        frames = _frames(torch, shape, seed=91, dev=dev) * 3.0
        frames[:, 1] = 0.0
        got = wfm.window_fft_mag(c, frames)
        want = wfm.window_fft_mag_plain(c, frames)
        torch.cuda.synchronize()
        require(bool((got[:, 1] == 0).all()), f"kernel A {name}: the silent channel is not exactly zero")
        rel = row_rel_err(got[:, 0], want[:, 0])
        require(rel <= 5e-6, f"kernel A {name}: loud row error {rel} > 5e-6")
        report["cases"][name] = {"shape": list(shape), "form": wfm.form(c), "row_rel_err": rel,
                                 "silent_row_max": 0.0}

    # timed: 16 pairs x 16 frames of the default history, the cluster form
    c = make_spectrum_constant(device=dev, **headline(window_size=LONG_WINDOW))
    require(wfm.form(c) == "cluster", "kernel A long t16: not the cluster form")
    frames = _frames(torch, (PAIRS, LONG_T, 2, LONG_WINDOW), seed=230, dev=dev)
    got = wfm.window_fft_mag(c, frames)
    want = wfm.window_fft_mag_plain(c, frames)
    torch.cuda.synchronize()
    rel = row_rel_err(got, want)
    abs_err = float((got - want).abs().max())
    require(rel <= 5e-6, f"kernel A cluster t16: row-relative error {rel} > 5e-6")
    ms = median_ms(torch, lambda: wfm.window_fft_mag(c, frames), reps=10)
    plain_ms = median_ms(torch, lambda: wfm.window_fft_mag_plain(c, frames), reps=10)
    rows = frames * c.window_kernel
    library_ms = median_ms(torch, lambda: torch.fft.rfft(rows, n=c.transform_size, dim=-1), reps=10)
    del rows
    # the cluster size, and the two-pass form's kernels on the same rows
    out = torch.empty_like(got)
    sizes = {}
    for log2s in (1, 2, 3):
        def call(log2s=log2s):
            kernel_a_entry(torch, c, frames, out, log2s=log2s)
        call()
        torch.cuda.synchronize()
        err = row_rel_err(out, want)
        require(err <= 5e-6, f"kernel A cluster t16 with {1 << log2s} blocks: row-relative error {err} > 5e-6")
        sizes[1 << log2s] = {"row_rel_err": err, "ms": median_ms(torch, call, reps=10), "call": call}
    scratch = torch.empty((PAIRS * LONG_T * 2, c.transform_size // 2, 2), dtype=torch.float32, device=dev)

    def two_pass():
        kernel_a_entry(torch, c, frames, out, scratch=scratch)

    two_pass()
    torch.cuda.synchronize()
    two_pass_err = row_rel_err(out, want)
    require(two_pass_err <= 5e-6, f"kernel A two-pass t16: row-relative error {two_pass_err} > 5e-6")
    two_pass_ms = median_ms(torch, two_pass, reps=10)
    del want
    bound = fft_bound(c, frames, got)
    by_size = {s: {k: v for k, v in d.items() if k != "call"} for s, d in sizes.items()}
    # the cluster form's longest rows, N = 131072 (128 rows), with 4 and 8
    # blocks a row (2 blocks would need 256 KB each)
    c131 = make_spectrum_constant(device=dev, **headline(window_size=131072))
    x131 = _frames(torch, (PAIRS, 4, 2, 131072), seed=232, dev=dev)
    out131 = torch.empty(wfm.out_shape(c131, (PAIRS, 4)), device=dev)
    want131 = wfm.window_fft_mag_plain(c131, x131)
    longest = {}
    for log2s in (2, 3):
        def call131(log2s=log2s):
            kernel_a_entry(torch, c131, x131, out131, log2s=log2s)
        call131()
        torch.cuda.synchronize()
        err = row_rel_err(out131, want131)
        require(err <= 5e-6, f"kernel A cluster n131072 with {1 << log2s} blocks: row-relative error {err} > 5e-6")
        longest[1 << log2s] = {"row_rel_err": err, "ms": median_ms(torch, call131, reps=10)}
    del x131, out131, want131
    report["timed"] = {"shape": list(frames.shape), "n": c.transform_size, "form": "cluster",
                       "cluster_size": wfm.cluster_size(c), "row_rel_err": rel, "max_abs_err": abs_err, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": library_ms, "by_cluster_size": by_size,
                       "two_pass_ms": two_pass_ms, "two_pass_row_rel_err": two_pass_err,
                       "n131072_rows128_by_cluster_size": longest,
                       "in_mb": nbytes(frames) / 1e6, "out_mb": nbytes(got) / 1e6, **bound}
    results["window_fft_mag_cluster"] = dict(
        max_abs_err=abs_err, row_rel_err=rel, ms=ms, plain_ms=plain_ms, **bound, library_ms=library_ms,
        library="torch.fft.rfft of already windowed rows: less than the kernel does",
        cluster_size=wfm.cluster_size(c), ms_by_cluster_size={s: d["ms"] for s, d in by_size.items()},
        two_pass_ms_same_rows=two_pass_ms,
    )

    # the two-pass form's main path: three Spectrum calls at a 200000-sample
    # window, counted from 0, then held against the plain functions from the
    # same carried state
    proc = SpectrumProcessor.create(pairs=PAIRS, device=dev, **headline(window_size=TWO_PASS_WINDOW))
    c2 = proc.constant
    require(wfm.form(c2) == "two_pass", f"kernel A: the {TWO_PASS_WINDOW}-sample Spectrum is not two-pass")
    x = _frames(torch, (PAIRS, 1, 2, TWO_PASS_WINDOW), seed=231, dev=dev)
    plain_state = proc.state.magnitude.clone()
    reset_counters("window_fft_mag.long_launches")
    for _ in range(TWO_PASS_CALLS):
        spectrum = proc.process(x)
    torch.cuda.synchronize()
    launches_out["window_fft_mag_long"] = counter("window_fft_mag.long_launches")
    calls_out["window_fft_mag_long"] = TWO_PASS_CALLS
    long_launches = counter("window_fft_mag.long_launches")
    require(long_launches == TWO_PASS_CALLS, f"kernel A: {long_launches} two-pass launches in "
            f"{TWO_PASS_CALLS} Spectrum calls")
    for _ in range(TWO_PASS_CALLS):
        plain_spectrum = dm.display_map_plain(c2, wfm.window_fft_mag_plain(c2, x), plain_state)
    torch.cuda.synchronize()
    spectrum_err = float((spectrum - plain_spectrum).abs().max())
    require(bool(torch.isfinite(spectrum).all()) and spectrum_err <= 2e-4,
            f"kernel A: the {TWO_PASS_WINDOW}-sample Spectrum vs plain: {spectrum_err} > 2e-4")
    # the two-pass form on its main path's rows
    got = wfm.window_fft_mag(c2, x)
    want = wfm.window_fft_mag_plain(c2, x)
    torch.cuda.synchronize()
    rel2 = row_rel_err(got, want)
    require(rel2 <= 5e-6, f"kernel A two-pass n262144: row-relative error {rel2} > 5e-6")
    ms2 = median_ms(torch, lambda: wfm.window_fft_mag(c2, x), reps=10)
    plain_ms2 = median_ms(torch, lambda: wfm.window_fft_mag_plain(c2, x), reps=10)
    rows = x * c2.window_kernel
    library_ms2 = median_ms(torch, lambda: torch.fft.rfft(rows, n=c2.transform_size, dim=-1), reps=10)
    del rows
    bound2 = fft_bound(c2, x, got)
    report["two_pass_spectrum"] = {"shape": list(x.shape), "n": c2.transform_size, "calls": TWO_PASS_CALLS,
                                   "launches": launches_out["window_fft_mag_long"], "display_err": spectrum_err,
                                   "row_rel_err": rel2, "ms": ms2, "plain_ms": plain_ms2,
                                   "library_ms": library_ms2, **bound2}
    results["window_fft_mag_long"] = dict(
        max_abs_err=float((got - want).abs().max()), row_rel_err=rel2, ms=ms2, plain_ms=plain_ms2, **bound2,
        library_ms=library_ms2, library="torch.fft.rfft of already windowed rows: less than the kernel does",
    )
    del want
    # the two-pass form's longest rows: one pair (2 rows) at N = 2^20 and 2^21
    longest_calls = []
    for log2n in (20, 21):
        cl = make_spectrum_constant(device=dev, **headline(window_size=1 << log2n))
        xl = _frames(torch, (1, 1, 2, 1 << log2n), seed=213 + log2n, dev=dev)
        got_l = wfm.window_fft_mag(cl, xl)
        want_l = wfm.window_fft_mag_plain(cl, xl)
        torch.cuda.synchronize()
        err_l = row_rel_err(got_l, want_l)
        require(err_l <= 5e-6, f"kernel A two-pass n{1 << log2n}: row-relative error {err_l} > 5e-6")
        rows = xl * cl.window_kernel
        results["window_fft_mag_long"][f"n{1 << log2n}"] = dict(
            shape=list(xl.shape), row_rel_err=err_l,
            ms=median_ms(torch, lambda cl=cl, xl=xl: wfm.window_fft_mag(cl, xl), reps=10),
            plain_ms=median_ms(torch, lambda cl=cl, xl=xl: wfm.window_fft_mag_plain(cl, xl), reps=10),
            library_ms=median_ms(torch, lambda cl=cl, rows=rows: torch.fft.rfft(rows, n=cl.transform_size, dim=-1),
                                 reps=10),
            **fft_bound(cl, xl, got_l),
        )
        del rows, want_l
        longest_calls.append((f"two_pass_n{1 << log2n}", lambda cl=cl, xl=xl: wfm.window_fft_mag(cl, xl)))
    report["two_pass_longest"] = {n: results["window_fft_mag_long"][n] for n in ("n1048576", "n2097152")}
    info(report)
    return [
        *longest_calls,
        ("window_fft_mag_cluster_t16", lambda: wfm.window_fft_mag(c, frames)),
        *((f"cluster_s{size}_t16", d["call"]) for size, d in sizes.items()),
        ("window_fft_mag_two_pass_t16", two_pass),
        ("spectrum_n262144", lambda: proc.process(x)),
    ]


# the live phase: a threaded 16-channel stream at 48 kHz with the default
# history, a second stereo instance mixed into the last pair, 800-sample
# blocks (one 60 fps display frame) for 240 ticks
LIVE_TICKS = 240
LIVE_CHANNELS = 16
LIVE_HISTORY = 48_000
LIVE_PAIRS = LIVE_CHANNELS // 2
LIVE_OSC_WINDOW = 16384
LIVE_VS_WINDOW = 4096
LIVE_PEER_HZ = 1000.0


def make_live_audio(n_blocks: int):
    """Seeded [16, n] main stream: pair i < 7 a sine on a distinct 65536-point
    bin (both channels, the right phase-shifted) plus noise 40 dB below;
    pair 7 noise alone, where the peer's 1 kHz sine is mixed in. And the
    peer's stereo stream [2, n]."""
    rng = np.random.default_rng(2031)
    length = n_blocks * HOP
    n = np.arange(length)
    bins = np.round(np.geomspace(150.0, 12_000.0, LIVE_PAIRS - 1) * 65536 / FS).astype(int)
    freqs = bins * FS / 65536
    main = (rng.standard_normal((LIVE_CHANNELS, length)) * 0.5 / np.sqrt(2.0) * 0.01).astype(np.float32)
    for i, f in enumerate(freqs):
        for ch, phase in ((0, 0.0), (1, 0.3)):
            main[2 * i + ch] += (0.5 * np.sin(2 * np.pi * f * n / FS + phase)).astype(np.float32)
    peer = np.stack([0.5 * np.sin(2 * np.pi * LIVE_PEER_HZ * n / FS + p) for p in (0.0, 0.2)]).astype(np.float32)
    return main, peer, freqs


class SyncCounter:
    """Counts the synchronizing CUDA operations inside a ``with`` block
    (``torch.cuda.set_sync_debug_mode``: each one warns)."""

    def __init__(self, torch):
        self.torch = torch
        self.count = 0

    def __enter__(self):
        import warnings

        self._catch = warnings.catch_warnings(record=True)
        self._log = self._catch.__enter__()
        warnings.simplefilter("always")
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import os

        self.torch.cuda.set_sync_debug_mode("default")
        hits = [w for w in self._log if "synchroniz" in str(w.message)]
        self.count = len(hits)
        # where each came from: the line of Python that asked for it
        self.sites = collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in hits)
        self._catch.__exit__(*exc)
        return False


def phase_live(torch, dev, launches_out, calls_out):
    """The live ingest path at full width: AudioStream (threaded, native SPSC
    packet queue and native ring) -> MixGraph with a peer instance ->
    DevicePresentationHistory on the card -> two Spectrum processors
    (N = 4096 and 65536), the Oscilloscope and the Vectorscope, each reading
    its window off the device ring, for 240 ticks; every window held
    against the host ring's ``get_history`` bit for bit; then a stall
    longer than the ring and the re-prime."""
    from signalizer_tpu_torch import OscilloscopeProcessor, SpectrumProcessor, VectorscopeProcessor
    from signalizer_tpu_torch.core.config import DEFAULT_HISTORY_SIZE, MAX_INPUT_CHANNELS
    from signalizer_tpu_torch.kernels import banded_resample as br
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm
    from signalizer_tpu_torch.native_bindings import (
        NativePacketQueue, NativeRingBuffer, native_available, native_build_error)
    from signalizer_tpu_torch.stream.audio_stream import AudioStream, AudioStreamInfo, Playhead
    from signalizer_tpu_torch.stream.device_history import DevicePresentationHistory
    from signalizer_tpu_torch.stream.host_graph import HostGraph, PortPair
    from signalizer_tpu_torch.stream.mix_graph import MixGraph

    require(MAX_INPUT_CHANNELS == LIVE_CHANNELS and DEFAULT_HISTORY_SIZE == LIVE_HISTORY, "live geometry")
    require(native_available(), f"live: the native host runtime did not build: {native_build_error()}")
    stall_blocks = LIVE_HISTORY // HOP + 2
    n_blocks = LIVE_TICKS + stall_blocks + 80  # the profile's ticks wrap around
    main_audio, peer_audio, freqs = make_live_audio(n_blocks)

    info_main = AudioStreamInfo(channels=LIVE_CHANNELS, sample_rate=FS, audio_history_size=LIVE_HISTORY,
                                audio_history_capacity=LIVE_HISTORY)
    main_in, main_out = AudioStream.create(True, info_main)
    peer_in, peer_out = AudioStream.create(False, AudioStreamInfo(channels=2, sample_rate=FS,
                                                                  audio_history_capacity=LIVE_HISTORY))
    main_graph, peer_graph = HostGraph("main", channels=LIVE_CHANNELS), HostGraph("peer", channels=2)
    main_graph.stream_output, peer_graph.stream_output = main_out, peer_out
    mix = MixGraph(main_graph, main_out, capacity=2 * LIVE_HISTORY)
    for ch in range(2):
        require(main_graph.connect(peer_graph.node_id, PortPair(ch, LIVE_CHANNELS - 2 + ch)), "connect the peer")
    present = mix.presentation_output
    history = DevicePresentationHistory(present, device=dev)
    ring_kind = type(main_out._stream._history).__name__
    queue_kind = type(main_out._stream._native_queue).__name__
    require(isinstance(main_out._stream._history, NativeRingBuffer), f"live: the main stream's ring is {ring_kind}")
    require(isinstance(main_out._stream._native_queue, NativePacketQueue), f"live: the packet queue is {queue_kind}")
    require(isinstance(present._stream._history, NativeRingBuffer), "live: the presentation ring is not native")

    spec = SpectrumProcessor.create(pairs=LIVE_PAIRS, device=dev, **headline())
    spec_long = SpectrumProcessor.create(pairs=LIVE_PAIRS, device=dev, **headline(window_size=LIVE_HISTORY))
    osc = OscilloscopeProcessor.create(pairs=LIVE_PAIRS, device=dev, window_samples=OSC_WINDOW,
                                       **osc_kwargs(sample_rate=FS))
    scope = VectorscopeProcessor(pairs=LIVE_PAIRS, device=dev)
    require(wfm.form(spec_long.constant) == "cluster", "live: the 48000-sample Spectrum is not on the cluster form")
    block = {"i": 0}

    def feed():
        i = block["i"]
        block["i"] += 1
        ph = Playhead(steady_clock=i * HOP, position_samples=i * HOP, is_playing=True)
        j = i % n_blocks
        peer_in.process_incoming_audio(peer_audio[:, j * HOP : (j + 1) * HOP], ph)
        main_in.process_incoming_audio(main_audio[:, j * HOP : (j + 1) * HOP], ph)
        require(main_in._stream.wait_for_drain(timeout=5.0), "live: the stream did not drain")

    def views():
        frames = lambda n: history.window(n).reshape(LIVE_PAIRS, 2, n)  # noqa: E731
        return (spec.process(frames(WINDOW)), spec_long.process(frames(LIVE_HISTORY)),
                osc.process(frames(LIVE_OSC_WINDOW), new_samples=HOP), scope.process(frames(LIVE_VS_WINDOW)))

    def held(tick):
        for n in (WINDOW, LIVE_OSC_WINDOW, LIVE_HISTORY):
            require(np.array_equal(history.window(n).cpu().numpy(), present.get_history(n)),
                    f"live tick {tick}: the device window of {n} differs from get_history")

    for _ in range(4):  # warm-up: the kernels' first launches, the prime
        feed()
        history.sync()
        views()
    torch.cuda.synchronize()
    held(-1)
    counters = ("window_fft_mag.launches", "window_fft_mag.cluster_launches", "display_map.launches",
                "banded_resample.launches")
    reset_counters(*counters)
    reprimes0 = history.reprimes
    tick_ms, sync_us, uploaded, arrived = [], [], [], []
    for tick in range(LIVE_TICKS):
        before = present.sample_clock
        feed()
        arrived.append(present.sample_clock - before)
        t0 = time.perf_counter()
        history.sync()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = views()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tick_ms.append((t2 - t0) * 1e3)
        sync_us.append((t1 - t0) * 1e6)
        uploaded.append(history.uploaded_bytes)
        held(tick)
        require(all(bool(torch.isfinite(x).all()) for x in (out[0], out[1], out[2].waveform, out[3].vertices)),
                f"live tick {tick}: a view's output is not finite")
    live_launches = {"window_fft_mag": counter("window_fft_mag.launches"),
                     "window_fft_mag_cluster": counter("window_fft_mag.cluster_launches"),
                     "display_map": counter("display_map.launches"), "banded_resample": counter("banded_resample.launches")}
    for name, count in live_launches.items():
        require(count > 0, f"live: {name} was not launched")
    require(counter("window_fft_mag.cluster_launches") == LIVE_TICKS,
            f"live: the cluster form ran {counter('window_fft_mag.cluster_launches')} times in {LIVE_TICKS} ticks")
    require(history.reprimes == reprimes0, f"live: {history.reprimes - reprimes0} re-primes while fed every tick")
    require(all(u == LIVE_CHANNELS * 4 * a for u, a in zip(uploaded, arrived)),
            "live: a sync uploaded other than the samples that arrived")
    launches_out["window_fft_mag_cluster"] = live_launches["window_fft_mag_cluster"]
    calls_out["window_fft_mag_cluster"] = LIVE_TICKS

    # what came out: each sounding pair's LineMain peak on the long Spectrum
    # within one pixel of its sine; the last pair peaks at the peer's tone
    mapped = spec_long.constant.mapped_frequencies.cpu().numpy()
    last = out[1][:, -1, 0].cpu().numpy()  # [pairs, rows, P]
    for i, f in enumerate(list(freqs) + [LIVE_PEER_HZ]):
        expect = int(np.argmin(np.abs(mapped - f)))
        for r in range(2):
            got = int(np.argmax(last[i, r]))
            require(abs(got - expect) <= 1, f"live pair {i} row {r}: long-window peak {got}, sine at {expect}")
    # and the two Spectrum processors against their plain versions on the
    # same device windows and the same carried state
    for proc, n in ((spec, WINDOW), (spec_long, LIVE_HISTORY)):
        c = proc.constant
        x = history.window(n).reshape(LIVE_PAIRS, 1, 2, n).contiguous()
        plain_state = proc.state.magnitude.clone()
        got = proc.process(x)
        want = dm.display_map_plain(c, wfm.window_fft_mag_plain(c, x), plain_state)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(err <= 2e-4, f"live Spectrum N={c.transform_size} vs plain: {err} > 2e-4")

    # where a tick's time goes: 40 more ticks, each part ended by a
    # synchronize (host ms, so the parts add up to more than a tick)
    parts = {"sync": [], "spectrum_4096": [], "spectrum_48000": [], "oscilloscope": [], "vectorscope": []}
    frames = lambda n: history.window(n).reshape(LIVE_PAIRS, 2, n)  # noqa: E731
    steps = (
        ("sync", history.sync),
        ("spectrum_4096", lambda: spec.process(frames(WINDOW))),
        ("spectrum_48000", lambda: spec_long.process(frames(LIVE_HISTORY))),
        ("oscilloscope", lambda: osc.process(frames(LIVE_OSC_WINDOW), new_samples=HOP)),
        ("vectorscope", lambda: scope.process(frames(LIVE_VS_WINDOW))),
    )
    for _ in range(40):
        feed()
        for name, step in steps:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            parts[name].append((time.perf_counter() - t0) * 1e3)

    # syncs a tick, counted on ten more ticks
    syncs = []
    for _ in range(10):
        feed()
        with SyncCounter(torch) as sync_counter:
            history.sync()
            views()
        torch.cuda.synchronize()
        syncs.append(sync_counter.count)

    # a stall longer than the ring: the mirror re-primes and stays equal
    reprimes0 = history.reprimes
    for _ in range(stall_blocks):
        feed()
    history.sync()
    torch.cuda.synchronize()
    held("after the stall")
    require(history.reprimes == reprimes0 + 1, f"live: {history.reprimes - reprimes0} re-primes after the stall")

    window_copy_ms = median_ms(torch, lambda: history.window(LIVE_HISTORY).contiguous(), reps=10)
    steady = tick_ms[10:]
    report = {
        "phase": "live", "channels": LIVE_CHANNELS, "history": LIVE_HISTORY, "block": HOP, "ticks": LIVE_TICKS,
        "ring": ring_kind, "packet_queue": queue_kind, "presentation_ring": type(present._stream._history).__name__,
        "mix": {"sources": len(mix._sources), "latency_samples": mix.perf.latency_samples,
                "discontinuities": mix.perf.discontinuities, "synchronized": mix.perf.synchronized},
        "uploaded_bytes_per_tick": {"median": float(np.median(uploaded)), "min": int(min(uploaded)),
                                    "max": int(max(uploaded))},
        "sync_us": {"p50": float(np.percentile(sync_us, 50)), "p99": float(np.percentile(sync_us, 99))},
        "tick_ms": {"p50": float(np.percentile(steady, 50)), "p99": float(np.percentile(steady, 99))},
        "launches_per_tick": {k: v / LIVE_TICKS for k, v in live_launches.items()},
        "syncs_per_tick": {"median": float(np.median(syncs)), "max": int(max(syncs))},
        "part_ms_p50": {name: float(np.percentile(v, 50)) for name, v in parts.items()},
        "reprimes": {"while_fed": 0, "after_stall": 1, "total": history.reprimes},
        "window_48000_contiguous_ms": window_copy_ms,
        "windows_equal_get_history": True,
    }
    require(report["uploaded_bytes_per_tick"]["median"] == LIVE_CHANNELS * HOP * 4,
            f"live: median upload {report['uploaded_bytes_per_tick']['median']} bytes, not 16 x 800 x 4")
    info(report)

    def tick():
        feed()
        history.sync()
        return views()

    def close():
        history.close()
        mix.close()
        main_in._stream.close()
        peer_in._stream.close()

    return tick, close


# the session phase: SignalizerEngine and AnalysisSession at the factory
# default preset with every view, fed 800-sample blocks of a stereo pair of
# sines in a little noise
SESSION_TICKS = 240
SESSION_SIDE_TICKS = 24  # the CPU comparison and each side session
# the `cycles` session's waveform against the CPU's, abs over gain: the
# card's SPECTRAL trigger may place the window an f32 ulp or two from the
# CPU's (see phase_session); about 3x the largest reading on the card
CYCLES_WAVE_TOL = 1e-3
SESSION_SYNC_TICKS = 10  # the main run's last ticks: syncs counted, not timed
PEAK_SYNC_TICKS = 4  # the `peak trigger` session's ticks with syncs counted
PEAK_TURN_TICKS = 40  # ticks of it and of the main session, timed in turns
SESSION_HZ = (1000.0, 1500.0)
SESSION_FULL = WINDOW // HOP + 1  # ticks until the spectrum's window holds only audio
SESSION_BIN_HZ = FS / WINDOW


def make_session_audio(n_blocks: int):
    rng = np.random.default_rng(2024)
    t = np.arange(n_blocks * HOP) / FS
    x = np.stack([0.5 * np.sin(2 * np.pi * SESSION_HZ[0] * t),
                  0.4 * np.sin(2 * np.pi * SESSION_HZ[1] * t + 0.3)])
    x = x + 0.02 * rng.standard_normal(x.shape)
    return [np.ascontiguousarray(x[:, i * HOP : (i + 1) * HOP], dtype=np.float32) for i in range(n_blocks)]


def session_open(device, *, fused=True, knobs=None):
    """A session on a fresh engine at the factory default preset with the
    frequency tracker on its Transform source, the cursor on the left sine."""
    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.session import AnalysisSession

    eng = SignalizerEngine("smoke", device=device)
    eng.spectrum.frequency_tracker.set_normalized(1 / 3)  # transform
    if knobs is not None:
        knobs(eng)
    return AnalysisSession(eng, axis_points=AXIS_POINTS, pixels=AXIS_POINTS, fused_tick=fused,
                           cursor_fraction=SESSION_HZ[0] / (FS / 2))


def session_feed(session, blocks, i: int) -> None:
    from signalizer_tpu_torch.stream.audio_stream import Playhead

    clock = (i + 1) * HOP
    session.feed(blocks[i % len(blocks)], Playhead(steady_clock=clock, position_samples=clock, is_playing=True))


def session_host(frame) -> dict:
    """Host copies of a session frame's outputs."""
    out = {"spectrum": frame.spectrum, "columns": frame.spectrogram_columns,
           "tracker": None if frame.tracker is None else frame.tracker["frequency"]}
    for view, names in (("oscilloscope", ("waveform", "envelope_min", "envelope_max", "colours", "gain",
                                          "trigger_found")),
                        ("vectorscope", ("vertices", "balance", "correlation_bars", "gain"))):
        f = getattr(frame, view)
        for name in names:
            out[f"{view}.{name}"] = None if f is None else getattr(f, name).cpu().numpy()
    return out


def session_equal(a: dict, b: dict, what: str) -> None:
    require(a.keys() == b.keys(), f"{what}: other fields")
    for k in a:
        x, y = a[k], b[k]
        require((x is None) == (y is None), f"{what}: {k} present in one frame only")
        if x is not None:
            require(np.array_equal(np.asarray(x), np.asarray(y)), f"{what}: {k} differs")


def session_errors(card: dict, cpu: dict) -> dict:
    """The card frame's distance from the CPU frame, each in the unit of
    its tolerance (pass: <= 1): spectrum display atol 2e-4 (kernels A and B
    against their plain versions, tests/test_torch_cuda.py), oscilloscope
    1e-5 x max|x| x gain (kernel C's), its colours 1e-3 (kernel E's against
    its plain version), vectorscope 2e-6 x gain and bars
    2e-6, spectrogram bytes within 1 LSB on at most 0.1%, tracker
    frequency rtol 1e-5."""
    err = {"spectrum": float(np.abs(card["spectrum"] - cpu["spectrum"]).max()) / 2e-4}
    gain = max(1.0, float(np.abs(cpu["oscilloscope.gain"]).max()))
    err["oscilloscope"] = float(np.abs(card["oscilloscope.waveform"] - cpu["oscilloscope.waveform"]).max()) / (
        1e-5 * 0.6 * gain)
    for name in ("envelope_min", "envelope_max"):
        d = float(np.abs(card[f"oscilloscope.{name}"] - cpu[f"oscilloscope.{name}"]).max()) / (1e-5 * 0.6 * gain)
        err["oscilloscope"] = max(err["oscilloscope"], d)
    err["colours"] = float(np.abs(card["oscilloscope.colours"] - cpu["oscilloscope.colours"]).max()) / 1e-3
    vgain = max(1.0, float(np.abs(cpu["vectorscope.gain"]).max()))
    err["vectorscope"] = max(
        float(np.abs(card["vectorscope.vertices"] - cpu["vectorscope.vertices"]).max()) / (2e-6 * vgain),
        float(np.abs(card["vectorscope.balance"] - cpu["vectorscope.balance"]).max()) / 2e-6,
        float(np.abs(card["vectorscope.correlation_bars"] - cpu["vectorscope.correlation_bars"]).max()) / 2e-6,
    )
    a, b = card["columns"], cpu["columns"]
    require(a.shape == b.shape, f"session vs CPU: columns {a.shape} and {b.shape}")
    if a.size:
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        err["spectrogram"] = max(float(diff.max()), float((diff != 0).mean()) / 1e-3)
    else:
        err["spectrogram"] = 0.0
    err["tracker"] = abs(card["tracker"] - cpu["tracker"]) / (1e-5 * abs(cpu["tracker"]))
    err["trigger_equal"] = bool(np.array_equal(card["oscilloscope.trigger_found"], cpu["oscilloscope.trigger_found"]))
    return err


def phase_session(torch, dev, launches_out, calls_out):
    """The engine and the session tick at full width: ``SignalizerEngine`` on
    the card at the factory default preset (2 channels, 48 kHz, a
    48000-sample history), ``AnalysisSession`` with all four views at 1024
    px, the fused tick, the Transform tracker; 240 ticks, each checked;
    then the same blocks through the per-view tick (bit-equal), the first
    24 through a CPU session (the plain kernel versions), and three side
    sessions of 24 ticks (RSNT; a ZERO_CROSSING trigger with RMS
    vectorscope autogain and a window-size change; a serialized engine
    restored into a fresh one)."""
    from signalizer_tpu_torch.core.config import SpectrumChannels
    from signalizer_tpu_torch.core.constant import host_view
    from signalizer_tpu_torch.kernels import banded_resample as br
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm
    from signalizer_tpu_torch.state.serialize import Archive
    from signalizer_tpu_torch.views.oscilloscope import SubSampleInterpolation
    from signalizer_tpu_torch.views.spectrum import SpectrumProcessor
    from signalizer_tpu_torch.views.vectorscope import OperationalMode

    blocks = make_session_audio(SESSION_TICKS + 80)  # the profile's ticks wrap around
    s = session_open(dev)
    eng = s.engine
    spec, osc, scope = (s.processor(v) for v in ("spectrum", "oscilloscope", "vectorscope"))
    cap = eng.presentation_output.info.audio_history_capacity
    osc_window = float(osc.effective_window_samples())
    osc_history = min(max(16384, 1 << int(np.ceil(np.log2(max(2.0 * osc_window, 1.0))))), cap)
    geometry = {
        "parameters": eng.num_parameters(), "channels": eng.config.num_channels,
        "sample_rate": eng.config.sample_rate, "history": cap,
        "spectrum": [type(spec).__name__, spec.constant.window_size, spec.constant.configuration.name,
                     spec.constant.axis_points, spec.constant.view_scaling.name],
        "oscilloscope": [osc.constant.interpolation.name, osc.constant.trigger_mode.name, osc_window, osc_history,
                         osc.pixels],
        "vectorscope": [scope.mode.name, scope.autogain.name, s._vs_window()],
        "spectrogram": [s.processor("spectrogram").constant.window_size,
                        s.processor("spectrogram").constant.axis_points],
    }
    require(geometry["parameters"] == 201 and geometry["channels"] == 2 and cap == 48_000
            and eng.config.sample_rate == FS, f"session: engine geometry {geometry}")
    require(isinstance(spec, SpectrumProcessor) and spec.constant.window_size == WINDOW
            and spec.constant.configuration == SpectrumChannels.LEFT and spec.constant.axis_points == AXIS_POINTS,
            f"session: the default preset's spectrum is {geometry['spectrum']}")
    require(osc.constant.interpolation == SubSampleInterpolation.LANCZOS and osc_history <= cap,
            f"session: the default preset's oscilloscope is {geometry['oscilloscope']}")
    require(scope.mode == OperationalMode.LISSAJOUS and s._vs_window() == WINDOW,
            f"session: the default preset's vectorscope is {geometry['vectorscope']}")
    mapped = host_view(spec.constant, "mapped_frequencies")
    sine_px = int(np.argmin(np.abs(mapped - SESSION_HZ[0])))

    counters = {"window_fft_mag": "window_fft_mag.launches",
                "window_fft_mag_cluster": "window_fft_mag.cluster_launches",
                "window_fft_mag_long": "window_fft_mag.long_launches", "display_map": "display_map.launches",
                "display_remap": "display_map.remap_launches", "display_decay_db": "display_map.decay_db_launches",
                "banded_resample": "banded_resample.launches"}

    def counts():
        return {k: counter(name) for k, name in counters.items()}

    # the fused session and a per-view session on the same blocks, a tick of
    # each in turn (the first of the two alternates); the fused session's
    # launches are counted from just before each of its ticks to just after
    pv = session_open(dev, fused=False)
    reset_counters(*counters.values())
    ticked = dict.fromkeys(counters, 0)
    main, columns, tracked = [], 0, []
    ms = {True: [], False: []}
    syncs = {True: [], False: []}
    sites = {True: collections.Counter(), False: collections.Counter()}
    for i in range(SESSION_TICKS):
        session_feed(s, blocks, i)
        session_feed(pv, blocks, i)
        frames = {}
        for fused in ((True, False) if i % 2 == 0 else (False, True)):
            sess = s if fused else pv
            before = counts()
            if i >= SESSION_TICKS - SESSION_SYNC_TICKS:
                with SyncCounter(torch) as sc:
                    frames[fused] = sess.tick()
                torch.cuda.synchronize()
                syncs[fused].append(sc.count)
                sites[fused].update(sc.sites)
            else:
                t0 = time.perf_counter()
                frames[fused] = sess.tick()
                torch.cuda.synchronize()
                ms[fused].append((time.perf_counter() - t0) * 1e3)
            if fused:
                after = counts()
                for k in ticked:
                    ticked[k] += after[k] - before[k]
        h = session_host(frames[True])
        session_equal(session_host(frames[False]), h, f"session tick {i}: per-view vs fused")
        if i < SESSION_SIDE_TICKS:
            main.append(h)
        require(h["spectrum"] is not None and h["spectrum"].shape == (2, 1, AXIS_POINTS)
                and bool(np.isfinite(h["spectrum"]).all()), f"session tick {i}: spectrum {h['spectrum']}")
        require(bool(np.isfinite(h["oscilloscope.waveform"]).all()), f"session tick {i}: oscilloscope not finite")
        require(bool(np.isfinite(h["vectorscope.vertices"]).all()), f"session tick {i}: vectorscope not finite")
        require(h["columns"] is not None and h["columns"].dtype == np.uint8, f"session tick {i}: no column array")
        columns += h["columns"].shape[0]
        if i >= SESSION_FULL:
            px = int(np.argmax(h["spectrum"][0, 0]))
            require(abs(px - sine_px) <= 1, f"session tick {i}: peak pixel {px}, the sine at {sine_px}")
            require(abs(h["tracker"] - SESSION_HZ[0]) <= SESSION_BIN_HZ,
                    f"session tick {i}: tracker {h['tracker']} Hz, the sine at {SESSION_HZ[0]}")
            tracked.append(h["tracker"])
    launches = {k: ticked[k] for k in ("window_fft_mag", "display_map", "banded_resample")}
    others = {k: v for k, v in ticked.items() if k not in launches}
    for name, count in launches.items():
        require(count > 0, f"session: {name} was not launched on the session path")
    diag = {k: v for k, v in eng.diagnostics.counters.items() if k.startswith("session.")}
    require(diag["session.ticks"] == diag["session.fused_ticks"] == SESSION_TICKS,
            f"session: {diag['session.fused_ticks']} fused ticks of {diag['session.ticks']}")
    require(diag["session.fallbacks"] == 0 and diag["session.failures"] == 0, f"session: contained faults {diag}")
    require(columns > 0, "session: no spectrogram column arrived")
    launches_out.update(launches)
    calls_out.update({name: SESSION_TICKS for name in launches})
    pv_diag = pv.engine.diagnostics.counters
    require(pv_diag["session.fused_ticks"] == 0 and pv_diag["session.failures"] == 0, f"per-view faults {pv_diag}")
    pv.close()

    # the first ticks against a CPU session (the kernels' plain versions)
    cpu = session_open("cpu")
    worst = {}
    for i in range(SESSION_SIDE_TICKS):
        session_feed(cpu, blocks, i)
        err = session_errors(main[i], session_host(cpu.tick()))
        for k, v in err.items():
            worst[k] = (worst.get(k, True) and v) if k == "trigger_equal" else max(worst.get(k, 0.0), v)
    cpu.close()

    # RSNT: the resonator bank on the continuous stream, kernel H and the
    # display kernel's decay-and-dB entry; against a CPU RSNT session

    def rsnt(eng):
        eng.spectrum.algorithm.set_normalized(1.0)

    rs, rs_cpu = session_open(dev, knobs=rsnt), session_open("cpu", knobs=rsnt)
    bank_proc, rsnt_calls = rs.processor("spectrum"), []
    process_chunks = bank_proc.process_chunks

    def counted(blocks, valid=None):
        rsnt_calls.append(tuple(blocks.shape))
        return process_chunks(blocks, valid)

    bank_proc.process_chunks = counted
    reset_counters("display_map.decay_db_launches", "resonator_scan.launches")
    rsnt_err = {"display_db_map": 0.0, "display": 0.0, "bank": 0.0}
    lower, dyr = (float(v) for v in rs.processor("spectrum").constant.display_scalars[1:3])
    clip = float(rs.processor("spectrum").constant.clip_db)

    def linear(v):
        return np.where(v == clip, 0.0, np.exp(np.asarray(v, np.float64) / dyr) * lower)

    for i in range(SESSION_SIDE_TICKS):
        for sess in (rs, rs_cpu):
            session_feed(sess, blocks, i)
        got, want = rs.tick(), rs_cpu.tick()
        require(got.spectrum is not None and bool(np.isfinite(got.spectrum).all()), f"RSNT tick {i}: spectrum")
        db_err = float(np.abs(got.spectrum - want.spectrum).max())
        rsnt_err["display_db_map"] = max(rsnt_err["display_db_map"], db_err)
        lin = linear(want.spectrum)
        rsnt_err["display"] = max(rsnt_err["display"], float(np.abs(linear(got.spectrum) - lin).max() / lin.max()))
        bank, bank_cpu = rs.processor("spectrum").res_state.cpu(), rs_cpu.processor("spectrum").res_state
        rsnt_err["bank"] = max(rsnt_err["bank"], float((bank - bank_cpu).abs().max() / bank_cpu.abs().max()))
        if i >= SESSION_FULL:
            px = int(np.argmax(got.spectrum[0, 0]))
            require(abs(px - sine_px) <= 1, f"RSNT tick {i}: peak pixel {px}, the sine at {sine_px}")
    rsnt_launches, rsnt_scans = counter("display_map.decay_db_launches"), counter("resonator_scan.launches")
    rsnt_bank_calls = len(rsnt_calls)
    # one launch of each a call of the bank, made on each tick with a whole
    # 1024-sample chunk pending
    require(rsnt_launches == rsnt_bank_calls, f"RSNT: decay-and-dB launched {rsnt_launches} times "
            f"in {rsnt_bank_calls} calls")
    require(rsnt_scans == rsnt_bank_calls, f"RSNT: kernel H launched {rsnt_scans} times in {rsnt_bank_calls} calls")
    require(rs.engine.diagnostics.counters["session.failures"] == 0, "RSNT: a view failed")
    launches_out["display_decay_db"] = rsnt_launches
    calls_out["display_decay_db"] = SESSION_SIDE_TICKS
    rs_cpu.close()
    # the RSNT tick timed over 20 more ticks, then its syncs counted
    rsnt_block = {"i": SESSION_SIDE_TICKS}

    def rsnt_tick():
        session_feed(rs, blocks, rsnt_block["i"])
        rsnt_block["i"] += 1
        return rs.tick()

    rsnt_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        rsnt_tick()
        torch.cuda.synchronize()
        rsnt_ms.append((time.perf_counter() - t0) * 1e3)
    with SyncCounter(torch) as rsnt_sc:
        rsnt_tick()
    torch.cuda.synchronize()

    # ZERO_CROSSING trigger, RMS vectorscope autogain, the vectorscope's
    # window knob moved half way (reconfigure): fused and per-view in step
    def trigger(eng):
        eng.oscilloscope.trigger_mode.set_normalized(1.0)  # zero crossing
        eng.oscilloscope.trigger_threshold.set_normalized(0.01)
        eng.vectorscope.auto_gain.set_normalized(0.5)  # rms

    pair = [session_open(dev, knobs=trigger), session_open(dev, knobs=trigger, fused=False)]
    windows = []
    for i in range(SESSION_SIDE_TICKS):
        if i == SESSION_SIDE_TICKS // 2:
            for sess in pair:
                sess.engine.vectorscope.window_size.set_normalized(0.2)
                sess.reconfigure()
        for sess in pair:
            session_feed(sess, blocks, i)
        a, b = (session_host(sess.tick()) for sess in pair)
        session_equal(a, b, f"trigger session tick {i}: fused vs per-view")
        require(i < SESSION_FULL or bool(a["oscilloscope.trigger_found"].all()),
                f"trigger session tick {i}: no zero crossing found")
        windows.append(a["vectorscope.vertices"].shape[-2])
    require(windows[0] == WINDOW and windows[-1] != WINDOW, f"trigger session: vectorscope windows {windows}")
    for sess in pair:
        c = sess.engine.diagnostics.counters
        require(c["session.failures"] == 0 and c["session.fallbacks"] == 0, f"trigger session faults {c}")
    require(pair[0].engine.diagnostics.counters["session.fused_ticks"] == SESSION_SIDE_TICKS, "trigger: fused ticks")
    for sess in pair:
        sess.close()

    # an engine serialized, closed and restored into a fresh engine: the
    # same frames on the same blocks
    def saved(eng):
        trigger(eng)
        eng.spectrum.channel_configuration.set_normalized(5 / 7)  # separate

    src = session_open(dev, knobs=saved)
    archive = Archive()
    src.engine.serialize(archive)
    data = archive.to_bytes()
    before = []
    for i in range(SESSION_SIDE_TICKS):
        session_feed(src, blocks, i)
        before.append(session_host(src.tick()))
    values = [src.engine.get_parameter(k) for k in range(src.engine.num_parameters())]
    src.close()
    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.session import AnalysisSession

    restored_eng = SignalizerEngine("restored", device=dev)
    restored_eng.deserialize(Archive.from_bytes(data))
    require([restored_eng.get_parameter(k) for k in range(len(values))] == values, "restore: parameters differ")
    restored = AnalysisSession(restored_eng, axis_points=AXIS_POINTS, pixels=AXIS_POINTS,
                               cursor_fraction=SESSION_HZ[0] / (FS / 2))
    for i in range(SESSION_SIDE_TICKS):
        session_feed(restored, blocks, i)
        session_equal(session_host(restored.tick()), before[i], f"restored session tick {i}")
    restored.close()

    # the factory preset `peak trigger.oscilloscope` (the ENVELOPE_HOLD
    # trigger: kernel D once a tick), against the same session on the CPU
    from signalizer_tpu_torch.kernels import peak_hold as ph
    from signalizer_tpu_torch.views.oscilloscope import TriggerMode

    def peak_trigger(eng):
        require(eng.load_preset("peak trigger.oscilloscope"), "no factory preset peak trigger.oscilloscope")
        eng.spectrum.frequency_tracker.set_normalized(1 / 3)  # transform, as session_open sets it

    pk, pk_cpu = session_open(dev, knobs=peak_trigger), session_open("cpu", knobs=peak_trigger)
    require(pk.processor("oscilloscope").trigger_mode == TriggerMode.ENVELOPE_HOLD,
            "peak trigger: the preset's trigger is not ENVELOPE_HOLD")
    # the card session's ticks first, timed with nothing else in the loop;
    # then the CPU session's on the same blocks
    pk_ms, pk_frames, pk_worst, pk_found = [], [], {}, 0
    reset_counters("peak_hold.launches")
    for i in range(SESSION_SIDE_TICKS):
        session_feed(pk, blocks, i)
        t0 = time.perf_counter()
        got = pk.tick()
        torch.cuda.synchronize()
        pk_ms.append((time.perf_counter() - t0) * 1e3)
        pk_frames.append(session_host(got))
        pk_found += int(got.oscilloscope.trigger_found.any())
    pk_launches = counter("peak_hold.launches")
    for i in range(SESSION_SIDE_TICKS):
        session_feed(pk_cpu, blocks, i)
        err = session_errors(pk_frames[i], session_host(pk_cpu.tick()))
        for k, v in err.items():
            pk_worst[k] = (pk_worst.get(k, True) and v) if k == "trigger_equal" else max(pk_worst.get(k, 0.0), v)
    require(pk_launches == SESSION_SIDE_TICKS,
            f"peak trigger: kernel D launched {pk_launches} times in {SESSION_SIDE_TICKS} ticks")
    require(all(v <= 1.0 for k, v in pk_worst.items() if k != "trigger_equal") and pk_worst["trigger_equal"],
            f"peak trigger session vs CPU: {pk_worst}")
    require(pk_found > 0, "peak trigger: no tick found a trigger")
    require(pk.engine.diagnostics.counters["session.failures"] == 0, "peak trigger: a view failed")
    launches_out["peak_hold"] = launches_out.get("peak_hold", 0) + pk_launches
    calls_out["peak_hold"] = calls_out.get("peak_hold", 0) + SESSION_SIDE_TICKS
    pk_spread = {"p50": float(np.percentile(pk_ms[4:], 50)), "p99": float(np.percentile(pk_ms[4:], 99))}
    pk_cpu.close()
    # syncs a tick of the `peak trigger` session, as the main run's last
    # ticks count them, on the blocks after those checked above
    pk_syncs, pk_sites = [], collections.Counter()
    for i in range(SESSION_SIDE_TICKS, SESSION_SIDE_TICKS + PEAK_SYNC_TICKS):
        session_feed(pk, blocks, i)
        with SyncCounter(torch) as sc:
            pk.tick()
        torch.cuda.synchronize()
        pk_syncs.append(sc.count)
        pk_sites.update(sc.sites)

    # the factory preset `coloured.oscilloscope` (the spectral-energy colour
    # track: kernel E once a tick), against the same session on the CPU
    from signalizer_tpu_torch.kernels import colour_track as ct

    def coloured(eng):
        require(eng.load_preset("coloured.oscilloscope"), "no factory preset coloured.oscilloscope")
        eng.spectrum.frequency_tracker.set_normalized(1 / 3)  # transform, as session_open sets it

    co, co_cpu = session_open(dev, knobs=coloured), session_open("cpu", knobs=coloured)
    co_osc = co.processor("oscilloscope")
    require(co_osc.constant.colour_enabled, "coloured: the preset's oscilloscope has no colour track")
    co_ms, co_frames, co_worst = [], [], {}
    reset_counters("colour_track.launches")
    for i in range(SESSION_SIDE_TICKS):
        session_feed(co, blocks, i)
        t0 = time.perf_counter()
        got = co.tick()
        torch.cuda.synchronize()
        co_ms.append((time.perf_counter() - t0) * 1e3)
        co_frames.append(session_host(got))
    co_launches = counter("colour_track.launches")
    for i in range(SESSION_SIDE_TICKS):
        session_feed(co_cpu, blocks, i)
        err = session_errors(co_frames[i], session_host(co_cpu.tick()))
        for k, v in err.items():
            co_worst[k] = (co_worst.get(k, True) and v) if k == "trigger_equal" else max(co_worst.get(k, 0.0), v)
    require(co_launches == SESSION_SIDE_TICKS,
            f"coloured: kernel E launched {co_launches} times in {SESSION_SIDE_TICKS} ticks")
    require(all(v <= 1.0 for k, v in co_worst.items() if k != "trigger_equal") and co_worst["trigger_equal"],
            f"coloured session vs CPU: {co_worst}")
    last = co_frames[-1]["oscilloscope.colours"]
    require(bool(np.isfinite(last).all()) and float(np.ptp(last)) > 0.0, "coloured: the colours do not vary")
    require(co.engine.diagnostics.counters["session.failures"] == 0, "coloured: a view failed")
    launches_out["colour_track"] = launches_out.get("colour_track", 0) + co_launches
    calls_out["colour_track"] = calls_out.get("colour_track", 0) + SESSION_SIDE_TICKS
    co_cpu.close()
    co_syncs, co_sites = [], collections.Counter()
    for i in range(SESSION_SIDE_TICKS, SESSION_SIDE_TICKS + PEAK_SYNC_TICKS):
        session_feed(co, blocks, i)
        with SyncCounter(torch) as sc:
            co.tick()
        torch.cuda.synchronize()
        co_syncs.append(sc.count)
        co_sites.update(sc.sites)

    # the factory preset `cycles.oscilloscope` (the SPECTRAL trigger, the
    # window locked to the detected cycles: kernel F once a tick, and the
    # Cycles window read back), against the same session with the walk's
    # plain version on the card (bit-equal) and on the CPU
    from signalizer_tpu_torch.kernels import spectral_walk as sw
    from signalizer_tpu_torch.params.transformatters import TimeMode

    def cycles(eng):
        require(eng.load_preset("cycles.oscilloscope"), "no factory preset cycles.oscilloscope")
        eng.spectrum.frequency_tracker.set_normalized(1 / 3)  # transform, as session_open sets it

    cy, cy_plain, cy_cpu = (session_open(d, knobs=cycles) for d in (dev, dev, "cpu"))
    cy_osc = cy.processor("oscilloscope")
    require(cy_osc.trigger_mode == TriggerMode.SPECTRAL and cy_osc.time_mode == TimeMode.CYCLES,
            "cycles: the preset's oscilloscope is not SPECTRAL in Cycles mode")
    cy_ms, cy_frames, cy_fund, cy_windows, cy_passes, cy_calls = [], [], [], [], [], []
    reset_counters("spectral_walk.launches", "spectral_walk.spectrum_launches")
    for i in range(SESSION_SIDE_TICKS):
        session_feed(cy, blocks, i)
        cy_calls.append([])
        with resample_log(cy_calls[-1]):
            t0 = time.perf_counter()
            got = cy.tick()
            torch.cuda.synchronize()
            cy_ms.append((time.perf_counter() - t0) * 1e3)
        cy_frames.append(session_host(got))
        cy_fund.append(float(got.oscilloscope.fundamental[0]))
        cy_windows.append(cy_osc._cycle_window)
        cy_passes.append(int(sw.last_passes.max()))
    cy_launches = counter("spectral_walk.launches")
    require(counter("spectral_walk.spectrum_launches") == cy_launches,
            "cycles: kernel F launched other than through its spectrum entry")
    with plain_walk():
        for i in range(SESSION_SIDE_TICKS):
            session_feed(cy_plain, blocks, i)
            session_equal(session_host(cy_plain.tick()), cy_frames[i], f"cycles tick {i}: kernel F vs the plain walk")
    require(counter("spectral_walk.launches") == cy_launches, "cycles: the plain walk's session launched kernel F")
    # against the CPU: every view within its card tolerance, the fundamental
    # and the Cycles window within rtol 1e-5, trigger_found equal; but the
    # card's trigger is not the CPU's (cuFFT and the CPU's transform round
    # differently, and the Goertzel phase lock sums in another order), so
    # the f32 window start or step, at ~16000 samples into the history, may
    # lie an ulp or two away, and a pixel's position with them (2^-10 to
    # 2^-9 samples). The waveform is held to CYCLES_WAVE_TOL x gain, set
    # from the card's readings (at most 3.1e-4, on 3 of 24 ticks); the
    # envelopes, nearest picks that such a move can flip by a whole sample,
    # are reported. The witness: the CPU's plain resample of its own rows
    # at the card's start and step gives the card's waveform and envelope
    # picks within kernel C's tolerance.
    cy_worst, cy_fund_err = {}, 0.0
    cy_cpu_err = {"waveform": [], "envelopes": []}
    cy_witness = {"start_diff": [], "step_diff": 0.0, "replay_err": 0.0}
    for i in range(SESSION_SIDE_TICKS):
        session_feed(cy_cpu, blocks, i)
        cpu_calls = []
        with resample_log(cpu_calls):
            want = cy_cpu.tick()
        host = session_host(want)
        gain = max(1.0, float(np.abs(host["oscilloscope.gain"]).max()))
        cy_cpu_err["waveform"].append(
            float(np.abs(cy_frames[i]["oscilloscope.waveform"] - host["oscilloscope.waveform"]).max()) / gain)
        cy_cpu_err["envelopes"].append(max(
            float(np.abs(cy_frames[i][f"oscilloscope.{k}"] - host[f"oscilloscope.{k}"]).max()) / gain
            for k in ("envelope_min", "envelope_max")))
        err = session_errors(cy_frames[i], host)
        err.pop("oscilloscope")
        for k, v in err.items():
            cy_worst[k] = (cy_worst.get(k, True) and v) if k == "trigger_equal" else max(cy_worst.get(k, 0.0), v)
        f = float(want.oscilloscope.fundamental[0])
        w = cy_cpu.processor("oscilloscope")._cycle_window
        cy_fund_err = max(cy_fund_err, abs(cy_fund[i] - f) / f, abs(cy_windows[i] - w) / w)
        wit = trigger_witness(cy_calls[i], cpu_calls)
        cy_witness["start_diff"].append(wit["start_diff"])
        cy_witness["step_diff"] = max(cy_witness["step_diff"], wit["step_diff"])
        cy_witness["replay_err"] = max(cy_witness["replay_err"], wit["replay_err"])
    require(max(cy_cpu_err["waveform"]) <= CYCLES_WAVE_TOL,
            f"cycles session vs CPU: waveform {max(cy_cpu_err['waveform'])} x gain (tolerance {CYCLES_WAVE_TOL})")
    require(cy_witness["replay_err"] <= 1.0,
            f"cycles: the CPU resample at the card's start is {cy_witness['replay_err']} x kernel C's tolerance away")
    require(cy_launches == SESSION_SIDE_TICKS,
            f"cycles: kernel F launched {cy_launches} times in {SESSION_SIDE_TICKS} ticks")
    require(all(v <= 1.0 for k, v in cy_worst.items() if k != "trigger_equal") and cy_worst["trigger_equal"]
            and cy_fund_err <= 1e-5, f"cycles session vs CPU: {cy_worst}, fundamental and window {cy_fund_err}")
    require(cy.engine.diagnostics.counters["session.failures"] == 0, "cycles: a view failed")
    launches_out["spectral_walk"] = launches_out.get("spectral_walk", 0) + cy_launches
    calls_out["spectral_walk"] = calls_out.get("spectral_walk", 0) + SESSION_SIDE_TICKS
    cy_plain.close()
    cy_cpu.close()
    cy_syncs, cy_sites = [], collections.Counter()
    for i in range(SESSION_SIDE_TICKS, SESSION_SIDE_TICKS + PEAK_SYNC_TICKS):
        session_feed(cy, blocks, i)
        with SyncCounter(torch) as sc:
            cy.tick()
        torch.cuda.synchronize()
        cy_syncs.append(sc.count)
        cy_sites.update(sc.sites)
    # the default tick's syncs are its three readbacks; the Cycles window's
    # readback is the one more
    require(max(syncs[True]) == 3, f"session: {max(syncs[True])} syncs a tick, sites {dict(sites[True])}")
    require(max(cy_syncs) == max(syncs[True]) + 1, f"cycles: {max(cy_syncs)} syncs a tick, sites {dict(cy_sites)}")

    def spread(v):
        v = v[10:]
        return {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99))}

    # every kernel a tick launches (the torch operations' too), over ten
    # more ticks of the main session under the profiler
    next_block = {"i": SESSION_TICKS}

    def tick():
        session_feed(s, blocks, next_block["i"])
        next_block["i"] += 1
        return s.tick()

    def ten_ticks():
        for _ in range(10):
            tick()
        torch.cuda.synchronize()

    # the `peak trigger` session's ticks for the profile phase, on the
    # blocks after those it was checked on
    pk_block = {"i": SESSION_SIDE_TICKS + PEAK_SYNC_TICKS}

    def peak_trigger_tick():
        session_feed(pk, blocks, pk_block["i"])
        pk_block["i"] += 1
        return pk.tick()

    # the `coloured` session's ticks for the profile phase, likewise
    co_block = {"i": SESSION_SIDE_TICKS + PEAK_SYNC_TICKS}

    def coloured_tick():
        session_feed(co, blocks, co_block["i"])
        co_block["i"] += 1
        return co.tick()

    # the `cycles` session's ticks for the profile phase, likewise
    cy_block = {"i": SESSION_SIDE_TICKS + PEAK_SYNC_TICKS}

    def cycles_tick():
        session_feed(cy, blocks, cy_block["i"])
        cy_block["i"] += 1
        return cy.tick()

    def close():
        rs.close()
        cy.close()
        co.close()
        pk.close()
        s.close()

    # the default, the `peak trigger`, the `coloured` and the `cycles`
    # session a tick each in turn (the order rotating), so that the host's
    # drift falls on all alike
    turns = {"default": [], "peak_trigger": [], "coloured": [], "cycles": []}
    order = [("default", tick), ("peak_trigger", peak_trigger_tick), ("coloured", coloured_tick),
             ("cycles", cycles_tick)]
    for i in range(PEAK_TURN_TICKS):
        for name, fn in order[i % 4:] + order[: i % 4]:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t0) * 1e3)
    in_turns = {name: {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99))}
                for name, v in turns.items()}
    for name in ("peak_trigger", "coloured", "cycles"):
        in_turns[f"{name}_minus_default_ms"] = float(np.median(np.subtract(turns[name], turns["default"])))
    require(in_turns["coloured"]["p50"] <= FRAME_MS,
            f"coloured: a tick takes {in_turns['coloured']['p50']} ms (p50), over a {FRAME_MS:.1f} ms frame")

    tick_kernels_us, tick_launches, _, tick_attempts = profiled(ten_ticks, 10)
    require(sum(tick_kernels_us.values()) > 0, "session: the profiler saw no device time")

    report = {
        "phase": "session", "ticks": SESSION_TICKS, "block": HOP, "geometry": geometry,
        "tick_ms": spread(ms[True]), "per_view_tick_ms": spread(ms[False]),
        "launches_per_tick": {k: v / SESSION_TICKS for k, v in launches.items()},
        "own_launches_per_tick": sum(launches.values()) / SESSION_TICKS,
        "all_launches_per_tick": tick_launches / 10, "device_us_per_tick": sum(tick_kernels_us.values()),
        "profile_attempts": tick_attempts,
        "other_own_launches": others,
        "syncs_per_tick": {"median": float(np.median(syncs[True])), "max": int(max(syncs[True]))},
        "per_view_syncs_per_tick": {"median": float(np.median(syncs[False])), "max": int(max(syncs[False]))},
        "sync_sites": {k: v / SESSION_SYNC_TICKS for k, v in sites[True].most_common()},
        "fused_ticks": diag["session.fused_ticks"], "fallbacks": diag["session.fallbacks"],
        "failures": diag["session.failures"], "spectrogram_columns": columns,
        "sine_pixel": sine_px, "tracker_hz": {"min": min(tracked), "max": max(tracked)},
        "fused_equals_per_view": True,
        "cpu_ticks": SESSION_SIDE_TICKS, "cpu_err_in_tolerances": worst,
        "rsnt": {"ticks": SESSION_SIDE_TICKS, "bank_calls": rsnt_bank_calls, "decay_db_launches": rsnt_launches,
                 "resonator_scan_launches": rsnt_scans, "tick_ms": {"p50": float(np.percentile(rsnt_ms, 50)),
                                                                    "p99": float(np.percentile(rsnt_ms, 99))},
                 "syncs_per_tick": rsnt_sc.count, "sync_sites": dict(rsnt_sc.sites),
                 "display_db_map_max_abs_err": rsnt_err["display_db_map"],
                 "display_linear_err_of_peak": rsnt_err["display"], "bank_err_of_peak": rsnt_err["bank"]},
        "trigger_reconfigure": {"ticks": SESSION_SIDE_TICKS, "vectorscope_windows": sorted(set(windows))},
        "restored_equal": True,
        "peak_trigger": {"ticks": SESSION_SIDE_TICKS, "tick_ms": pk_spread, "peak_hold_launches": pk_launches,
                         "ticks_found": pk_found, "cpu_err_in_tolerances": pk_worst,
                         "syncs_per_tick": {"median": float(np.median(pk_syncs)), "max": int(max(pk_syncs))},
                         "in_turns_with_default": {"ticks": PEAK_TURN_TICKS, **in_turns},
                         "sync_sites": {k: v / PEAK_SYNC_TICKS for k, v in pk_sites.most_common()}},
        "coloured": {"ticks": SESSION_SIDE_TICKS, "tick_ms": spread(co_ms), "colour_track_launches": co_launches,
                     "cpu_err_in_tolerances": co_worst,
                     "syncs_per_tick": {"median": float(np.median(co_syncs)), "max": int(max(co_syncs))},
                     "in_turns_with_default": {"ticks": PEAK_TURN_TICKS, "p50": in_turns["coloured"]["p50"],
                                               "p99": in_turns["coloured"]["p99"],
                                               "minus_default_ms": in_turns["coloured_minus_default_ms"]},
                     "sync_sites": {k: v / PEAK_SYNC_TICKS for k, v in co_sites.most_common()}},
        "cycles": {"ticks": SESSION_SIDE_TICKS, "tick_ms": spread(cy_ms), "spectral_walk_launches": cy_launches,
                   "walk_passes": {"min": min(cy_passes), "max": max(cy_passes)},
                   "plain_walk_equal": True, "cpu_err_in_tolerances": cy_worst,
                   "cpu_waveform_abs_over_gain": max(cy_cpu_err["waveform"]),
                   "cpu_waveform_tolerance_over_gain": CYCLES_WAVE_TOL,
                   "cpu_envelopes_abs_over_gain": max(cy_cpu_err["envelopes"]),
                   "cpu_by_tick": {"waveform_abs_over_gain": cy_cpu_err["waveform"],
                                   "envelopes_abs_over_gain": cy_cpu_err["envelopes"],
                                   "start_diff_samples": cy_witness["start_diff"]},
                   "cpu_start_diff_samples": max(cy_witness["start_diff"]),
                   "cpu_step_diff_samples": cy_witness["step_diff"],
                   "cpu_resample_at_card_start_err_over_tol": cy_witness["replay_err"],
                   "cpu_fundamental_window_rel_err": cy_fund_err,
                   "syncs_per_tick": {"median": float(np.median(cy_syncs)), "max": int(max(cy_syncs))},
                   "in_turns_with_default": {"ticks": PEAK_TURN_TICKS, "p50": in_turns["cycles"]["p50"],
                                             "p99": in_turns["cycles"]["p99"],
                                             "minus_default_ms": in_turns["cycles_minus_default_ms"]},
                   "sync_sites": {k: v / PEAK_SYNC_TICKS for k, v in cy_sites.most_common()}},
    }
    info(report)
    require(all(v <= 1.0 for k, v in worst.items() if k != "trigger_equal") and worst["trigger_equal"],
            f"session vs CPU session: {worst}")
    # the bank to 2e-6 of its peak (the resonator's card tolerance), its
    # display in linear units to the spectrum's 1e-5 of the peak; the dB
    # map itself is reported, not held: it magnifies the bank's rounding
    # at the faintest pixels (a pixel 80 dB down moves by 0.02 dB)
    require(rsnt_err["bank"] <= 2e-6 and rsnt_err["display"] <= 1e-5, f"RSNT vs CPU: {rsnt_err}")

    return tick, peak_trigger_tick, coloured_tick, cycles_tick, rsnt_tick, close


# kernel D, the envelope-hold scan: the cases it is held to its plain loop
# at (rows, W, samples consumed, hysteresis), three calls each with the
# state carried; the first is the oscilloscope step's at cfg3 (a 1600-sample
# tick in its 2048-sample bucket), the second the whole lookahead
HOLD_CASES = [
    ("cfg3_tick", PAIRS, 2048, OSC_HOP, 0.5),
    ("cfg3_lookahead", PAIRS, 8192, 8192, 0.5),
    ("rows1_w1", 1, 1, 1, 0.0),
    ("rows33_w1600", 33, 1600, 1600, 0.0),
    ("rows16_w8192_one", PAIRS, 8192, 1, 0.0),
    ("rows16_w8192_none", PAIRS, 8192, 0, 0.5),
]
HOLD_CALLS = 3
# the serial chain's estimate: a subtract, a compare and a select a sample,
# each waiting on the last sample's state
HOLD_CYCLES_PER_SAMPLE = 16
FRAME_MS = 1000.0 / 60.0


def hold_rows(torch, rows, w, seed, dev):
    """Noise under a slow envelope of random phase a row: rises and falls."""
    rng = np.random.default_rng(seed)
    t = np.arange(w)
    env = 0.55 + 0.45 * np.sin(2 * np.pi * t / max(w / 3.0, 7.0) + rng.uniform(0, 6.3, (rows, 1)))
    return torch.tensor((env * rng.standard_normal((rows, w))).astype(np.float32), device=dev)


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def nan_err(torch, a, b) -> float:
    """Largest |a - b|: 0 where both are NaN, inf where only one is."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    diff = (a - b).abs().masked_fill(nan_a & nan_b, 0.0).masked_fill(nan_a ^ nan_b, float("inf"))
    return float(diff.max()) if diff.numel() else 0.0


# the fused entry's geometry: cfg3's history and window
HOLD_HF, HOLD_WINDOW = float(OSC_HISTORY), OSC_WINDOW
# the fused entry's queue cases: (name, rows, W, samples consumed, new
# samples, hysteresis, signal, carried ages), three calls each
FUSED_CASES = [
    ("fractional_new_samples", PAIRS, 2048, OSC_HOP, OSC_HOP + 0.5, 0.5, "noise", "empty"),
    ("new_samples_over_chunk", PAIRS, 2048, 2048, 3000.0, 0.0, "noise", "empty"),
    ("over_8_fires", PAIRS, 8192, 8192, 8192.0, 0.0, "spikes", "empty"),
    ("no_fire", PAIRS, 2048, OSC_HOP, float(OSC_HOP), 0.5, "quiet", "empty"),
    ("ages_past_history", PAIRS, 2048, OSC_HOP, float(OSC_HOP), 0.5, "noise", "old"),
]


def hold_signal(torch, rows, w, seed, dev, kind):
    x = hold_rows(torch, rows, w, seed, dev)
    if kind == "quiet":
        x *= 0.01
    elif kind == "spikes":
        x[:, 50::100] = 4.0  # each spike rises above the decayed peak: a fire every 100 samples
    return x


def phase_kernel_d(torch, dev, results):
    """Kernel D's two entries against their plain versions on the same
    CUDA tensors, bit for bit: the function entry (fires, state, holding)
    against the loop at HOLD_CASES, a NaN sample, a fall at sample 0, with
    device scalars and a device mask; the fused entry (state, holding, fire
    ages, found, start) against ``envelope_hold_trigger_plain`` at the same
    cases (no mask: it takes none) and at FUSED_CASES. Both timed at cfg3's
    tick and lookahead beside their plain versions, the bound and the chain
    estimate. Returns the profile's workloads: each entry at cfg3's tick
    and at 16 x 8192."""
    from signalizer_tpu_torch.kernels import peak_hold as ph

    # the largest errors and the mismatched bytes, over every case held below
    worst = {"state_max_abs_err": 0.0, "fire_mismatches": 0, "holding_mismatches": 0}
    fused_worst = {"state_max_abs_err": 0.0, "holding_mismatches": 0, "ages_max_abs_err": 0.0,
                   "found_mismatches": 0, "start_max_abs_err": 0.0}

    def hold_both(what, x, thr, hyst, state, holding, **kw):
        got = ph.peak_hold_triggers(x, thr, hyst, state, holding, **kw)
        want = ph.peak_hold_triggers_plain(x, thr, hyst, state, holding, **kw)
        torch.cuda.synchronize()
        err = {"state_max_abs_err": nan_err(torch, got[1], want[1]),
               "fire_mismatches": int((got[0] != want[0]).sum()),
               "holding_mismatches": int((got[2] != want[2]).sum())}
        for k, v in err.items():
            worst[k] = max(worst[k], v)
        require(all(v == 0 for v in err.values()), f"kernel D {what}: the function entry differs from the loop: {err}")
        return got

    def fused_both(what, x, thr, hyst, state, holding, ages, **kw):
        got = ph.envelope_hold_trigger(x, thr, hyst, state, holding, ages, **kw)
        want = ph.envelope_hold_trigger_plain(x, thr, hyst, state, holding, ages, **kw)
        torch.cuda.synchronize()
        err = {"state_max_abs_err": nan_err(torch, got[0], want[0]),
               "holding_mismatches": int((got[1] != want[1]).sum()),
               "ages_max_abs_err": nan_err(torch, got[2], want[2]),
               "found_mismatches": int((got[3] != want[3]).sum()),
               "start_max_abs_err": nan_err(torch, got[4], want[4])}
        for k, v in err.items():
            fused_worst[k] = max(fused_worst[k], v)
        require(all(v == 0 for v in err.values()), f"kernel D {what}: the fused entry differs from its plain version: {err}")
        return got

    def fused_kw(w, consumed, ns):
        return dict(first=w - consumed, new_samples=ns, window=HOLD_WINDOW, hf=HOLD_HF)

    clock = max_sm_clock_hz()
    report = {"phase": "kernel_d", "bound": "every output bit-equal to the plain version (NaN where it is NaN)",
              "max_sm_clock_mhz": clock / 1e6, "cases": {}}
    thr = 0.1
    empty = lambda rows: torch.full((rows, ph.PEAK_QUEUE_SIZE), ph.FIRE_AGE_NONE, device=dev)  # noqa: E731
    for name, rows, w, consumed, hyst in HOLD_CASES:
        state = torch.full((rows,), thr * thr, device=dev)
        holding = torch.zeros((rows,), dtype=torch.bool, device=dev)
        fstate, fholding, ages = state, holding, empty(rows)
        fired, found = 0, 0
        for call in range(HOLD_CALLS):
            x = hold_rows(torch, rows, w, 100 * rows + call, dev)
            fires, state, holding = hold_both(f"{name} call {call}", x, thr, hyst, state, holding, first=w - consumed)
            fired += int(fires.sum())
            fstate, fholding, ages, hit, _ = fused_both(f"{name} call {call}", x, thr, hyst, fstate, fholding, ages,
                                                        **fused_kw(w, consumed, float(consumed)))
            found += int(hit.sum())
        require(consumed < 1600 or fired > 0, f"kernel D {name}: no fire in {HOLD_CALLS} calls")
        report["cases"][name] = {"rows": rows, "W": w, "consumed": consumed, "hysteresis": hyst, "fires": fired,
                                 "fused_found": found}
    for name, rows, w, consumed, ns, hyst, kind, carried in FUSED_CASES:
        state = torch.full((rows,), thr * thr, device=dev)
        holding = torch.zeros((rows,), dtype=torch.bool, device=dev)
        ages = empty(rows)
        if carried == "old":  # out of order, some past the history's length once aged
            ages = torch.tensor([16000.0, 5.0, 1e9, 16383.0, 700.0, 1e9, 15000.0, 512.0], device=dev).repeat(rows, 1)
        found, newest = 0, 0
        for call in range(HOLD_CALLS):
            x = hold_signal(torch, rows, w, 200 * rows + call, dev, kind)
            state, holding, ages, hit, _ = fused_both(f"{name} call {call}", x, thr, hyst, state, holding, ages,
                                                      **fused_kw(w, consumed, ns))
            found += int(hit.sum())
            newest = int((ages < ph.FIRE_AGE_NONE).sum(-1).min())
        require(kind != "spikes" or newest == ph.PEAK_QUEUE_SIZE, f"kernel D {name}: the queue is not full")
        require(kind != "quiet" or bool((ages == ph.FIRE_AGE_NONE).all()), f"kernel D {name}: a quiet row fired")
        report["cases"][name] = {"rows": rows, "W": w, "consumed": consumed, "new_samples": ns, "hysteresis": hyst,
                                 "signal": kind, "carried": carried, "fused_found": found}
    # a NaN sample, a row of NaN, a held peak falling at sample 0 (the
    # boundary clamp), device scalars over rows strided out of a history,
    # a device mask that is not a suffix (the function entry only)
    x = hold_rows(torch, 4, 1600, 11, dev)
    x[1, 700] = float("nan")
    x[2] = float("nan")
    st0, hold0 = torch.full((4,), 0.01, device=dev), torch.zeros(4, dtype=torch.bool, device=dev)
    _, st, _ = hold_both("nan", x, thr, 0.5, st0, hold0)
    require(bool(torch.isnan(st[2])), "kernel D: a row of NaN leaves a NaN state")
    st, _, _, _, _ = fused_both("nan", x, thr, 0.5, st0, hold0, empty(4), **fused_kw(1600, 1600, 1600.0))
    require(bool(torch.isnan(st[2])), "kernel D: a row of NaN leaves a NaN state (fused entry)")
    y = torch.full((3, 1600), 0.05, device=dev)
    st0, hold0 = torch.full((3,), 4.0, device=dev), torch.ones(3, dtype=torch.bool, device=dev)
    fires, _, _ = hold_both("fall at sample 0", y, thr, 0.0, st0, hold0)
    require(bool(fires[:, 0].all()), "kernel D: a fall at sample 0 fires at sample 0")
    _, _, ages, _, _ = fused_both("fall at sample 0", y, thr, 0.0, st0, hold0, empty(3), **fused_kw(1600, 1600, 1600.0))
    require(bool((ages[:, 0] == 1599.0).all()), "kernel D: a fall at sample 0 has the age of sample 0")
    hist = hold_rows(torch, 2 * PAIRS, 8192, 7, dev).reshape(PAIRS, 2, 8192)
    region = hist[:, 1, 8192 - 2048:]
    thr_t, hyst_t = torch.tensor(0.2, device=dev), torch.tensor(0.25, device=dev)
    st0, hold0 = torch.square(thr_t).expand(PAIRS).clone(), torch.zeros(PAIRS, dtype=torch.bool, device=dev)
    hold_both("device scalars, strided rows", region, thr_t, hyst_t, st0, hold0, first=2048 - OSC_HOP)
    fused_both("device scalars, strided rows", region, thr_t, hyst_t, st0, hold0, empty(PAIRS),
               **fused_kw(2048, OSC_HOP, float(OSC_HOP)))
    mask = torch.from_numpy(np.random.default_rng(3).random(2048) < 0.7).to(dev)
    hold_both("device mask", region, thr_t, hyst_t, st0, hold0, valid=mask)

    # timed: the oscilloscope step's tick (16 rows, 1600 of 2048 consumed)
    # and the whole lookahead (16 x 8192), each entry beside its plain version
    timed, workloads = {}, []
    for name, rows, w, consumed in (("cfg3_tick", PAIRS, 2048, OSC_HOP), ("cfg3_lookahead", PAIRS, 8192, 8192)):
        x = hold_rows(torch, rows, w, 5, dev)
        st, hold = torch.full((rows,), thr * thr, device=dev), torch.zeros(rows, dtype=torch.bool, device=dev)
        ages = empty(rows)
        kw = fused_kw(w, consumed, float(consumed))

        def fn_entry(x=x, st=st, hold=hold, w=w, consumed=consumed):
            return ph.peak_hold_triggers(x, thr, 0.5, st, hold, first=w - consumed)

        def fused(x=x, st=st, hold=hold, ages=ages, kw=kw):
            return ph.envelope_hold_trigger(x, thr, 0.5, st, hold, ages, **kw)

        plain_ms = call_ms(torch, lambda: ph.peak_hold_triggers_plain(x, thr, 0.5, st, hold, first=w - consumed),
                           reps=1)
        fused_plain_ms = call_ms(torch, lambda: ph.envelope_hold_trigger_plain(x, thr, 0.5, st, hold, ages, **kw),
                                 reps=1)
        # the span read, state in and out; fire bytes (function entry) or
        # the queue in and out, found and start (fused entry)
        moved = rows * consumed * 4 + 2 * rows * (4 + 1)
        flops = rows * consumed * 7.0
        chain_us = consumed * HOLD_CYCLES_PER_SAMPLE / clock * 1e6
        timed[name] = dict(
            ms=median_ms(torch, fn_entry), plain_ms=plain_ms, **roofline(moved + rows * w, flops),
            fused_ms=median_ms(torch, fused), fused_plain_ms=fused_plain_ms,
            fused_bound_ms=roofline(moved + rows * (2 * 8 * 4 + 1 + 4), flops)["bound_ms"],
            chain_estimate_us=chain_us,
        )
        workloads += [(f"peak_hold_{name}", fn_entry), (f"envelope_hold_{name}", fused)]
    report["timed"] = timed
    report["measured_err"] = {"peak_hold_triggers": worst, "envelope_hold_trigger": fused_worst}
    info(report)
    tick, look = timed["cfg3_tick"], timed["cfg3_lookahead"]
    fused_bound = roofline(PAIRS * OSC_HOP * 4 + 2 * PAIRS * 5 + PAIRS * (2 * 8 * 4 + 5), PAIRS * OSC_HOP * 7.0)
    results["peak_hold"] = dict(
        entries=["envelope_hold_trigger (main path)", "peak_hold_triggers"],
        max_abs_err=max(worst["state_max_abs_err"], *(v for k, v in fused_worst.items() if k.endswith("err"))),
        mismatches=worst["fire_mismatches"] + worst["holding_mismatches"] + fused_worst["holding_mismatches"]
        + fused_worst["found_mismatches"],
        measured_err={"peak_hold_triggers": worst, "envelope_hold_trigger": fused_worst},
        ms=tick["fused_ms"], plain_ms=tick["fused_plain_ms"], bound_ms=fused_bound["bound_ms"],
        bound_by=fused_bound["bound_by"], library_ms=None, chain_estimate_us=tick["chain_estimate_us"],
        peak_hold_triggers_ms=tick["ms"], peak_hold_triggers_plain_ms=tick["plain_ms"],
        peak_hold_triggers_bound_ms=tick["bound_ms"],
        lookahead_ms=look["ms"], lookahead_fused_ms=look["fused_ms"],
        lookahead_chain_estimate_us=look["chain_estimate_us"], lookahead_bound_ms=look["bound_ms"],
    )
    return workloads


# kernel E, the colour track: the cases it is held to its plain version and
# the float64 oracle at (name, pairs, rows, W, carried states), two calls
# each with the states carried; every case has a silent last row and, with
# four rows or more, a denormal row
COLOUR_CASES = [
    ("cfg3_zero_state", PAIRS, 2, OSC_HISTORY, False),
    ("cfg3_carried", PAIRS, 2, OSC_HISTORY, True),
    ("session", 1, 2, OSC_HISTORY, True),
    ("ragged_w3001", 3, 2, 3001, True),
]
COLOUR_BANDS = ((1.0, 0.1, 0.1), (0.1, 1.0, 0.1), (0.1, 0.1, 1.0))  # the constant's default band colours


def colour_inputs(torch, pairs, rows, w, carried, seed, dev):
    """x [pairs, rows, W] at 96 kHz: three tones and noise a row, the last
    row silent from a zero state, the first pair's last row denormal
    (amplitude 5e-39) where there are four rows or more; states zero or
    small random ones; a key per pair and row."""
    from signalizer_tpu_torch.kernels import colour_track as ct

    rng = np.random.default_rng(seed)
    n = np.arange(w)
    x = np.zeros((pairs, rows, w), np.float32)
    for p in range(pairs):
        for r in range(rows):
            amp = rng.uniform(0.05, 0.5, 3)
            x[p, r] = sum(a * np.sin(2 * np.pi * f * (1 + 0.1 * p) * n / OSC_FS + r)
                          for a, f in zip(amp, (120.0, 900.0, 6000.0)))
            x[p, r] += 0.01 * rng.standard_normal(w)
    denormal = pairs * rows >= 4
    if denormal:
        x[0, rows - 1] *= np.float32(1e-38)
    x[-1, -1] = 0.0
    z = (rng.standard_normal((pairs, rows, 8, 2)) * 0.01 * carried).astype(np.float32)
    s = (rng.random((pairs, rows, 3)) * 0.01 * carried).astype(np.float32)
    z[-1, -1] = 0.0
    s[-1, -1] = 0.0
    key = rng.random((pairs, rows, 3)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(x), ct.CrossoverState(t(z)), t(s), t(key), denormal


def phase_kernel_e(torch, dev, results):
    """Kernel E's two entries against their plain versions (the doubling
    scans, on the same CUDA tensors) and the float64 oracle at
    COLOUR_CASES: the split (bands, crossover state) and the fused colour
    track (colours, both states), and the fused entry on bands it is given
    (``spectral_colour_track``). Colours within 1e-3 of the plain
    version's; bands and states no further from the oracle than 2x the
    plain version's own error (plus one float32 rounding of the peak); a
    silent row exactly the plain version's, its bands and states zero; a
    denormal row not flushed. Timed at cfg3 beside the plain version and
    the bound. Returns the profile's workloads."""
    from signalizer_tpu_torch.kernels import colour_track as ct
    from signalizer_tpu_torch.kernels import oscilloscope as tk

    pole = float(np.exp(-1.0 / (10e-3 * OSC_FS)))  # the constant's 10 ms smoother at 96 kHz
    bc = torch.tensor(COLOUR_BANDS, device=dev)
    bands64 = np.asarray(COLOUR_BANDS)
    blend = torch.tensor(0.8, device=dev)
    worst = {"colours_vs_plain": 0.0, "bands_err": 0.0, "bands_plain_err": 0.0, "z_err": 0.0, "z_plain_err": 0.0,
             "smooth_err": 0.0, "smooth_plain_err": 0.0}

    def err(got, ref):
        return float(np.abs(got.cpu().numpy().reshape(ref.shape) - ref).max())

    def within(what, got, plain, ref, key):
        e, pe = err(got, ref), err(plain, ref)
        worst[key + "_err"] = max(worst[key + "_err"], e)
        worst[key + "_plain_err"] = max(worst[key + "_plain_err"], pe)
        floor = float(np.abs(ref).max()) * 2.0**-23
        require(e <= 2 * pe + floor, f"kernel E {what}: {key} {e} from the oracle, the plain version {pe}")

    report = {"phase": "kernel_e", "bound": "colours 1e-3 of the plain version; bands and states <= 2x the plain "
              "version's distance from the float64 oracle", "cases": {}}
    for name, pairs, rows, w, carried in COLOUR_CASES:
        x, state, smooth, key, denormal = colour_inputs(torch, pairs, rows, w, carried, len(name) + w, dev)
        b = pairs * rows
        z64, s64 = state.z.cpu().numpy().reshape(b, 8, 2), smooth.cpu().numpy().reshape(b, 3)
        split_z64 = z64
        ps, pz, fs_state, pfs_state, psmooth = state, state, state, state, smooth
        for call in range(2):
            xc = x if call == 0 else torch.roll(x, 37, -1)
            what = f"{name} call {call}"
            n = counter("colour_track.launches")
            bands, fs_state = ct.three_band_split(xc, OSC_FS, state=fs_state)
            colours, ps_new, s_new = ct.colour_track(xc, OSC_FS, ps, pole, bc, key, blend, smooth)
            require(counter("colour_track.launches") == n + 2,
                    f"kernel E {what}: {counter('colour_track.launches') - n} launches for two calls")
            pb, pfs_state = ct.three_band_split_plain(xc, OSC_FS, state=pfs_state)
            pc, pz_new, ps_s = ct.colour_track_plain(xc, OSC_FS, pz, pole, bc, key, blend, psmooth)
            torch.cuda.synchronize()
            x64 = xc.cpu().numpy().reshape(b, w)
            ref_b, split_z64, _, _ = ct.float64_reference(x64, OSC_FS, split_z64, 0.0, np.zeros((b, 3)), bands64,
                                                          np.zeros((b, 3)), 0.0)
            _, z64, sm64, _ = ct.float64_reference(x64, OSC_FS, z64, pole, s64, bands64,
                                                   key.cpu().numpy().reshape(b, 3), 0.8)
            s64 = sm64[..., -1]
            within(what, bands, pb, ref_b, "bands")
            within(what, fs_state.z, pfs_state.z, split_z64, "z")
            within(what, ps_new.z, pz_new.z, z64, "z")
            within(what, s_new, ps_s, s64, "smooth")
            d = float((colours - pc).abs().max())
            worst["colours_vs_plain"] = max(worst["colours_vs_plain"], d)
            require(d <= 1e-3, f"kernel E {what}: colours {d} from the plain version's")
            require(torch.equal(colours[-1, -1], pc[-1, -1]), f"kernel E {what}: the silent row's colours")
            require(not bool(bands[-1, -1].any()) and not bool(ps_new.z[-1, -1].any())
                    and not bool(s_new[-1, -1].any()), f"kernel E {what}: the silent row is not zero")
            if denormal:
                nz, pnz = int((bands[0, rows - 1] != 0).sum()), int((pb[0, rows - 1] != 0).sum())
                require(nz == pnz > 0, f"kernel E {what}: {nz} nonzero bands in the denormal row, plain {pnz}")
            ps, pz, smooth, psmooth = ps_new, pz_new, s_new, ps_s
        report["cases"][name] = {"pairs": pairs, "rows": rows, "W": w, "carried": carried, "denormal_row": denormal,
                                 "geometry": ct.colour_plan(b, w, torch.cuda.get_device_properties(dev)
                                                            .multi_processor_count)}
    # the fused entry on bands it is given (spectral_colour_track)
    x, state, smooth, key, _ = colour_inputs(torch, 4, 2, 5000, True, 17, dev)
    bands, _ = ct.three_band_split_plain(x, OSC_FS, state=state)
    n = counter("colour_track.launches")
    got, _ = tk.spectral_colour_track(bands, pole, bc, key, blend, smooth)
    require(counter("colour_track.launches") == n + 1, "kernel E: spectral_colour_track did not launch it once")
    want, _ = ct.spectral_colour_track_plain(bands, pole, bc, key, blend, smooth)
    d = float((got - want).abs().max())
    require(d <= 1e-3, f"kernel E: spectral_colour_track colours {d} from the plain version's")
    report["spectral_colour_track_vs_plain"] = d

    # timed at cfg3 (16 pairs x 2 rows x 16384, the fused entry) beside the
    # plain version; the bound: x read, colours written, the states in and
    # out; 113 float32 operations a sample (8 biquads of 9, 3 smoothers of
    # 4, the mix of 29)
    x, state, smooth, key, _ = colour_inputs(torch, PAIRS, 2, OSC_HISTORY, True, 5, dev)
    rows = 2 * PAIRS

    def fused():
        return ct.colour_track(x, OSC_FS, state, pole, bc, key, blend, smooth)

    def split():
        return ct.three_band_split(x, OSC_FS, state=state)

    moved = x.numel() * 4 * (1 + 3) + rows * (2 * 16 + 2 * 3) * 4 + (9 + 1) * 4 + key.numel() * 4
    bound = roofline(moved, rows * OSC_HISTORY * 113.0)
    plain_ms = call_ms(torch, lambda: ct.colour_track_plain(x, OSC_FS, state, pole, bc, key, blend, smooth), reps=3)
    split_plain_ms = call_ms(torch, lambda: ct.three_band_split_plain(x, OSC_FS, state=state), reps=3)
    report["timed_cfg3"] = {"ms": median_ms(torch, fused), "plain_ms": plain_ms, **bound,
                            "split_ms": median_ms(torch, split), "split_plain_ms": split_plain_ms}
    report["measured_err"] = worst
    info(report)
    t = report["timed_cfg3"]
    results["colour_track"] = dict(
        entries=["colour_track (main path)", "three_band_split", "spectral_colour_track"],
        max_abs_err=worst["colours_vs_plain"], measured_err=worst,
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
        split_ms=t["split_ms"], split_plain_ms=t["split_plain_ms"],
    )
    return [("colour_track_cfg3", fused), ("colour_split_cfg3", split)]


# kernel F, the spectral trigger's walk: the rows it is held to its plain
# loop at (rows of rfft bins of 8192-sample lookaheads at 96 kHz: a sine a
# row, harmonics, a second note, noise, the last row silent), each with
# threshold and hysteresis as host numbers and as device scalars, the
# filtered entry three calls with its history carried
WALK_N = 8192
WALK_ROWS = (1, PAIRS, 33)
WALK_SETTINGS = ((0.0, 0.0), (0.1, 0.4))
# bins fed directly: (name, chain starts, length, ratio (None: each bin the
# next float32 above twice the last, until float32 overflows, then inf),
# first value, hysteresis, acceptances of the first row or None)
WALK_CHAINS = [
    ("longest_chain", [2, 2], 0, None, 2.0 ** -149, 0.0, 276),
    ("normal_chain", [2, 2], 0, None, 2.0 ** -126, 0.4, None),
    ("chain_36", [2, 300], 36, 4.0, 1e-10, 0.4, None),
    ("pass_cap", [2, 40], 300, 1.01, 1.0, -1.0, 280),
]
def walk_x(rows, seed):
    """[rows, 8192] lookaheads: a sine a row from 80 Hz to 6 kHz at 96 kHz
    with harmonics in every third row, a second note in every fourth, noise,
    and the last row silent where there are two or more."""
    rng = np.random.default_rng(seed)
    t = np.arange(WALK_N) / OSC_FS
    x = np.zeros((rows, WALK_N), np.float32)
    for r in range(max(rows - 1, 1)):
        f = 80.0 * (75.0 ** (r / max(rows - 1, 1)))
        x[r] = 0.5 * np.sin(2 * np.pi * f * t + r) + 0.003 * rng.standard_normal(WALK_N)
        if r % 3 == 1:
            x[r] += sum(0.3 / k * np.sin(2 * np.pi * k * f * t) for k in (2, 3, 4))
        if r % 4 == 2:
            x[r] += 0.4 * np.sin(2 * np.pi * 1.26 * f * t)
    return x


def walk_spectrum(torch, rows, seed, dev, x=None):
    """The rfft [rows, 4097] complex64 of ``x`` [rows, 8192] (or of
    :func:`walk_x`), taken on the card."""
    x = walk_x(rows, seed) if x is None else x
    return torch.fft.rfft(torch.from_numpy(np.ascontiguousarray(x)).to(dev), dim=-1)


def walk_special(torch, dev):
    """Rows of a sine's rfft with zeros, NaN, +-inf and neighbours whose
    denominator is (1, -1) on and around the strongest bin (where the walk
    reads them), NaN at bin 1 in one row, inf beside it in another, the
    last row silent."""
    spec = walk_spectrum(torch, 9, 5, dev)
    peak = (spec.abs()[:, 2:-1].argmax(-1) + 2).tolist()
    nan, inf = float("nan"), float("inf")
    edits = [
        [(0, 0.0), (1, 0.0), (2, 0.0)], [(0, complex(nan, 0.0))], [(1, complex(inf, 0.0))],
        [(-1, complex(0.0, -inf)), (1, complex(-inf, 1.0))],
        [(-1, 0.0), (0, complex(0.5, -0.5)), (1, 0.0)], [(-2, 0.0), (-1, complex(50.0, -50.0)), (0, 0.0)],
    ]
    for r, row_edits in enumerate(edits):
        for d, v in row_edits:
            spec[r, peak[r] + d] = v
    spec[6, 1] = complex(nan, 1.0)
    spec[7, 0] = complex(inf, 0.0)
    spec[7, 2] = complex(1.0, nan)
    return spec


def walk_rising(torch, dev):
    """A real spectrum [3, 4097]: alternating signs, magnitudes rising 1.01
    a bin over 300 bins from bin 2 and from bin 40 (each bin's offset (r -
    1) / (r + 1)), the last row silent: at hysteresis -1 the 280-pass cap."""
    spec = np.zeros((3, WALK_N // 2 + 1), np.complex64)
    for r, start in enumerate((2, 40)):
        j = np.arange(start, start + 300)
        spec[r, j] = ((-1.0) ** j) * np.float32(1.01) ** (j - start)
    return torch.from_numpy(spec).to(dev)


def walk_history(torch, rows, seed, dev):
    """Past omegas: -1 sentinels in every other row's first half (the whole
    last row), far values (the median taken) in every third row."""
    rng = np.random.default_rng(seed)
    hist = rng.uniform(2.0, 400.0, (rows, 8)).astype(np.float32)
    hist[::2, :4] = -1.0
    hist[1::3] = rng.uniform(1000.0, 2000.0, (len(hist[1::3]), 8))
    hist[-1] = -1.0
    return torch.from_numpy(hist).to(dev)


def walk_chain(torch, starts, length, ratio, first, dev):
    """Bins [3, 4097] fed directly (see WALK_CHAINS): noise of 1e-12 with
    offsets in [-0.5, 0.5), a chain in each of the first two rows (offset
    0, the bins before it zero; bin 1's offset 0.5), the last row silent."""
    rows, m = len(starts) + 1, WALK_N // 2 + 1
    rng = np.random.default_rng(rows)
    mags = (rng.random((rows, m)) * 1e-12).astype(np.float32)
    offsets = rng.uniform(-0.5, 0.5, (rows, m)).astype(np.float32)
    offsets[:, 1] = 0.5
    for r, start in enumerate(starts):
        v, i = np.float32(first), start
        mags[r, 1:i] = 0.0
        with np.errstate(over="ignore"):
            while (i - start < length) if ratio else np.isfinite(v):
                mags[r, i], offsets[r, i] = v, 0.0
                v = np.float32(v * np.float32(ratio)) if ratio else np.nextafter(np.float32(2 * v), np.float32(np.inf))
                i += 1
        if ratio is None:
            mags[r, i] = np.inf
    mags[-1] = 0.0
    return torch.from_numpy(mags).to(dev), torch.from_numpy(offsets).to(dev)


def bits_equal(torch, a, b) -> bool:
    """Equal bit for bit (NaN payloads and the sign of zero included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def phase_kernel_f(torch, dev, results):
    """Kernel F's four entries against their plain versions on the same
    CUDA tensors, bit for bit: record, passes and history. The spectrum
    entries (the main path: the rfft in, each bin's magnitude and offset
    formed in the kernel) and the bins entries at WALK_ROWS x
    WALK_SETTINGS, host numbers and device scalars, the filtered entries
    over three calls; the spectrum entries on special values, every other
    row of a batch and the 280-pass cap through a real spectrum; the bins
    entries at WALK_CHAINS (the longest chain float32 allows, the 280-pass
    cap). The filtered spectrum entry timed at cfg3b (16 rows x 4094 bins
    of the oscilloscope stream's lookaheads) and one row beside its plain
    version and the bound. Returns the profile's workloads."""
    from signalizer_tpu_torch.kernels import spectral_walk as sw

    worst = {"value_max_abs_err": 0.0, "offset_max_abs_err": 0.0, "history_max_abs_err": 0.0,
             "index_mismatches": 0, "passes_mismatches": 0, "bit_mismatches": 0}

    def both(what, src, thr, hyst, history=None, offsets=None):
        n, ns = counter("spectral_walk.launches"), counter("spectral_walk.spectrum_launches")
        spectrum = offsets is None
        if spectrum and history is None:
            rec, passes = sw.spectral_walk_spectrum(src, WALK_N, thr, hyst)
            want, want_passes = sw.spectral_walk_spectrum_plain(src, WALK_N, thr, hyst)
            hist = want_hist = None
        elif spectrum:
            hist, rec, passes = sw.spectral_walk_filtered_spectrum(src, WALK_N, history, thr, hyst)
            want_hist, want, want_passes = sw.spectral_walk_filtered_spectrum_plain(src, WALK_N, history, thr, hyst)
        elif history is None:
            rec, passes = sw.spectral_walk(src, offsets, WALK_N, thr, hyst)
            want, want_passes = sw.spectral_walk_plain(src, offsets, WALK_N, thr, hyst)
            hist = want_hist = None
        else:
            hist, rec, passes = sw.spectral_walk_filtered(src, offsets, WALK_N, history, thr, hyst)
            want_hist, want, want_passes = sw.spectral_walk_filtered_plain(src, offsets, WALK_N, history, thr, hyst)
        torch.cuda.synchronize()
        require(counter("spectral_walk.launches") == n + 1
                and counter("spectral_walk.spectrum_launches") == ns + int(spectrum),
                f"kernel F {what}: {counter('spectral_walk.launches') - n} launches")
        err = {"value_max_abs_err": nan_err(torch, rec.value, want.value),
               "offset_max_abs_err": nan_err(torch, rec.offset, want.offset),
               "history_max_abs_err": 0.0 if hist is None else nan_err(torch, hist, want_hist),
               "index_mismatches": int((rec.index != want.index).sum()),
               "passes_mismatches": int((passes != want_passes).sum())}
        same = (all(bits_equal(torch, a, b) for a, b in zip(rec, want))
                and torch.equal(passes, want_passes.int()) and (hist is None or bits_equal(torch, hist, want_hist)))
        err["bit_mismatches"] = int(not same)
        for k, v in err.items():
            worst[k] = max(worst[k], v)
        require(same, f"kernel F {what}: differs from its plain version: {err}")
        return rec, passes, hist

    report = {"phase": "kernel_f", "bound": "record, passes and history bit-equal to the plain versions",
              "cases": {}}
    for rows in WALK_ROWS:
        spec = walk_spectrum(torch, rows, rows, dev)
        mags, offsets = spec.abs(), sw._quad_delta(spec)
        for thr, hyst in WALK_SETTINGS:
            for scalars in ("host", "device"):
                t, h = (thr, hyst) if scalars == "host" else (torch.tensor(thr, device=dev),
                                                               torch.tensor(hyst, device=dev))
                what = f"{rows} rows, threshold {thr}, hysteresis {hyst}, {scalars}"
                for entry, src, offs in (("spectrum", spec, None), ("bins", mags, offsets)):
                    _, passes, _ = both(f"{entry}, {what}", src, t, h, offsets=offs)
                    require(int(passes.max()) > 1 and (rows == 1 or int(passes[-1]) == 1),
                            f"kernel F {entry}, {what}: passes {passes.tolist()} (the last row silent)")
                    history = walk_history(torch, rows, 7, dev)
                    for call in range(3):
                        _, _, history = both(f"{entry}, {what}, filtered call {call}", src, t, h, history, offs)
                report["cases"][what] = {"passes_max": int(passes.max())}
    special, rising = walk_special(torch, dev), walk_rising(torch, dev)
    batch = walk_spectrum(torch, 12, 3, dev)
    for thr, hyst in WALK_SETTINGS:
        both(f"special values, threshold {thr}", special, thr, hyst)
        both(f"special values, threshold {thr}, filtered", special, thr, hyst, walk_history(torch, 9, 3, dev))
    both("every other row", batch[::2], 0.1, 0.0, walk_history(torch, 6, 5, dev))
    _, passes, _ = both("pass cap, real spectrum", rising, 0.0, -1.0)
    require(passes.tolist() == [sw.MAX_WALK_ITERATIONS, sw.MAX_WALK_ITERATIONS, 1],
            f"kernel F: the rising spectrum took {passes.tolist()} passes")
    both("pass cap, real spectrum, filtered", rising, 0.0, -1.0, walk_history(torch, 3, 1, dev))
    report["cases"]["spectrum_pass_cap"] = {"passes": passes.tolist()}
    for name, starts, length, ratio, first, hyst, accepted in WALK_CHAINS:
        mags, offsets = walk_chain(torch, starts, length, ratio, first, dev)
        _, passes, _ = both(name, mags, 0.0, hyst, offsets=offsets)
        both(f"{name}, filtered", mags, 0.0, hyst, walk_history(torch, 3, 1, dev), offsets)
        if accepted is not None:
            require(int(passes[0]) == min(accepted + 1, sw.MAX_WALK_ITERATIONS),
                    f"kernel F {name}: {int(passes[0])} passes, {accepted} acceptances expected")
        report["cases"][name] = {"passes": passes.tolist()}

    # timed: cfg3b's 16 lookaheads (the oscilloscope stream's left channels)
    # and one of them, the view's device scalars; bound: the half spectrum
    # read once, the history in and out,
    # the record and the passes written; per bin |X| and the offset (~40 f32
    # operations). The chain's estimate (phase 15): the passes times a
    # pass's device cost, profiled on one row of the rising spectrum (280
    # passes) against its silent row (one pass)
    cap_row, one_row = rising[0:1].contiguous(), rising[2:3].contiguous()
    stream, _ = make_osc_stream()
    timed = {}
    workloads = [("spectral_walk_pass_cap", lambda: sw.spectral_walk_spectrum(cap_row, WALK_N, 0.0, -1.0)),
                 ("spectral_walk_one_pass", lambda: sw.spectral_walk_spectrum(one_row, WALK_N, 0.0, -1.0))]
    thr_t, hyst_t = torch.tensor(0.1, device=dev), torch.tensor(0.0, device=dev)
    for name, rows in (("cfg3b", PAIRS), ("1x4094", 1)):
        spec = walk_spectrum(torch, rows, 0, dev, x=stream[:rows, 0, OSC_HISTORY - WALK_N : OSC_HISTORY])
        history = walk_history(torch, rows, 3, dev)

        def walk(spec=spec, history=history):
            return sw.spectral_walk_filtered_spectrum(spec, WALK_N, history, thr_t, hyst_t)

        passes = int(walk()[2].max())
        m = WALK_N // 2 - 2
        moved = rows * ((m + 3) * 8 + 2 * 8 * 4 + 3 * 4 + 4)
        timed[name] = dict(
            ms=median_ms(torch, walk), passes=passes,
            plain_ms=call_ms(torch, lambda: sw.spectral_walk_filtered_spectrum_plain(spec, WALK_N, history, thr_t,
                                                                                      hyst_t), reps=3),
            **roofline(moved, rows * (m + 3) * 40.0),
        )
        workloads.append((f"spectral_walk_{name}", walk))
    report["timed"] = timed
    report["measured_err"] = worst
    info(report)
    t = timed["cfg3b"]
    results["spectral_walk"] = dict(
        entries=["spectral_walk_filtered_spectrum (main path)", "spectral_walk_spectrum", "spectral_walk_filtered",
                 "spectral_walk"],
        max_abs_err=max(worst["value_max_abs_err"], worst["offset_max_abs_err"], worst["history_max_abs_err"]),
        mismatches=worst["index_mismatches"] + worst["passes_mismatches"] + worst["bit_mismatches"],
        measured_err=worst, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=None, passes_cfg3b=t["passes"],
        one_row_ms=timed["1x4094"]["ms"], one_row_plain_ms=timed["1x4094"]["plain_ms"],
        one_row_passes=timed["1x4094"]["passes"],
        pass_cap_passes=sw.MAX_WALK_ITERATIONS,
    )
    return workloads


@contextlib.contextmanager
def resample_log(calls: list):
    """Record each resample call of the oscilloscope step
    (``views/oscilloscope.py``: the waveform's and the envelope's picks) in
    ``calls`` as (function, rows, start, step, pixels, other arguments,
    output), rows and start cloned on their device (no sync)."""
    from signalizer_tpu_torch.views import oscilloscope as tv

    names = ("sinc_resample", "sinc_resample_with_nearest", "linear_resample", "nearest_resample")
    saved = {name: getattr(tv, name) for name in names}

    def recorder(fn):
        def call(rows, start, step, pixels, *rest):
            out = fn(rows, start, step, pixels, *rest)
            calls.append((fn, rows.clone(), start.clone(), step, pixels, rest, out))
            return out

        return call

    for name, fn in saved.items():
        setattr(tv, name, recorder(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(tv, name, fn)


def trigger_witness(card_calls: list, cpu_calls: list) -> dict:
    """Where a card tick's oscilloscope differs from the CPU's: the window
    start and step of each resample call apart (samples), and the CPU's
    plain resample of its own rows at the card's start and step against the
    card's output, in kernel C's tolerance (1e-5 x max|x|; pass: <= 1)."""
    require(len(card_calls) == len(cpu_calls) > 0, f"witness: {len(card_calls)} and {len(cpu_calls)} resample calls")
    out = {"start_diff": 0.0, "step_diff": 0.0, "replay_err": 0.0}
    for (fn, _, start, step, pixels, rest, got), (_, rows, cpu_start, cpu_step, _, _, _) in zip(card_calls, cpu_calls):
        out["start_diff"] = max(out["start_diff"], float((start.cpu() - cpu_start).abs().max()))
        out["step_diff"] = max(out["step_diff"], abs(step - cpu_step))
        replay = fn(rows, start.cpu(), step, pixels, *rest)
        tol = 1e-5 * max(float(rows.abs().max()), 1e-30)
        for a, b in zip(replay if isinstance(replay, tuple) else (replay,), got if isinstance(got, tuple) else (got,)):
            out["replay_err"] = max(out["replay_err"], float((a - b.cpu()).abs().max()) / tol)
    return out


@contextlib.contextmanager
def plain_walk():
    """Route the oscilloscope step's spectral walk (kernel F's filtered
    spectrum entry) to its plain version: the magnitudes and offsets by
    torch operations, the loop and the median filter, the path each
    SPECTRAL call is held to."""
    from signalizer_tpu_torch.kernels import spectral_walk as sw
    from signalizer_tpu_torch.views import oscilloscope as tv

    tv.spectral_walk_filtered_spectrum = sw.spectral_walk_filtered_spectrum_plain
    try:
        yield
    finally:
        tv.spectral_walk_filtered_spectrum = sw.spectral_walk_filtered_spectrum


@contextlib.contextmanager
def plain_peak_hold():
    """Route the oscilloscope step's envelope-hold trigger (kernel D's
    fused entry, all the step calls for it) to its plain version: the
    plain loop and the torch operations on its fires, the path each
    ENVELOPE_HOLD call is held to."""
    from signalizer_tpu_torch.kernels import peak_hold as ph
    from signalizer_tpu_torch.views import oscilloscope as tv

    tv.envelope_hold_trigger = ph.envelope_hold_trigger_plain
    try:
        yield
    finally:
        tv.envelope_hold_trigger = ph.envelope_hold_trigger


def envelope_hold_calls(torch, dev, calls, launches_out, calls_out):
    """cfg3 with the ENVELOPE_HOLD trigger (16 pairs, 96 kHz, a 1600-sample
    tick): OSC_CALLS calls, each held to the same step with the plain loop
    (every frame field and the fire queue bit-equal), kernel D launched
    once a call; the call timed, under one 60 fps frame."""
    from signalizer_tpu_torch import OscilloscopeProcessor, TriggerMode
    from signalizer_tpu_torch.kernels import peak_hold as ph

    kw = dict(pairs=PAIRS, device=dev, window_samples=OSC_WINDOW,
              **osc_kwargs(trigger_mode=TriggerMode.ENVELOPE_HOLD, trigger_hysteresis=0.3))
    hold, loop = OscilloscopeProcessor.create(**kw), OscilloscopeProcessor.create(**kw)
    found = []
    reset_counters("peak_hold.launches")
    for h in calls:
        frame = hold.process(h, new_samples=OSC_HOP)
        launched = counter("peak_hold.launches")
        with plain_peak_hold():
            want = loop.process(h, new_samples=OSC_HOP)
        count("peak_hold.launches", launched - counter("peak_hold.launches"))
        torch.cuda.synchronize()
        for key in ("waveform", "envelope_min", "envelope_max", "colours", "gain", "trigger_found"):
            require(torch.equal(getattr(frame, key), getattr(want, key)), f"ENVELOPE_HOLD {key} vs the loop")
        require(torch.equal(hold.state.peak_fire_ages, loop.state.peak_fire_ages), "ENVELOPE_HOLD fire queue")
        found.append(int(frame.trigger_found.sum()))
    launches = counter("peak_hold.launches")
    require(launches == OSC_CALLS, f"ENVELOPE_HOLD: kernel D launched {launches} times in {OSC_CALLS} calls")
    launches_out["peak_hold"] = launches_out.get("peak_hold", 0) + launches
    calls_out["peak_hold"] = calls_out.get("peak_hold", 0) + OSC_CALLS
    ms = call_ms(torch, lambda: hold.process(calls[0], new_samples=OSC_HOP))
    with plain_peak_hold():
        loop_ms = call_ms(torch, lambda: loop.process(calls[0], new_samples=OSC_HOP), reps=1)
    require(ms < FRAME_MS, f"ENVELOPE_HOLD cfg3 call takes {ms} ms, over a {FRAME_MS:.1f} ms frame")
    return {"calls": OSC_CALLS, "launches": launches, "pairs_found_per_call": found, "ms_per_call": ms,
            "loop_ms_per_call": loop_ms}, lambda: hold.process(calls[0], new_samples=OSC_HOP)


# ---------------------------------------------------------------------------
# the multi-device pipeline on one card
# ---------------------------------------------------------------------------

PIPE_TICKS = 3
PIPE_FIELDS = ("results", "waveform", "envelope_min", "envelope_max", "correlation")
CFG5_FS = 192_000.0
CFG5_PAIRS = 4
CFG5_T = 128


@contextlib.contextmanager
def plain_spectrum():
    """Route analyze_frames to kernels A and B's plain versions."""
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import spectrum as ts
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm

    kernels = ts.window_fft_mag, ts.display_map
    ts.window_fft_mag, ts.display_map = wfm.window_fft_mag_plain, dm.display_map_plain
    try:
        yield
    finally:
        ts.window_fft_mag, ts.display_map = kernels


def pipe_audio(rng, channels: int, n: int, fs: float) -> np.ndarray:
    """Each pair a sine (its own frequency, both channels) in noise."""
    t = np.arange(n) / fs
    hz = np.repeat(np.geomspace(300.0, 0.2 * fs, channels // 2), 2)[:, None]
    x = 0.5 * np.sin(2 * np.pi * hz * t) + 0.01 * rng.standard_normal((channels, n))
    return x.astype(np.float32)


def phase_pipeline(torch, dev, launches_out, calls_out):
    """ShardedAnalysisPipeline on a one-GPU mesh, fed by push: the fused view
    at cfg5 (bench.py:994-1050: a 4096-point SEPARATE spectrum at 192 kHz,
    LINEAR, a LOGARITHMIC axis of 1024 px; 4 pairs x 128 frames; 1024 px),
    and the spectrum (headline: 16 pairs x 128 frames), spectrogram (cfg4:
    16384 points, T = 512), oscilloscope (cfg3: a 1600-sample tick) and
    vectorscope (cfg2: 256 pairs x 4096, an 800-sample tick)
    views, three ticks each. Each tick's step is held against the same step
    built from the plain versions of its kernels, on the tensors the tick
    uploaded (the vectorscope, which has no kernel, against the pipeline on
    the CPU); launches, ms a tick (host clock to a synchronize) and the
    device's busy share over one profiled tick."""
    from signalizer_tpu_torch import DisplayMode, SpectrumChannels
    from signalizer_tpu_torch.core.constant import make_spectrum_constant
    from signalizer_tpu_torch.kernels import banded_resample as br
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm
    from signalizer_tpu_torch.kernels.oscilloscope import sinc_resample_matrix
    from signalizer_tpu_torch.kernels.vectorscope import init_meter_state
    from signalizer_tpu_torch.parallel import mesh as pm
    from signalizer_tpu_torch.parallel.pipeline import ShardedAnalysisPipeline
    from signalizer_tpu_torch.views.oscilloscope import init_oscilloscope_state, make_oscilloscope_constant

    mesh = pm.make_analysis_mesh(1)
    require(mesh == [dev], f"pipeline: the one-GPU mesh is {mesh}")
    rng = np.random.default_rng(2031)
    counters = {"window_fft_mag": "window_fft_mag.launches", "display_map": "display_map.launches",
                "banded_resample": "banded_resample.launches"}
    report = {"phase": "pipeline", "mesh": [str(d) for d in mesh], "ticks": PIPE_TICKS, "views": {}}

    def drive(name, pipe, feed, check, expect):
        """PIPE_TICKS ticks of ``pipe``; each uploaded batch captured for the
        plain step; the kernels' counts from just before each tick to just
        after; then a tick with its synchronizing operations counted (and
        where each comes from), and one under the profiler."""
        captured = {}
        upload = pipe._upload

        def capture(host):
            captured["x"] = upload(host)
            return captured["x"]

        pipe._upload = capture
        launched = dict.fromkeys(counters, 0)
        ms = []
        for i in range(PIPE_TICKS):
            feed(i)
            reset_counters(*counters.values())
            t0 = time.perf_counter()
            out = pipe.tick()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            for k, name in counters.items():
                launched[k] += counter(name)
            require(out is not None, f"pipeline {name}: tick {i} ran no step")
            check(i, out, captured["x"])
        for k, n in launched.items():
            require(n == expect.get(k, 0) * PIPE_TICKS,
                    f"pipeline {name}: {k} launched {n} times in {PIPE_TICKS} ticks, not {expect.get(k, 0)} a tick")
            if n:
                launches_out[k] = launches_out.get(k, 0) + n
                calls_out[k] = calls_out.get(k, 0) + PIPE_TICKS
        feed(PIPE_TICKS)
        with SyncCounter(torch) as sc:
            pipe.tick()
        torch.cuda.synchronize()
        feed(PIPE_TICKS + 1)
        kernels_us, _, _, attempts = profiled(lambda: (pipe.tick(), torch.cuda.synchronize()), 1)
        device_us = sum(kernels_us.values())
        require(device_us > 0, f"pipeline {name}: the profiler saw no device time")
        report["views"][name] = {"launches_per_tick": {k: v / PIPE_TICKS for k, v in launched.items() if v},
                                 "ms_per_tick": ms, "device_us_profiled_tick": device_us,
                                 "busy_share": device_us / 1e3 / statistics.median(ms),
                                 "syncs_per_tick": sc.count, "sync_sites": dict(sc.sites),
                                 "profile_attempts": attempts}
        return report["views"][name]

    # --- fused at cfg5 --------------------------------------------------
    c5 = make_spectrum_constant(device=dev, **headline(sample_rate=CFG5_FS))
    fused = ShardedAnalysisPipeline(c5, pairs=CFG5_PAIRS, mesh=mesh, view="fused", pixels=AXIS_POINTS,
                                    frames_per_tick=CFG5_T)
    plain_step = pm.sharded_fused_step(c5, sinc_resample_matrix(WINDOW, 0.0, WINDOW / AXIS_POINTS, AXIS_POINTS,
                                                                device=dev), mesh, pixels=AXIS_POINTS)
    plain = {"state": pm.init_sharded_state(c5, CFG5_PAIRS, mesh), "v": init_meter_state((CFG5_PAIRS,), device=dev)}
    worst = {"results": 0.0}

    def fused_check(i, out, x):
        with plain_spectrum():
            want = plain_step(plain["state"], plain["v"], x, None)
        plain["state"], plain["v"] = want[5], want[6]
        torch.cuda.synchronize()
        require(tuple(out.results.shape) == (CFG5_PAIRS, CFG5_T, 2, 2, AXIS_POINTS), "cfg5 results shape")
        require(tuple(out.waveform.shape) == (CFG5_PAIRS, CFG5_T, AXIS_POINTS), "cfg5 waveform shape")
        for name, got in zip(PIPE_FIELDS, out[:5]):
            require(bool(torch.isfinite(got).all()), f"cfg5 tick {i}: {name} not finite")
        err = float((out.results - want[0]).abs().max())
        require(err <= 2e-4, f"cfg5 tick {i}: results vs plain {err} > 2e-4")
        worst["results"] = max(worst["results"], err)
        for k, name in ((1, "waveform"), (2, "envelope_min"), (3, "envelope_max"), (4, "correlation")):
            require(torch.equal(out[k], want[k]), f"cfg5 tick {i}: {name} vs plain")
        for a, b in zip(fused.meter_state, want[6]):
            require(torch.equal(a, b), f"cfg5 tick {i}: meters vs plain")
        require(abs(float(out.global_peak) - float(want[7])) <= 2e-4, f"cfg5 tick {i}: global peak")

    hop5 = WINDOW * CFG5_T
    fused_report = drive("fused_cfg5", fused,
                         lambda i: fused.push(pipe_audio(rng, 2 * CFG5_PAIRS, hop5, CFG5_FS)),
                         fused_check, {"window_fft_mag": 1, "display_map": 1})
    fused_report["results_max_abs_err_vs_plain"] = worst["results"]
    fused_report["frames_per_s"] = CFG5_PAIRS * CFG5_T / (statistics.median(fused_report["ms_per_tick"]) / 1e3)

    # --- spectrum at the headline geometry -------------------------------
    # (frames a window apart: the batcher holds max(4 W, hop (T + 2))
    # samples, less than the hop (T - 1) + W a batch spans at hop 800, so a
    # hop-800 batch of 128 would lose its first frames)
    c = make_spectrum_constant(device=dev, **headline())
    spec = ShardedAnalysisPipeline(c, pairs=PAIRS, mesh=mesh, view="spectrum", frames_per_tick=T)
    spec_plain = {"state": pm.init_sharded_state(c, PAIRS, mesh)}
    plain_spec_step = pm.sharded_spectrum_step(c, mesh)

    def spec_check(i, out, x):
        with plain_spectrum():
            want, spec_plain["state"], peak = plain_spec_step(spec_plain["state"], x, None)
        err = float((out.results - want).abs().max())
        require(err <= 2e-4, f"spectrum pipeline tick {i}: results vs plain {err} > 2e-4")

    drive("spectrum", spec, lambda i: spec.push(pipe_audio(rng, 2 * PAIRS, WINDOW * T, FS)), spec_check,
          {"window_fft_mag": 1, "display_map": 1})

    # --- spectrogram at cfg4 ------------------------------------------------
    c4 = make_spectrum_constant(device=dev, **headline(window_size=16384, configuration=SpectrumChannels.LEFT,
                                                       display_mode=DisplayMode.COLOUR_SPECTRUM))
    t4 = 512
    sg = ShardedAnalysisPipeline(c4, pairs=1, mesh=mesh, view="spectrogram", frames_per_tick=t4)
    sg_plain = {"state": pm.init_sharded_state(c4, 1, mesh)}
    plain_sg_step = pm.sharded_spectrogram_step(c4, mesh)

    def sg_check(i, out, x):
        with plain_spectrum():
            want, sg_plain["state"] = plain_sg_step(sg_plain["state"], x, sg._colours, sg._ratios, None)
        diff = (out.columns.to(torch.int16) - want.to(torch.int16)).abs()
        require(tuple(out.columns.shape) == (t4, AXIS_POINTS, 4), f"spectrogram pipeline columns {out.columns.shape}")
        require(int(diff.max()) <= 1 and float((diff != 0).float().mean()) <= 1e-3,
                f"spectrogram pipeline tick {i}: columns vs plain differ by {int(diff.max())}")

    drive("spectrogram_cfg4", sg, lambda i: sg.push(pipe_audio(rng, 2, 16384 * t4, FS)), sg_check,
          {"window_fft_mag": 1, "display_map": 1})

    # --- oscilloscope at cfg3 ------------------------------------------------
    oc = make_oscilloscope_constant(device=dev, **osc_kwargs())
    osc = ShardedAnalysisPipeline(pairs=PAIRS, mesh=mesh, view="oscilloscope", osc_constant=oc,
                                  window_samples=OSC_WINDOW, history_samples=OSC_HISTORY)
    osc_plain = {"state": init_oscilloscope_state(oc, PAIRS)}
    plain_osc_step = pm.sharded_oscilloscope_step(oc, mesh, pairs=PAIRS)

    def osc_check(i, out, x):
        with plain_resample():
            new = OSC_HISTORY if i == 0 else OSC_HOP  # what the pipeline saw arrive
            want, osc_plain["state"], level = plain_osc_step(osc_plain["state"], x, OSC_WINDOW, 0.0, new)
        got = out.frame
        scale = float(x.abs().max()) * max(1.0, float(got.gain.max()))
        err = float((got.waveform - want.waveform).abs().max())
        require(err <= 1e-5 * scale, f"oscilloscope pipeline tick {i}: waveform vs plain {err}")
        for key in ("envelope_min", "envelope_max", "trigger_found"):
            require(torch.equal(getattr(got, key), getattr(want, key)), f"oscilloscope pipeline tick {i}: {key}")
        require(bool(got.trigger_found.all()), f"oscilloscope pipeline tick {i}: a pair found no trigger")

    osc.push(pipe_audio(rng, 2 * PAIRS, OSC_HISTORY - OSC_HOP, OSC_FS))
    # two launches a tick: the step takes no envelope oversampling from the
    # pipeline, so the envelope's nearest pick (3 a pixel at 16384 samples
    # over 8192 px) is a launch of its own beside the Lanczos resample
    drive("oscilloscope_cfg3", osc, lambda i: osc.push(pipe_audio(rng, 2 * PAIRS, OSC_HOP, OSC_FS)), osc_check,
          {"banded_resample": 2})

    # --- vectorscope at cfg2, against the CPU ----------------------------------
    streams, vw = 256, 4096
    vs = ShardedAnalysisPipeline(pairs=streams, mesh=mesh, view="vectorscope", history_samples=vw)
    vs_cpu = ShardedAnalysisPipeline(pairs=streams, mesh=["cpu"], view="vectorscope", history_samples=vw)
    vs_audio = {}

    def vs_feed(i):
        vs_audio[i] = pipe_audio(rng, 2 * streams, vw if i == 0 else HOP, FS)
        vs.push(vs_audio[i])
        vs_cpu.push(vs_audio[i])

    def vs_check(i, out, x):
        want = vs_cpu.tick().frame
        got = out.frame
        gain = max(1.0, float(want.gain.abs().max()))
        err = float((got.vertices.cpu() - want.vertices).abs().max())
        require(err <= 2e-6 * gain, f"vectorscope pipeline tick {i}: vertices vs CPU {err}")
        for key in ("balance", "correlation_bars"):
            e = float((getattr(got, key).cpu() - getattr(want, key)).abs().max())
            require(e <= 2e-6, f"vectorscope pipeline tick {i}: {key} vs CPU {e}")

    drive("vectorscope_cfg2", vs, vs_feed, vs_check, {})
    info(report)
    block = pipe_audio(rng, 2 * CFG5_PAIRS, hop5, CFG5_FS)
    return lambda: (fused.push(block), fused.tick())


# ---------------------------------------------------------------------------
# the front ends: the CLI and the editor
# ---------------------------------------------------------------------------

CLI_FILES = 4
CLI_SECONDS = 1.0


def phase_front_ends(torch, dev, launches_out, calls_out):
    """``python -m signalizer_tpu_torch analyze-batch`` on 4 seeded WAV files
    the phase writes (a process of its own), and ``analyze --npz`` on one of
    them in this process (kernels A, B and C counted); then an EditorShell on
    localhost at the factory default preset, one payload of each view and
    the spectrogram PNG over HTTP."""
    import shutil
    import tempfile
    import urllib.request
    from pathlib import Path

    from scipy.io import wavfile

    from signalizer_tpu_torch.__main__ import main as cli
    from signalizer_tpu_torch.editor import EditorShell
    from signalizer_tpu_torch.engine import SignalizerEngine
    from signalizer_tpu_torch.kernels import banded_resample as br
    from signalizer_tpu_torch.kernels import display_map as dm
    from signalizer_tpu_torch.kernels import window_fft_mag as wfm
    from signalizer_tpu_torch.session import AnalysisSession
    from signalizer_tpu_torch.stream.audio_stream import Playhead

    report = {"phase": "front_ends"}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        rng = np.random.default_rng(2032)
        n = int(FS * CLI_SECONDS)
        files = []
        for i in range(CLI_FILES):
            t = np.arange(n) / FS
            x = np.stack([0.5 * np.sin(2 * np.pi * 440.0 * (i + 1) * t), 0.3 * np.sin(2 * np.pi * 660.0 * (i + 1) * t)])
            files.append(work / f"in{i}.wav")
            wavfile.write(files[-1], int(FS), (x + 0.01 * rng.standard_normal(x.shape)).T.astype(np.float32))
        repo = Path(__file__).resolve().parent
        env = dict(__import__("os").environ, PYTHONPATH=str(repo))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "signalizer_tpu_torch", "analyze-batch", *map(str, files),
                               "--out", str(work / "batch")], capture_output=True, text=True, env=env, cwd=work,
                              timeout=300)
        batch_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"analyze-batch exited {proc.returncode}: {proc.stderr[-2000:]}")
        # the PNG renders need matplotlib, which a machine may lack: the CLI
        # then writes none and says so
        try:
            import matplotlib  # noqa: F401
            drawn = CLI_FILES
        except ImportError:
            drawn = 0
            require("matplotlib is not installed" in proc.stderr, f"analyze-batch stderr: {proc.stderr[-500:]}")
        renders = sorted(p.name for p in (work / "batch").glob("*.spectrum.png"))
        require(len(renders) == drawn, f"analyze-batch wrote {renders}")
        balances = [ln.split("balance")[-1].strip() for ln in proc.stdout.splitlines() if "balance" in ln]
        require(len(balances) == CLI_FILES, f"analyze-batch printed {proc.stdout}")
        report["analyze_batch"] = {"files": CLI_FILES, "seconds_each": CLI_SECONDS, "wall_s": batch_s,
                                   "balances": balances, "renders": len(renders)}

        reset_counters("window_fft_mag.launches", "display_map.launches", "banded_resample.launches")
        t0 = time.perf_counter()
        require(cli(["analyze", str(files[0]), "--out", str(work / "one"), "--npz"]) == 0, "analyze failed")
        analyze_s = time.perf_counter() - t0
        counts = {"window_fft_mag": counter("window_fft_mag.launches"), "display_map": counter("display_map.launches"),
                  "banded_resample": counter("banded_resample.launches")}
        require(all(v > 0 for v in counts.values()), f"analyze: kernel launches {counts}")
        arrays = np.load(work / "one" / "in0.arrays.npz")
        require(sorted(arrays.files) == ["spectrogram", "spectrum", "vertices", "waveform"], f"npz {arrays.files}")
        pngs = sorted(p.name for p in (work / "one").glob("*.png"))
        require(len(pngs) == (4 if drawn else 0), f"analyze wrote {pngs}")
        for k in ("spectrum", "waveform", "vertices"):
            require(bool(np.isfinite(arrays[k]).all()), f"analyze npz {k} not finite")
        report["analyze"] = {"wall_s": analyze_s, "launches": counts,
                             "arrays": {k: list(arrays[k].shape) for k in arrays.files},
                             "outputs": sorted(p.name for p in (work / "one").iterdir())}
        for k, v in counts.items():
            launches_out[k] = launches_out.get(k, 0) + v
            calls_out[k] = calls_out.get(k, 0) + 1
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # the editor at the factory default preset, on the card
    eng = SignalizerEngine("editor", device=dev)
    eng.editor_settings.refresh_rate_ms = 30.0
    sess = AnalysisSession(eng, axis_points=AXIS_POINTS, pixels=AXIS_POINTS)
    clock = {"t": 0}

    def source(n):
        i = np.arange(clock["t"], clock["t"] + n)
        clock["t"] += n
        x = 0.5 * np.sin(2 * np.pi * SESSION_HZ[0] * i / FS)
        return np.stack([x, 0.7 * x]).astype(np.float32)

    shell = EditorShell(sess, source=source, playhead=Playhead(bpm=120.0, is_playing=True), device=dev)
    shell.start()
    try:
        def get(path):
            with urllib.request.urlopen(shell.url.rstrip("/") + path, timeout=60) as r:
                return r.read()

        deadline = time.time() + 60
        while json.loads(get("/api/state"))["ticks"] < 3 and time.time() < deadline:
            time.sleep(0.05)
        state = json.loads(get("/api/state"))
        require(state["ticks"] >= 3, f"editor: {state['ticks']} ticks in 60 s")
        payloads = {}
        for view in ("spectrum", "oscilloscope", "vectorscope", "spectrogram"):
            t0 = time.perf_counter()
            body = get(f"/api/frame/{view}")
            p = json.loads(body)
            require(p.get("ready"), f"editor: {view} payload not ready")
            payloads[view] = {"bytes": len(body), "ms": (time.perf_counter() - t0) * 1e3}
        spec = json.loads(get("/api/frame/spectrum"))
        require(len(spec["strips"][0]["y"]) == AXIS_POINTS, "editor: spectrum strip width")
        osc = json.loads(get("/api/frame/oscilloscope"))
        require(osc["shape"][-1] == AXIS_POINTS and np.isfinite(np.asarray(osc["waveform"])).all(),
                "editor: oscilloscope payload")
        png = get("/api/spectrogram.png")
        require(png[:8] == b"\x89PNG\r\n\x1a\n", "editor: spectrogram PNG")
        report["editor"] = {"ticks": state["ticks"], "payloads": payloads, "png_bytes": len(png),
                            "diagnostics": state["diagnostics"]}
        require(eng.diagnostics.counters["session.failures"] == 0, "editor: a view failed")
    finally:
        shell.stop()
        sess.close()
        eng.close()
    info(report)


def device_kernels(prof, calls: int, counts=None):
    """Device µs a call by kernel name, and the kernels launched, from a
    ``torch.profiler`` run over ``calls`` calls; ``counts``, where given,
    gets the launches a call by kernel name."""
    from torch.autograd import DeviceType

    kernels_us = {}
    launched = 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # a host op: its kernels are their own events
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            launched += evt.count
            # the port's kernels live in anonymous namespaces (and so may
            # the types of their arguments, later in the name)
            kernel = evt.key.split("(anonymous namespace)::", 1)[-1]
            if kernel != evt.key:
                kernel = kernel.split("<")[0]  # one name per kernel, whatever its template arguments
            kernel = kernel.split("(")[0][:80]
            kernels_us[kernel] = kernels_us.get(kernel, 0.0) + us / calls
            if counts is not None:
                counts[kernel] = counts.get(kernel, 0.0) + evt.count / calls
    return kernels_us, launched


PROFILE_ATTEMPTS = 3


def profiled(run, calls: int, counts=None):
    """``run()`` under ``torch.profiler``: device µs a call by kernel name,
    the kernels launched, what ``run`` returned and the sessions it took
    (``counts`` as for :func:`device_kernels`).
    CUPTI now and then hands a short profiler session no kernel record at
    all; such a session is run again, up to ``PROFILE_ATTEMPTS`` times."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = run()
        if counts is not None:
            counts.clear()
        kernels_us, launched = device_kernels(prof, calls, counts)
        if kernels_us:
            break
    return kernels_us, launched, out, attempt


def phase_profile(torch, workloads, calls: int = 20, calls_of=None, detail=()):
    """Device time per kernel and busy share of each workload's call:
    kernel times from ``torch.profiler`` (CUPTI) over ``calls`` calls, host
    wall time from the same calls run without the profiler (which slows
    the host side). ``calls_of`` names the workloads profiled over fewer
    calls; the workloads in ``detail`` report every kernel, its µs and its
    launches a call, and each of the others in ``detail`` the launches
    that the first lacks or has fewer of."""

    def run(fn, n) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    report = {"phase": "profile", "calls": calls, "calls_of": calls_of or {}}
    for name, fn in workloads:
        n = (calls_of or {}).get(name, calls)
        run(fn, n)  # warm-up
        wall_us = run(fn, n)
        counts = {}
        kernels_us, launched, profiled_wall_us, attempts = profiled(lambda: run(fn, n), n, counts)
        device_us = sum(kernels_us.values())
        require(device_us > 0, f"profile {name}: the profiler saw no device time")
        top = dict(sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8])
        report[name] = {
            "wall_us_per_call": wall_us / n,
            "profiled_wall_us_per_call": profiled_wall_us / n,
            "device_us_per_call": device_us,
            "profile_attempts": attempts,
            "busy_share": device_us * n / wall_us,
            "device_kernels": len(kernels_us),
            "launches_per_call": launched / n,
            "top_kernels_us_per_call": top,
            "own_kernels_us_per_call": {k: kernels_us[k] for k in OWN_DEVICE_FUNCTIONS if k in kernels_us},
        }
        if name in detail:
            report[name]["kernels"] = {k: {"us": kernels_us[k], "launches": counts[k]} for k in kernels_us}
    for name in detail[1:]:
        base, other = report[detail[0]]["kernels"], report[name]["kernels"]
        extra = {}
        for k, v in other.items():
            b = base.get(k, {"us": 0.0, "launches": 0.0})
            if v["launches"] > b["launches"] or v["us"] > b["us"] + 1.0:
                extra[k] = {"launches": v["launches"] - b["launches"], "us": v["us"] - b["us"]}
        report[f"{name}_minus_{detail[0]}"] = {
            "wall_us_per_call": report[name]["wall_us_per_call"] - report[detail[0]]["wall_us_per_call"],
            "device_us_per_call": report[name]["device_us_per_call"] - report[detail[0]]["device_us_per_call"],
            "launches_per_call": report[name]["launches_per_call"] - report[detail[0]]["launches_per_call"],
            "kernels": extra,
        }
    info(report)
    return report


def resample_routes(torch, history):
    """cfg3's Lanczos resample with the nearest pick alone, by both routes:
    the positions formed in kernel C from each pair's start and the step
    (what the oscilloscope step calls), and a position tensor built by
    torch operations and handed to the kernel."""
    from signalizer_tpu_torch.kernels import banded_resample as br
    from signalizer_tpu_torch.kernels import oscilloscope as tk

    a = tk.INTERPOLATION_KERNEL_SIZE
    step = float(np.float32((OSC_WINDOW - 1.0) / (OSC_PIXELS - 1)))
    start = torch.linspace(100.25, OSC_HISTORY - OSC_WINDOW - 1.0, PAIRS, device=history.device)[:, None]
    lo, hi = CLIP["lanczos"](a, OSC_HISTORY)

    def position_tensor():
        pos = br.affine_positions(history, start, step, OSC_PIXELS, lo, hi)
        return br.banded_resample(history, pos.reshape(PAIRS, OSC_PIXELS), a=a, kind="lanczos", with_nearest=True)

    return [
        ("resample_formed_in_kernel",
         lambda: tk.sinc_resample_with_nearest(history, start, step, OSC_PIXELS, a)),
        ("resample_position_tensor", position_tensor),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU", file=sys.stderr)
        return 1
    import signalizer_tpu_torch  # noqa: F401 — fails here when run outside the repo

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_device(torch)
    phase_build()
    results = {}
    c, mags = phase_kernel_a(torch, dev, results)
    phase_kernel_b(torch, dev, c, mags, results)
    decay_db_calls = phase_kernel_b_entries(torch, dev, c, mags, results)
    del mags
    launches, calls = {}, {}
    proc, x, tick = phase_slice(torch, dev, launches, calls)
    halves = phase_halves_slice(torch, dev, proc, x, tick, launches, calls)
    phase_kernel_c(torch, dev, results)
    hold_workloads = phase_kernel_d(torch, dev, results)
    colour_workloads = phase_kernel_e(torch, dev, results)
    walk_workloads = phase_kernel_f(torch, dev, results)
    osc, history, hold_call, colour_call, spectral_call = phase_osc_slice(torch, dev, launches, calls)
    scope, scope_x = phase_vectorscope(torch, dev)
    cfg4_step, spectrogram_tick, windows_copy, colormap_redraw = phase_spectrogram(torch, dev, results, launches, calls)
    resonator_workloads = phase_resonator(torch, dev, launches, calls, results)
    phase_kernel_values(torch, dev, results)
    phase_workloads = phase_kernel_g(torch, dev, results, launches, calls)
    long_rows = phase_kernel_a_long(torch, dev, results, launches, calls)
    live_tick, live_close = phase_live(torch, dev, launches, calls)
    session_tick, peak_trigger_tick, coloured_tick, cycles_tick, rsnt_tick, session_close = phase_session(
        torch, dev, launches, calls)
    pipeline_tick = phase_pipeline(torch, dev, launches, calls)
    phase_front_ends(torch, dev, launches, calls)
    profile = phase_profile(torch, [
        ("t128", lambda: proc.process(x)),
        ("t1", lambda: proc.process(tick)),
        ("halves_t128", halves),
        ("osc_cfg3", lambda: osc.process(history, new_samples=OSC_HOP)),
        ("osc_envelope_hold", hold_call),
        *hold_workloads,
        ("osc_cfg3_colour", colour_call),
        *colour_workloads,
        ("osc_cfg3b", spectral_call),
        *walk_workloads,
        *resample_routes(torch, history),
        ("vectorscope_cfg2", lambda: scope.process(scope_x)),
        ("spectrogram_cfg4", cfg4_step),
        ("colormap_redraw", colormap_redraw),
        ("spectrogram_pull", spectrogram_tick),
        ("ring_windows_copy", windows_copy),
        *resonator_workloads,
        *phase_workloads,
        *decay_db_calls,
        *long_rows,
        ("live_tick", live_tick),
        ("session_tick", session_tick),
        ("session_tick_peak_trigger", peak_trigger_tick),
        ("session_tick_coloured", coloured_tick),
        ("session_tick_cycles", cycles_tick),
        ("session_tick_rsnt", rsnt_tick),
        ("pipeline_cfg5_tick", pipeline_tick),
    ], calls_of={"pipeline_cfg5_tick": 3},
        detail=("session_tick", "session_tick_peak_trigger", "session_tick_coloured", "session_tick_cycles"))
    live_close()
    session_close()
    # device time per launch on the main path: one launch per profiled call
    # (the two-pass form: its two kernels)
    def own_us(path, name, fns=None):
        own = profile[path]["own_kernels_us_per_call"]
        fns = DEVICE_FUNCTIONS[name] if fns is None else fns
        require(all(fn in own for fn in fns), f"profile {path}: no device time for {fns}")
        return sum(own[fn] for fn in fns)

    for name, path in (("window_fft_mag", "t128"), ("display_map", "t128"), ("banded_resample", "osc_cfg3"),
                       ("display_remap", "halves_t128"), ("display_decay_db", "halves_t128"),
                       ("window_fft_mag_cluster", "window_fft_mag_cluster_t16"),
                       ("window_fft_mag_long", "spectrum_n262144"), ("peak_hold", "osc_envelope_hold"),
                       ("colour_track", "osc_cfg3_colour"), ("spectral_walk", "osc_cfg3b"),
                       ("resonator_scan", "resonator_backlog_t16"), ("colormap", "colormap_redraw")):
        results[name]["profile_us"] = own_us(path, name)
    results["colormap"]["profile_us_cfg4"] = own_us("spectrogram_cfg4", "colormap")
    # kernel G's device functions by the call's T: the mapping pass at T =
    # 128, the tick kernel at T = 1, the walk pass and the mapping pass at cfg4
    g_map, g_walk, g_tick = DEVICE_FUNCTIONS["phase_decay_db"]
    results["phase_decay_db"]["profile_us"] = own_us("phase_t128", "phase_decay_db", (g_map,))
    # kernel D's two entries alone, at cfg3's tick and at 16 x 8192
    results["peak_hold"]["profile_us_alone"] = {name: own_us(name, "peak_hold") for name, _ in hold_workloads}
    # the ENVELOPE_HOLD trigger's cost in the step and the session tick:
    # launches, device and host time a call beside the same without it
    trigger = {}
    for name in ("osc_cfg3", "osc_envelope_hold", "session_tick", "session_tick_peak_trigger"):
        row = profile[name]
        trigger[name] = {"launches_per_call": row["launches_per_call"], "device_us_per_call": row["device_us_per_call"],
                         "wall_us_per_call": row["wall_us_per_call"], "busy_share": row["busy_share"],
                         "peak_hold_us": row["own_kernels_us_per_call"].get("peak_hold_kernel", 0.0)}
    for name, base in (("osc_envelope_hold", "osc_cfg3"), ("session_tick_peak_trigger", "session_tick")):
        trigger[f"{name}_minus_{base}"] = {k: trigger[name][k] - trigger[base][k] for k in trigger[name]}
    info({"phase": "trigger_profile", **trigger})
    # the colour track's cost in the step and the session tick, likewise;
    # kernel E alone (the fused entry and the split) at cfg3
    results["colour_track"]["profile_us_alone"] = {name: own_us(name, "colour_track") for name, _ in colour_workloads}
    results["colour_track"]["session_tick_profile_us"] = own_us("session_tick_coloured", "colour_track")
    colour = {}
    for name in ("osc_cfg3", "osc_cfg3_colour", "session_tick", "session_tick_coloured"):
        row = profile[name]
        colour[name] = {"launches_per_call": row["launches_per_call"], "device_us_per_call": row["device_us_per_call"],
                        "wall_us_per_call": row["wall_us_per_call"], "busy_share": row["busy_share"],
                        "colour_track_us": row["own_kernels_us_per_call"].get("colour_track_kernel", 0.0)}
    for name, base in (("osc_cfg3_colour", "osc_cfg3"), ("session_tick_coloured", "session_tick")):
        colour[f"{name}_minus_{base}"] = {k: colour[name][k] - colour[base][k] for k in colour[name]}
    info({"phase": "colour_profile", **colour})
    # the spectral walk's cost in the step and the session tick, likewise;
    # kernel F alone at cfg3b and on one row
    results["spectral_walk"]["profile_us_alone"] = {name: own_us(name, "spectral_walk") for name, _ in walk_workloads}
    walk_row = results["spectral_walk"]
    walk_row["pass_us"] = (walk_row["profile_us_alone"]["spectral_walk_pass_cap"]
                           - walk_row["profile_us_alone"]["spectral_walk_one_pass"]) / (walk_row["pass_cap_passes"] - 1)
    walk_row["chain_estimate_us"] = walk_row["passes_cfg3b"] * walk_row["pass_us"]
    walk_row["one_row_chain_estimate_us"] = walk_row["one_row_passes"] * walk_row["pass_us"]
    results["spectral_walk"]["session_tick_profile_us"] = own_us("session_tick_cycles", "spectral_walk")
    walk = {}
    for name in ("osc_cfg3", "osc_cfg3b", "session_tick", "session_tick_cycles"):
        row = profile[name]
        walk[name] = {"launches_per_call": row["launches_per_call"], "device_us_per_call": row["device_us_per_call"],
                      "wall_us_per_call": row["wall_us_per_call"], "busy_share": row["busy_share"],
                      "spectral_walk_us": row["own_kernels_us_per_call"].get("spectral_walk_kernel", 0.0)}
    for name, base in (("osc_cfg3b", "osc_cfg3"), ("session_tick_cycles", "session_tick")):
        walk[f"{name}_minus_{base}"] = {k: walk[name][k] - walk[base][k] for k in walk[name]}
    info({"phase": "spectral_profile", **walk})
    # the two tails' calls: launches, device and host time a call, kernels
    # G and H in them and alone
    results["phase_decay_db"]["profile_us_alone"] = own_us("phase_decay_db_t128", "phase_decay_db", (g_map,))
    results["phase_decay_db"]["profile_us_t1"] = own_us("phase_t1", "phase_decay_db", (g_tick,))
    results["phase_decay_db"]["profile_us_cfg4"] = own_us("phase_cfg4", "phase_decay_db", (g_walk, g_map))
    results["phase_values"]["profile_us"] = own_us("phase_t128", "phase_values")
    results["phase_values"]["profile_us_t1"] = own_us("phase_t1", "phase_values")
    results["phase_values"]["profile_us_cfg4"] = own_us("phase_cfg4", "phase_values")
    results["resonator_scan"]["profile_us_alone"] = own_us("resonator_scan_backlog", "resonator_scan")
    results["resonator_scan"]["profile_us_tick"] = own_us("resonator_tick", "resonator_scan")
    results["resonator_scan"]["session_tick_profile_us"] = own_us("session_tick_rsnt", "resonator_scan")
    tails = {}
    for name in ("phase_t128", "phase_t1", "phase_cfg4", "resonator_tick", "resonator_backlog_t16",
                 "resonator_phase_backlog_t16", "session_tick", "session_tick_rsnt"):
        row = profile[name]
        tails[name] = {"launches_per_call": row["launches_per_call"], "device_us_per_call": row["device_us_per_call"],
                       "wall_us_per_call": row["wall_us_per_call"], "busy_share": row["busy_share"],
                       "phase_decay_db_us": sum(row["own_kernels_us_per_call"].get(fn, 0.0)
                                                for fn in DEVICE_FUNCTIONS["phase_decay_db"]),
                       "phase_values_us": row["own_kernels_us_per_call"].get("phase_values_kernel", 0.0),
                       "resonator_scan_us": row["own_kernels_us_per_call"].get("resonator_scan_kernel", 0.0),
                       "top_kernels_us_per_call": row["top_kernels_us_per_call"]}
    require(tails["phase_t128"]["launches_per_call"] <= 5, f"PHASE T=128 call: {tails['phase_t128']['launches_per_call']} launches")
    require(tails["resonator_backlog_t16"]["launches_per_call"] <= 25,
            f"cfg6 backlog: {tails['resonator_backlog_t16']['launches_per_call']} launches")
    require(tails["resonator_tick"]["launches_per_call"] <= 12,
            f"cfg6 tick: {tails['resonator_tick']['launches_per_call']} launches")
    info({"phase": "tail_profile", **tails})
    # the cluster form with 2, 4 and 8 blocks a row and the two-pass kernels
    # on the same rows (through their C entries), and the live tick's 16 rows
    cluster = results["window_fft_mag_cluster"]
    cluster["profile_us_by_cluster_size"] = {
        size: own_us(f"cluster_s{size}_t16", "window_fft_mag_cluster") for size in (2, 4, 8)
    }
    cluster["two_pass_profile_us_same_rows"] = own_us("window_fft_mag_two_pass_t16", "window_fft_mag_long")
    cluster["live_tick_profile_us"] = own_us("live_tick", "window_fft_mag_cluster")
    # the two-pass form at its longest rows, and decay-and-dB at T = 1 and cfg4
    for n in ("n1048576", "n2097152"):
        results["window_fft_mag_long"][n]["profile_us"] = own_us(f"two_pass_{n}", "window_fft_mag_long")
    # (T = 1 is one group of frames: no fold pass)
    results["display_decay_db"]["profile_us_t1"] = own_us("decay_db_t1", "display_decay_db",
                                                          ("display_decay_db_kernel",))
    results["display_decay_db"]["profile_us_cfg4"] = own_us("decay_db_cfg4", "display_decay_db")
    # launches: counted while the main paths were driven (the comparisons
    # with the plain versions are not in it); per call: over those calls
    kernels = [
        dict(
            name=name, **meta, launches=launches[name],
            launches_per_call=launches[name] / calls[name], **results[name],
        )
        for name, meta in KERNELS.items()
    ]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} was not launched on its main path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
