"""Factory preset corpus.

The reference ships 20 ``.sgn`` presets (ref: Make/Skeleton/presets/ —
default.main plus per-view roles like analytical.spectrum,
beats.oscilloscope, polar.vectorscope) and loads ``default.main`` at
plugin construction (ref: PluginProcessor.cpp:83-101). This module
authors the same *roles* natively: each preset is a knob-configuration
function applied to a scratch engine, serialized through the normal
versioned archive path, so every shipped preset is by construction
loadable by the current code.

Per-view presets serialize only that view's parameter subtree — loading
one leaves the other views untouched (tolerant deserialization).

The port's own copy of :mod:`signalizer_tpu.state.factory_presets`, arithmetic and names unchanged;
tests/test_torch_params_state.py holds the two equal.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

from signalizer_tpu_torch.state.serialize import Archive

# packaged factory corpus location
FACTORY_DIR = Path(__file__).resolve().parent.parent / "presets"


def _norm_choice(param, index: int, count: int) -> None:
    param.set_normalized(index / (count - 1) if count > 1 else 0.0)


# --- spectrum roles ---------------------------------------------------------


def _analytical_spectrum(e) -> None:
    """High-resolution log spectrum for analysis: lanczos taps, slow
    second graph, legend on."""
    sc = e.spectrum
    _norm_choice(sc.channel_configuration, 5, 8)  # separate
    _norm_choice(sc.bin_interpolation, 2, 3)  # lanczos
    sc.window_size.set_normalized(0.75)
    sc.lines[1][0].set_normalized(0.5)  # slow LineSecond decay
    sc.show_legend.set_normalized(1.0)
    sc.flood_fill_alpha.set_normalized(0.15)


def _constant_q_spectrum(e) -> None:
    """Resonator bank (constant-Q analogue)."""
    sc = e.spectrum
    _norm_choice(sc.algorithm, 1, 2)  # resonator
    _norm_choice(sc.view_scaling, 1, 2)  # log
    sc.free_q.set_normalized(0.0)


def _impulse_spectrum(e) -> None:
    """Short-window transient view: linear scale, fast decay."""
    sc = e.spectrum
    sc.window_size.set_normalized(1024.0 / 48_000.0)  # short (linear range)
    _norm_choice(sc.view_scaling, 0, 2)  # linear
    sc.lines[0][0].set_normalized(0.02)
    sc.flood_fill_alpha.set_normalized(0.4)


def _nautical_spectrum(e) -> None:
    """Stylized deep-blue theme."""
    sc = e.spectrum
    sc.background_colour.set_rgba((0.0, 0.02, 0.08, 1.0))
    sc.grid_colour.set_rgba((0.2, 0.4, 0.6, 1.0))
    sc.lines[0][1].set_rgba((0.2, 0.9, 1.0, 1.0))
    sc.lines[0][2].set_rgba((0.1, 0.5, 0.9, 1.0))
    stops = [(0.0, 0.02, 0.08), (0.0, 0.1, 0.3), (0.0, 0.3, 0.6),
             (0.1, 0.6, 0.9), (0.6, 0.9, 1.0)]
    for cv, rgb in zip(sc.spec_colours, stops):
        cv.set_rgba((*rgb, 1.0))


def _spectrogram_spectrum(e) -> None:
    """Colour-spectrum display with a fast blob cadence."""
    sc = e.spectrum
    _norm_choice(sc.display_mode, 1, 2)  # colour spectrum
    sc.blob_size.set_normalized(0.35)
    sc.frame_update_smoothing.set_normalized(0.6)


# --- oscilloscope roles -----------------------------------------------------


def _init_oscilloscope(e) -> None:
    """Reset-to-sane: no trigger, lanczos, 20 ms window."""
    oc = e.oscilloscope
    _norm_choice(oc.trigger_mode, 0, 5)
    _norm_choice(oc.sub_sample_interpolation, 3, 4)
    oc.window_size.set_normalized(0.4)


def _beats_oscilloscope(e) -> None:
    """Window follows the playhead tempo (1 bar)."""
    oc = e.oscilloscope
    _norm_choice(oc.time_mode, 2, 3)  # beats
    oc.window_size.set_normalized(1.0)  # 1 bar
    _norm_choice(oc.trigger_mode, 2, 5)  # window sync


def _cycles_oscilloscope(e) -> None:
    """Window locked to detected cycles, spectral trigger."""
    oc = e.oscilloscope
    _norm_choice(oc.time_mode, 1, 3)  # cycles
    _norm_choice(oc.trigger_mode, 1, 5)  # spectral
    oc.window_size.set_normalized(0.4)  # ~4 cycles


def _coloured_oscilloscope(e) -> None:
    """Spectral-energy colouring on."""
    oc = e.oscilloscope
    _norm_choice(oc.channel_colouring, 1, 2)
    # full energy-colour weight, like the reference corpus role
    # (coloured.oscilloscope.sgn carries FColBlend 1.0)
    oc.frequency_colouring_blend.set_normalized(1.0)
    oc.colour_smoothing.set_normalized(0.5)


def _free_oscilloscope(e) -> None:
    """Free-running scroll, no trigger, both channels overlaid."""
    oc = e.oscilloscope
    _norm_choice(oc.trigger_mode, 0, 5)
    oc.overlay_channels.set_normalized(1.0)
    oc.window_size.set_normalized(0.6)


def _impulse_oscilloscope(e) -> None:
    """Zero-crossing trigger armed above a threshold — transients."""
    oc = e.oscilloscope
    _norm_choice(oc.trigger_mode, 4, 5)  # zero crossing
    oc.trigger_threshold.set_normalized(0.25 / 4.0)  # amplitude 0.25 of the (0,4) range
    oc.window_size.set_normalized(0.2)


def _peak_trigger_oscilloscope(e) -> None:
    """Envelope-hold (peak) triggering with hysteresis."""
    oc = e.oscilloscope
    _norm_choice(oc.trigger_mode, 3, 5)  # envelope hold
    oc.trigger_threshold.set_normalized(0.1 / 4.0)  # amplitude 0.1
    oc.trigger_hysteresis.set_normalized(0.3)


def _sub_investigation_oscilloscope(e) -> None:
    """Long window + custom low-frequency trigger lock."""
    oc = e.oscilloscope
    oc.window_size.set_normalized(0.9)
    _norm_choice(oc.trigger_mode, 1, 5)  # spectral
    oc.trigger_on_custom_frequency.set_normalized(1.0)
    oc.custom_trigger_frequency.set_normalized((40.0 - 5.0) / 47_995.0)  # 40 Hz
    _norm_choice(oc.auto_gain, 1, 3)  # rms
    oc.envelope_window.set_normalized(0.8)


def _sync_oscilloscope(e) -> None:
    """Transport-synchronized window scroll."""
    oc = e.oscilloscope
    _norm_choice(oc.trigger_mode, 2, 5)  # window
    oc.window_size.set_normalized(0.5)


# --- vectorscope roles ------------------------------------------------------


def _clean_vectorscope(e) -> None:
    vc = e.vectorscope
    _norm_choice(vc.operational_mode, 0, 2)
    vc.fade_older_points.set_normalized(1.0)
    vc.interconnect_samples.set_normalized(0.0)
    _norm_choice(vc.auto_gain, 0, 3)


def _standard_vectorscope(e) -> None:
    vc = e.vectorscope
    _norm_choice(vc.operational_mode, 0, 2)
    _norm_choice(vc.auto_gain, 2, 3)  # peak decay
    vc.interconnect_samples.set_normalized(1.0)


def _polar_vectorscope(e) -> None:
    vc = e.vectorscope
    _norm_choice(vc.operational_mode, 1, 2)  # polar
    vc.scale_polar_mode_to_fill.set_normalized(1.0)
    _norm_choice(vc.auto_gain, 1, 3)  # rms


def _pointcloud_vectorscope(e) -> None:
    vc = e.vectorscope
    vc.interconnect_samples.set_normalized(0.0)
    vc.fade_older_points.set_normalized(1.0)
    vc.primitive_size.set_normalized(0.3)


def _oscilloscope_vectorscope(e) -> None:
    """Connected-line XY trace (oscilloscope-style vectorscope)."""
    vc = e.vectorscope
    vc.interconnect_samples.set_normalized(1.0)
    vc.fade_older_points.set_normalized(0.0)
    vc.wave_z_rotation.set_normalized(45.0 / 360.0)


def _default_main(e) -> None:
    """Construction defaults (the role of default.main.sgn)."""


# name -> (configure, view subtree or None for the whole engine)
FACTORY_PRESETS: Dict[str, tuple] = {
    "default.main": (_default_main, None),
    "analytical.spectrum": (_analytical_spectrum, "Spectrum"),
    "constantQ.spectrum": (_constant_q_spectrum, "Spectrum"),
    "impulse.spectrum": (_impulse_spectrum, "Spectrum"),
    "nautical.spectrum": (_nautical_spectrum, "Spectrum"),
    "spectrogram.spectrum": (_spectrogram_spectrum, "Spectrum"),
    "init.oscilloscope": (_init_oscilloscope, "Oscilloscope"),
    "beats.oscilloscope": (_beats_oscilloscope, "Oscilloscope"),
    "cycles.oscilloscope": (_cycles_oscilloscope, "Oscilloscope"),
    "coloured.oscilloscope": (_coloured_oscilloscope, "Oscilloscope"),
    "free.oscilloscope": (_free_oscilloscope, "Oscilloscope"),
    "impulse.oscilloscope": (_impulse_oscilloscope, "Oscilloscope"),
    "peak trigger.oscilloscope": (_peak_trigger_oscilloscope, "Oscilloscope"),
    "sub investigation.oscilloscope": (_sub_investigation_oscilloscope, "Oscilloscope"),
    "sync.oscilloscope": (_sync_oscilloscope, "Oscilloscope"),
    "clean.vectorscope": (_clean_vectorscope, "Vectorscope"),
    "standard.vectorscope": (_standard_vectorscope, "Vectorscope"),
    "polar.vectorscope": (_polar_vectorscope, "Vectorscope"),
    "pointcloud.vectorscope": (_pointcloud_vectorscope, "Vectorscope"),
    "oscilloscope.vectorscope": (_oscilloscope_vectorscope, "Vectorscope"),
}


def _make_archive(configure: Callable, view: Optional[str]) -> Archive:
    from signalizer_tpu_torch.engine import SignalizerEngine

    # author from CONSTRUCTION defaults: loading the shipped default.main
    # here would freeze a previous corpus's (possibly stale) normalized
    # values into the regenerated one
    # authoring touches no device: the engine's processors are never built
    engine = SignalizerEngine("preset-author", load_default_preset=False, device="cpu")
    try:
        configure(engine)
        full = Archive()
        engine.serialize(full)
        if view is None:
            # a factory default is parameters-only: shipping the authoring
            # engine's stream capacity or host-graph identity would clobber
            # every new engine's construction args / node identity — and
            # its Editor subtree would clobber the user's editor settings
            # just like the per-view case below
            full.remove_child("Engine")
            full.remove_child("host-graph")
            full.remove_child("Editor")
            return full
        # per-view preset: keep only that view's parameter subtree —
        # including dropping the Editor subtree, which would otherwise
        # clobber the user's editor settings with authoring defaults
        slim = Archive.from_bytes(full.to_bytes())  # deep copy
        slim.remove_child("Engine")
        slim.remove_child("host-graph")
        slim.remove_child("Editor")
        params = slim.find_child("Parameters")
        for name, _ in list(params.children()):
            if name != view:
                params.remove_child(name)
        return slim
    finally:
        engine.close()


def generate_factory_presets(directory=FACTORY_DIR, *, overwrite: bool = True) -> int:
    """Author the corpus into ``directory``; returns the number written."""
    from signalizer_tpu_torch.state.presets import PresetManager

    manager = PresetManager(directory)
    written = 0
    for name, (configure, view) in FACTORY_PRESETS.items():
        # existence by FILE in the target directory — try_load falls back
        # to the shipped factory corpus and would skip everything
        if not overwrite and manager._path(name).exists():
            continue
        manager.save(name, _make_archive(configure, view))
        written += 1
    return written


if __name__ == "__main__":  # pragma: no cover
    n = generate_factory_presets()
    print(f"wrote {n} presets to {FACTORY_DIR}")
