"""``spectrum_phase16``: the Spectrum view in its Phase channel
configuration at the north-star geometry, 16 stereo pairs in one
``SpectrumProcessor`` (the program's public entry). Sizes and sources are in
``spectrum_phase16.json`` beside this file; the session, the least work of
each stage and the check are :class:`portbench.phase_views.PhaseBatch`'s."""

from portbench.phase_views import PhaseBatch
from portbench.spectrum_views import constant_kwargs

SESSION = PhaseBatch


def build(view: dict, pairs: int, device):
    from signalizer_tpu_torch import SpectrumProcessor

    return SpectrumProcessor.create(pairs=pairs, device=device, **constant_kwargs(view))
