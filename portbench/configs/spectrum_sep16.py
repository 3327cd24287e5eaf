"""``spectrum_sep16``: the Spectrum view at the north-star geometry, 16
stereo pairs in one ``SpectrumProcessor`` (the program's public entry).
Sizes and sources are in ``spectrum_sep16.json`` beside this file; the
session, the least work of each stage and the check are
:class:`portbench.spectrum_views.SpectrumBatch`'s."""

from portbench.spectrum_views import SpectrumBatch, constant_kwargs

SESSION = SpectrumBatch


def build(view: dict, pairs: int, device):
    from signalizer_tpu_torch import SpectrumProcessor

    return SpectrumProcessor.create(pairs=pairs, device=device, **constant_kwargs(view))
