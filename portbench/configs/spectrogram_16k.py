"""``spectrogram_16k``: the streaming colour spectrogram of BASELINE.json's
configs[3], driven through the program's ``spectrogram_ring_step`` on a
constant from ``make_spectrum_constant``. Sizes and sources are in
``spectrogram_16k.json`` beside this file; the session, the least work of
each stage and the check are
:class:`portbench.spectrum_views.SpectrogramRedraw`'s."""

from portbench.spectrum_views import SpectrogramRedraw, constant_kwargs

SESSION = SpectrogramRedraw


def build(view: dict, device):
    from signalizer_tpu_torch.core.constant import make_spectrum_constant

    return make_spectrum_constant(device=device, **constant_kwargs(view))
