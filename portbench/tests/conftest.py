"""Shared fixtures of the benchmark's own tests (``python -m pytest
portbench/tests``). Tests that need the card take the ``cuda`` fixture,
which decides when the test runs, never when the module is imported."""

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the program only on the card")
    return torch.device("cuda")


def shrink_spectrum(cfg, traffic):
    """The headline cell at a size a CPU test holds. The replay horizon stays
    long enough (512 frames) for the slowest line graph's state to forget
    its start far below rounding, at whatever call the window ends."""
    cfg["pairs"] = 4
    cfg["view"].update(window_size=256, axis_points=64)
    traffic.update(frames_per_call=8, hop=64, spans=3, warmup_calls=3, checked_calls=2, horizon_frames=512)


def shrink_spectrogram(cfg, traffic):
    """The spectrogram cell at a size a CPU test holds."""
    cfg["view"].update(window_size=512, axis_points=64)
    cfg["image_width"] = 16
    traffic.update(stream_hops=64, warmup_calls=2, checked_calls=2, horizon_frames=512)
    traffic["audio"]["silent_hops"] = 4


SHRINK = {"spectrum_sep16.batch256": shrink_spectrum, "spectrogram_16k.redraw512": shrink_spectrogram}


@pytest.fixture
def shrink():
    """Per workload, the function that cuts its configuration and traffic
    to a CPU test's size (``run_cell``'s ``overrides``)."""
    return SHRINK
