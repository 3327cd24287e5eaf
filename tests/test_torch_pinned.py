"""The session's host-to-device scalars and frames without a pageable copy:
``stream/pinned.py::PinnedUpload`` and the Vectorscope's device scalars, on
the CPU (``tests/test_torch_cuda.py`` holds the card's side: no sync, and
no upload overwritten before its copy finished)."""

import numpy as np
import pytest
import torch

from signalizer_tpu_torch.stream.pinned import PinnedUpload
from signalizer_tpu_torch.views.vectorscope import VectorscopeProcessor


@pytest.mark.parametrize(
    "data",
    [np.float32(800.0), 1600.5, np.arange(3, dtype=np.float64),
     np.arange(24, dtype=np.float32).reshape(2, 3, 4)[:, ::2]],
    ids=["f32_scalar", "host_float", "float64_row", "strided"],
)
def test_pinned_upload_on_the_cpu_gives_the_float32_values(data):
    """Scalars, float64 and strided arrays come back float32 with their
    shape and values, each upload its own tensor."""
    up = PinnedUpload("cpu")
    got = up.upload(data)
    want = np.asarray(data, np.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    again = up.upload(want * 2)
    np.testing.assert_array_equal(got.numpy(), want)  # the first upload is left as it was
    np.testing.assert_array_equal(again.numpy(), want * 2)


def test_vectorscope_scalars_stay_on_the_device_until_a_value_changes():
    """The poles and the user gain are one float32 tensor made once with
    the processor's values and made again when one changes; the step's
    new-samples count is a float32 scalar on the processor's device."""
    p = VectorscopeProcessor(pairs=1, device="cpu", user_gain=0.7)
    (env, stereo, gain, _, _), ns = p._prep_step(4096, 800, meter_w=1024)
    first = p._scalars
    assert [float(v) for v in (env, stereo, gain)] == [float(np.float32(v)) for v in
                                                       (p.envelope_pole, p.stereo_pole, 0.7)]
    assert ns.dtype == torch.float32 and ns.shape == () and float(ns) == 800.0
    p._prep_step(4096, 800, meter_w=1024)
    assert p._scalars is first
    p.stereo_pole = 0.99
    (_, stereo, _, _, _), _ = p._prep_step(4096, 800, meter_w=1024)
    assert p._scalars is not first and float(stereo) == float(np.float32(0.99))
