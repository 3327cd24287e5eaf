"""The PyTorch port's device ring functions against the JAX package on the
CPU: bit-equal, for every count of valid samples and every frame axis."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.stream import device_ring as jr
from signalizer_tpu_torch.stream import device_ring as tr


@pytest.mark.parametrize("n_max", [1, 7, 64, 200])
def test_ring_update_bit_equal_for_every_n_valid(n_max):
    """The last H samples of ring ++ new[..., :n_valid], for every n_valid
    in 0..n_max, new blocks shorter and longer than the ring included."""
    rng = np.random.default_rng(n_max)
    ring = rng.standard_normal((2, 2, 96)).astype(np.float32)
    new = rng.standard_normal((2, 2, n_max)).astype(np.float32)
    for n_valid in range(n_max + 1):
        got = tr.ring_update(torch.from_numpy(ring), torch.from_numpy(new), n_valid)
        want = np.asarray(jr.ring_update(jnp.asarray(ring), jnp.asarray(new), n_valid))
        assert got.shape == (2, 2, 96)
        assert np.array_equal(got.numpy(), want), n_valid
    with pytest.raises(ValueError):
        tr.ring_update(torch.from_numpy(ring), torch.from_numpy(new), n_max + 1)


@pytest.mark.parametrize("frame_axis", [-2, -3, 0])
@pytest.mark.parametrize("window,hop,t_max", [(32, 8, 5), (32, 32, 3), (16, 40, 3), (96, 1, 1), (8, 3, 30)])
def test_extract_frames_bit_equal(window, hop, t_max, frame_axis):
    rng = np.random.default_rng(window + hop)
    ring = rng.standard_normal((3, 2, 128)).astype(np.float32)
    got = tr.extract_frames(torch.from_numpy(ring), window, hop, t_max, frame_axis=frame_axis)
    want = np.asarray(jr.extract_frames(jnp.asarray(ring), window, hop, t_max, frame_axis=frame_axis))
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.contiguous().numpy(), want)


def test_extract_frames_refuses_a_short_ring():
    ring = torch.zeros(2, 100)
    with pytest.raises(ValueError, match="too short"):
        tr.extract_frames(ring, 32, 8, 10)
    tr.extract_frames(ring, 32, 8, 9)  # 8 * 8 + 32 = 96 fits


def test_ingest_window_bit_equal():
    rng = np.random.default_rng(5)
    ring = rng.standard_normal((2, 2, 256)).astype(np.float32)
    t_ring, j_ring = torch.from_numpy(ring), jnp.asarray(ring)
    for n in (48, 1, 100):
        new = rng.standard_normal((2, 2, n)).astype(np.float32)
        t_ring, t_win = tr.ingest_window(t_ring, torch.from_numpy(new), window=64)
        j_ring, j_win = jr.ingest_window(j_ring, jnp.asarray(new), window=64)
        assert np.array_equal(t_ring.numpy(), np.asarray(j_ring))
        assert np.array_equal(t_win.numpy(), np.asarray(j_win))


def test_init_ring_takes_a_device():
    src = tr.DeviceFrameSource((2, 2), 64, 16)
    ring = src.init_ring("cpu")
    assert ring.shape == (2, 2, src.history) and ring.device.type == "cpu" and not ring.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            src.init_ring()
