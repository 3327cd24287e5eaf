"""The seeded audio: the same seed the same samples, another seed others,
the sizes of every seed alike."""

import json

import torch

from portbench.generator import stereo_stream
from portbench.harness import HERE

AUDIO = json.loads((HERE / "traffic" / "batch256.json").read_text())["audio"]


def make(seed, audio=AUDIO, pairs=4, length=5000):
    return stereo_stream(audio, pairs, length, 48000.0, 100, seed, torch.device("cpu"))


def test_same_seed_same_samples():
    big = 2**31 + 977  # seeds may pass 32 signed bits
    assert torch.equal(make(big), make(big))


def test_seeds_differ_and_sizes_do_not():
    a, b = make(1), make(2)
    assert a.shape == b.shape == (4, 2, 5000) and a.dtype == torch.float32
    assert not torch.equal(a[:-1], b[:-1])


def test_silence_and_levels():
    x = make(7)
    assert torch.count_nonzero(x[-1]) == 0  # the silent pair
    peak = x[:-1].abs().amax().item()
    assert 0.45 < peak < 0.56  # a -6 dBFS sine plus noise 40 dB under it
    gap = make(7, dict(AUDIO, silent_pairs=0, silent_hops=10))
    assert torch.count_nonzero(gap[..., 2000:3000]) == 0 and torch.count_nonzero(gap[..., :2000]) > 0
