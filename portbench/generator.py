"""The one generator of the benchmark's audio: seeded stereo streams made on
the device in a few large calls.

Each pair carries one sine on both channels (the right one phase-shifted)
at a frequency drawn log-uniformly between ``f_lo_hz`` and ``f_hi_hz``,
plus independent white noise ``noise_below_tone_db`` under the sine's
power; the last ``silent_pairs`` pairs are digital silence, and
``silent_hops`` hops in the middle of the stream are silent on every pair.
The parameters come from a traffic file's ``audio`` object. The same seed
gives the same samples; every seed gives the same sizes, so the seed moves
the data and never the work.
"""

from __future__ import annotations

import math

import torch

AUDIO_KEYS = ("tone_dbfs", "noise_below_tone_db", "f_lo_hz", "f_hi_hz", "silent_pairs", "silent_hops")


def stereo_stream(audio: dict, pairs: int, length: int, sample_rate: float, hop: int, seed: int,
                  device) -> torch.Tensor:
    """[pairs, 2, length] float32 on ``device`` from ``seed``."""
    missing = [k for k in AUDIO_KEYS if k not in audio]
    if missing:
        raise ValueError(f"traffic audio lacks {missing}")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    f64 = dict(dtype=torch.float64, device=device)
    lo, hi = float(audio["f_lo_hz"]), float(audio["f_hi_hz"])
    freqs = lo * (hi / lo) ** torch.rand(pairs, generator=g, **f64)
    phase = 2.0 * math.pi * torch.rand(pairs, 1, 1, generator=g, **f64)
    right = torch.tensor([0.0, 0.3], **f64)[None, :, None]  # the right channel's phase shift
    amp = 10.0 ** (float(audio["tone_dbfs"]) / 20.0)
    noise_std = amp / math.sqrt(2.0) * 10.0 ** (-float(audio["noise_below_tone_db"]) / 20.0)
    n = torch.arange(length, **f64)
    out = torch.empty((pairs, 2, length), dtype=torch.float32, device=device)
    for p in range(pairs):  # one pair at a time keeps the float64 temporaries small
        tone = amp * torch.sin(2.0 * math.pi * freqs[p] / sample_rate * n + phase[p] + right)
        out[p] = tone.float()
    out += torch.randn((pairs, 2, length), generator=g, dtype=torch.float32, device=device) * noise_std
    silent = int(audio["silent_pairs"])
    if 0 < silent < pairs:
        out[pairs - silent:] = 0.0
    gap = int(audio["silent_hops"]) * hop
    if gap:
        start = (length - gap) // 2
        out[..., start:start + gap] = 0.0
    return out
