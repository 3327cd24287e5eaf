"""Inputs shared by the PHASE values kernel's CPU model tests
(``test_torch_kernel_models.py``) and its card tests (``test_torch_cuda.py``):
numpy only, no jax."""

import numpy as np
import torch


def phase_spectra(constant, frames, seed, plant):
    """Complex half spectra [frames, 2, nv] complex64 of noise whose power
    falls with frequency. ``plant``: each bin-max pixel's chunk gets an exact
    tie for its maximum, in one of three forms by pixel (the same complex
    value at two bins of a channel; the left value at one bin and the right
    one's parts swapped at a later bin; both channels' parts swapped at one
    bin), frame 1 is silent and frame 2's right channel is silent."""
    rng = np.random.default_rng(seed)
    nv = constant.n_spectrum_values
    scale = (1.0 / np.sqrt(1.0 + np.arange(nv) / 64.0)).astype(np.float32)
    spec = (rng.standard_normal((frames, 2, nv)) + 1j * rng.standard_normal((frames, 2, nv))) * scale
    spec = spec.astype(np.complex64)
    if plant:
        bp = np.nonzero(~constant.interp_mask.cpu().numpy() & ~constant.single_mask.cpu().numpy())[0]
        lo, ln = constant.chunk_lo.cpu().numpy(), constant.chunk_len.cpu().numpy()
        for n, x in enumerate(bp):
            if ln[x] < 2:
                continue
            i, j = sorted(rng.choice(ln[x], 2, replace=False) + lo[x])
            top = np.complex64(8.0 * (1 + 1j))
            form = n % 3
            if form == 0:
                spec[:, 0, i] = spec[:, 0, j] = top
            elif form == 1:
                spec[:, 0, i] = top * np.complex64(1 + 0.5j)
                spec[:, 1, j] = np.complex64(spec[0, 0, i].imag + 1j * spec[0, 0, i].real)
            else:
                spec[:, 0, i] = top
                spec[:, 1, i] = np.complex64(top.imag + 1j * top.real)
        if frames > 2:
            spec[1] = 0
            spec[2, 1] = 0
    return torch.from_numpy(spec)
