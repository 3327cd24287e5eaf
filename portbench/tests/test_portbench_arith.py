"""The least work of each stage, from shapes: the headline's kernel bounds
as the program's earlier chip runs stated them at 128 frames a pair
(kernel A 30.07 us, kernel B 20.20 us), twice that but for B's state and
tables at the cell's 256; kernel B 6.3 us at the spectrogram's 512
frames."""

import json

import pytest
import torch

from portbench import peaks
from portbench.harness import Bench, load_module


def session_of(cell, device="cpu"):
    bench = Bench()
    paths = bench.files(bench.cell(cell))
    cfg, traffic = (json.loads(paths[k].read_text()) for k in ("config", "traffic"))
    mod = load_module(paths["session"])
    traffic["spans"] = 1
    traffic["stream_hops"] = 520
    return mod.SESSION(cfg, traffic, torch.device(device), 1, program=object())


def test_headline_kernel_bounds():
    work = session_of("spectrum_sep16.batch256").work()
    assert peaks.least_seconds(work["window_fft_mag"]) * 1e6 == pytest.approx(60.12, abs=0.005)
    assert peaks.least_seconds(work["display_map"]) * 1e6 == pytest.approx(40.24, abs=0.005)
    assert peaks.bound_by(work["window_fft_mag"]) == peaks.bound_by(work["display_map"]) == "bytes"
    # the call: 26.6 MB of audio, 67.1 MB of display values, the state twice
    assert work["step"]["bytes"] == 16 * 2 * (255 * 800 + 4096) * 4 + 16 * 256 * 2 * 2 * 1024 * 4 + 2 * 16 * 2 * 2 * 1024 * 4
    assert peaks.least_seconds(work["step"]) * 1e6 == pytest.approx(28.14, abs=0.05)


def test_spectrogram_kernel_bounds():
    work = session_of("spectrogram_16k.redraw512").work()
    assert peaks.least_seconds(work["display_map"]) * 1e6 == pytest.approx(6.3, abs=0.05)
    # one channel of 512 frames of 16384 read, 512 rows of 8193 magnitudes written
    assert work["window_fft_mag"]["bytes"] == 4 * (512 * 16384 + 16384 + 2 * 16384 + 512 * 8193)
    assert peaks.bound_by(work["step"]) == "pcie"
    assert work["step"]["pcie_bytes"] == 512 * 1024 * 4


def test_least_seconds_takes_the_slowest_resource():
    assert peaks.least_seconds({"bytes": 3.35e12}) == pytest.approx(1.0)
    assert peaks.least_seconds({"bytes": 1.0, "flops": 67e12}) == pytest.approx(1.0)
    assert peaks.least_seconds({"pcie_bytes": 64e9, "flops": 1.0}) == pytest.approx(1.0)
    assert peaks.bound_by({"bytes": 1.0, "flops": 1e9}) == "operations"
