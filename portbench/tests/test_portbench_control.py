"""The check fails what it must fail. Each cell runs here on the CPU at a
small size, the harness's look for a card skipped and the rest of a run
driven through ``run_cell``: with the program it comes out correct; with the
control (the reference in bfloat16 in the program's place) and with each
fault planted under the timed path, not correct."""

import json

import pytest
import torch

from portbench.harness import Bench, load_module, run_cell
from portbench.spectrum_views import PortSpectrogram, PortSpectrum

SPECTRUM, SPECTROGRAM = "spectrum_sep16.batch256", "spectrogram_16k.redraw512"
SEED = 2**31 + 101


class StateUnchanged:
    """A step that returns its state unchanged."""

    def __init__(self, port, states):
        self.port, self.states = port, states

    def __getattr__(self, name):
        return getattr(self.port, name)

    def _run(self, fn, x):
        saved = [t.clone() for t in self.states(self.port)]
        out = fn(x)
        for t, s in zip(self.states(self.port), saved):
            t.copy_(s)
        return out

    def process(self, frames):
        return self._run(self.port.process, frames)

    def step(self, new):
        ring = self.port.ring
        out = self._run(self.port.step, new)
        self.port.ring = ring
        return out


class Altered:
    """An answer altered where it is produced: one value of every call."""

    def __init__(self, port):
        self.port = port

    def __getattr__(self, name):
        return getattr(self.port, name)

    def process(self, frames):
        out = self.port.process(frames)
        out[-1, 5, 0, 0, 7] += 0.05
        return out

    def step(self, new):
        out = self.port.step(new)
        out[3, 9, 1] ^= 128
        return out


class HalfBatch:
    """Half of the batch left out: the first half's answers stand for all."""

    def __init__(self, port):
        self.port = port

    def __getattr__(self, name):
        return getattr(self.port, name)

    def process(self, frames):
        half = frames.shape[0] // 2
        out = self.port.process(frames)
        out[half:] = out[:half]
        return out

    def step(self, new):
        out = self.port.step(new)
        half = out.shape[0] // 2
        out[:half] = out[half:]
        return out


def _port(cell, shrink):
    """A run's program object, built as the session builds it."""
    bench = Bench()
    paths = bench.files(bench.cell(cell))
    cfg, traffic = (json.loads(paths[k].read_text()) for k in ("config", "traffic"))
    shrink[cell](cfg, traffic)
    mod = load_module(paths["session"])
    return mod.SESSION(cfg, traffic, torch.device("cpu"), SEED, build=mod.build).program


def _run(cell, shrink, program=None):
    return run_cell(cell, SEED, 0.3, False, "cpu", overrides=shrink[cell], program=program)


@pytest.mark.parametrize("cell", [SPECTRUM, SPECTROGRAM])
def test_the_program_is_correct(cell, shrink):
    r = _run(cell, shrink)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", [SPECTRUM, SPECTROGRAM])
def test_the_control_is_not_correct(cell, shrink):
    r = _run(cell, shrink, "control")
    assert not r["correct"], r["checks"]


def _states(port):
    if isinstance(port, PortSpectrum):
        return [port.processor.state.magnitude]
    assert isinstance(port, PortSpectrogram)
    return [port.state.magnitude]


@pytest.mark.parametrize("cell", [SPECTRUM, SPECTROGRAM])
@pytest.mark.parametrize("fault", ["state_unchanged", "altered", "half_batch"])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, shrink):
    port = _port(cell, shrink)
    wrapped = {"state_unchanged": lambda p: StateUnchanged(p, _states), "altered": Altered,
               "half_batch": HalfBatch}[fault](port)
    r = _run(cell, shrink, wrapped)
    assert not r["correct"], r["checks"]
