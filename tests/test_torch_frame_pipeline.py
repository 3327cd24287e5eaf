"""The port's FramePipeline against the JAX package's on the CPU, and its
event logic (harvest what is ready, block on the oldest step under
backpressure) with stand-in events. The same seeded numpy frames go through
both pipelines; a step is a windowed magnitude spectrum and a running
count, so outputs agree to float32 rounding (within 1e-5 of each frame's
peak: two FFT libraries) and the states exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalizer_tpu.stream.frame_pipeline import FramePipeline as JaxPipeline
from signalizer_tpu_torch.stream import FramePipeline
from signalizer_tpu_torch.stream import frame_pipeline as tfp


def _frames(n, length=512, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(length).astype(np.float32) for _ in range(n)]


def _torch_step(state, frame):
    return torch.fft.rfft(frame * torch.hann_window(frame.shape[-1], periodic=False)).abs(), state + 1


@jax.jit
def _jax_step(state, frame):
    w = jnp.asarray(np.hanning(512).astype(np.float32))
    return jnp.abs(jnp.fft.rfft(frame * w)), state + 1


@pytest.mark.parametrize("depth", [1, 3, 32])
def test_pipeline_equals_the_jax_package(depth):
    frames = _frames(12, seed=depth)
    ours = FramePipeline(_torch_step, torch.zeros((), dtype=torch.int32), depth=depth, device="cpu")
    theirs = JaxPipeline(_jax_step, jnp.zeros((), jnp.int32), depth=depth)
    got = list(ours.run(frames))
    want = list(theirs.run(frames))
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * float(np.abs(w).max()))
    assert int(ours.state) == int(theirs.state) == 12
    assert (ours.frames_submitted, ours.frames_completed) == (theirs.frames_submitted, theirs.frames_completed)
    assert ours.in_flight == theirs.in_flight == 0


def test_cpu_results_are_ready_at_once():
    """On the CPU a step has finished when it returns: each submit hands
    its own output back, nothing stays in flight."""
    pipe = FramePipeline(_torch_step, torch.zeros(()), depth=4, device="cpu")
    for i, f in enumerate(_frames(5)):
        done = pipe.submit(f)
        assert len(done) == 1 and pipe.in_flight == 0
        torch.testing.assert_close(done[0], _torch_step(0, torch.from_numpy(f))[0], rtol=0, atol=0)
    assert pipe.drain() == []


class _Event:
    """Stand-in for ``torch.cuda.Event``: completes when told to, or when
    synchronized on."""

    made = []

    def __init__(self):
        self.done = False
        self.synced = 0
        _Event.made.append(self)

    def record(self):
        pass

    def query(self):
        return self.done

    def synchronize(self):
        self.synced += 1
        self.done = True


def test_events_gate_harvest_and_backpressure(monkeypatch):
    """With steps that have not completed, ``submit`` hands nothing back
    until more than ``depth`` are in flight, then synchronizes on the
    oldest only; ``harvest`` returns the leading run of completed steps in
    order; ``drain`` finishes the rest."""
    _Event.made = []
    monkeypatch.setattr(tfp.torch.cuda, "Event", _Event)
    pipe = FramePipeline(lambda s, f: (f.sum(), s), None, depth=2, device="cpu")
    pipe.device = torch.device("cuda")  # take the event path; frames stay on the CPU
    monkeypatch.setattr(pipe, "_to_device", torch.as_tensor)
    frames = [np.full(4, float(i), np.float32) for i in range(6)]
    assert pipe.submit(frames[0]) == [] and pipe.submit(frames[1]) == []
    done = pipe.submit(frames[2])  # three in flight > depth 2: block on the oldest
    assert [float(d) for d in done] == [0.0] and [e.synced for e in _Event.made] == [1, 0, 0]
    _Event.made[2].done = True  # a later step completed first: not harvested out of order
    assert pipe.harvest() == [] and pipe.in_flight == 2
    _Event.made[1].done = True
    assert [float(d) for d in pipe.harvest()] == [4.0, 8.0]
    pipe.submit(frames[3])
    pipe.submit(frames[4])
    assert [float(d) for d in pipe.drain(timeout_s=0.0)] == [12.0, 16.0]
    assert pipe.frames_submitted == pipe.frames_completed == 5


def test_depth_must_be_positive():
    with pytest.raises(ValueError):
        FramePipeline(_torch_step, depth=0, device="cpu")
