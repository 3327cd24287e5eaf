"""The harness's own pieces: the seeded sample of checked calls, the
window's clock, the metric readers on a made-up record."""

import time

import pytest
import torch

from portbench import harness, trace
from portbench.harness import Keeper, Record, load_module


def test_keeper_samples_from_the_seed_and_keeps_the_last():
    def run(seed):
        k = Keeper(seed, 4)
        buf = torch.zeros(2)
        for i in range(1000):
            k.offer(i, 10 + i, f"out{i}", buf)
        k.keep(*k.last)
        return sorted(k.outputs)

    a = run(2**31 + 5)
    assert a == run(2**31 + 5) and a != run(7)
    assert len(a) == 5 and a[-1] == 1009


def test_the_window_starts_at_its_first_call():
    stop = harness._until(0.05)
    time.sleep(0.1)
    assert not stop(0)  # the clock starts here, not when it was made
    time.sleep(0.06)
    assert stop(1)


def _record(**kw):
    tr = trace.Trace(device=[("window_fft_mag_kernel", 0.0, 0.5), ("display_map_kernel", 0.5, 0.8),
                             ("Memcpy DtoH (Device -> Pinned)", 0.8, 0.9)],
                     host=[("call", 0.0, 0.1)], window=(0.0, 1.0))
    base = dict(calls=10, frames=20480, window_s=2.0, latencies_s=[0.001 * i for i in range(1, 101)],
                host_call_s=[1e-4] * 10, setup_s=9.5,
                work={"window_fft_mag": {"bytes": 3.35e10}, "display_map": {"bytes": 3.35e9},
                      "step": {"pcie_bytes": 64e9 * 0.09}}, trace=tr)
    base.update(kw)
    return Record(**base)


@pytest.mark.parametrize("name,want", [
    ("frames_per_s", 10240.0), ("call.columns_per_s", 10240.0), ("latency_p95_ms", 95.05), ("setup_s", 9.5), ("processor.host_us", 100.0),
    ("processor.launches_per_call", 0.2), ("window_fft_mag_roofline", 20.0), ("display_map_roofline", 3.3333),
    ("step_roofline", 100.0), ("device.idle_pct", 10.0), ("readback.us", 10000.0),
])
def test_metric_readers(name, want):
    mod = load_module(harness.HERE / "metrics" / f"{name}.py")
    assert mod.read(_record()) == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("name", ["processor.launches_per_call", "window_fft_mag_roofline", "display_map_roofline",
                                  "step_roofline", "device.idle_pct", "readback.us"])
def test_a_reader_with_nothing_to_read_returns_none(name):
    mod = load_module(harness.HERE / "metrics" / f"{name}.py")
    assert mod.read(_record(trace=None)) is None


def test_a_redraw_draws_the_configurations_image_width(shrink):
    cell = "spectrogram_16k.redraw512"

    def with_width_in_traffic(cfg, traffic):
        shrink[cell](cfg, traffic)
        traffic["frames_per_call"] = cfg["image_width"]

    with pytest.raises(ValueError, match="image_width"):
        harness.run_cell(cell, 2**31 + 3, 0.1, False, "cpu", overrides=with_width_in_traffic)
