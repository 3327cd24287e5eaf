"""The PHASE cell on the CPU: it finds its files, its check passes the
program and the reference in float32 and fails the control and each fault
planted under the timed path, a float32 argbin flip on a near-tie is not a
fault, its metric readers read, and its reference imports nothing of the
program."""

import json
import math
import subprocess
import sys
import types

import pytest
import torch

from portbench import guard, harness, program_spans
from portbench.harness import Bench, load_module, run_cell
from portbench.phase_views import PhaseBatch, PortPhase, ReferencePhase
from portbench.reference.phase import phase_design

CELL = "spectrum_phase16.batch128"
SEED = 2**31 + 101
NEW_METRICS = ("phase_values.host_us", "phase_decay_db.host_us", "phase_decay_db_roofline")


def shrink(cfg, traffic):
    """The PHASE cell at a size a CPU test holds. The horizon stays 2048
    frames, longer than a CPU run's calls, so every checked call is replayed
    from the first."""
    cfg["pairs"] = 4
    cfg["view"].update(window_size=256, axis_points=64)
    traffic.update(frames_per_call=8, hop=64, spans=3, warmup_calls=3, checked_calls=2)


def _files():
    bench = Bench()
    paths = bench.files(bench.cell(CELL))
    cfg, traffic = (json.loads(paths[k].read_text()) for k in ("config", "traffic"))
    limits = json.loads(paths["limits"].read_text())
    return paths, cfg, traffic, limits


def _run(program=None):
    return run_cell(CELL, SEED, 0.3, False, "cpu", overrides=shrink, program=program)


def _session(cfg, traffic, program=None):
    mod = load_module(_files()[0]["session"])
    return mod.SESSION(cfg, traffic, torch.device("cpu"), SEED, program=program, build=mod.build)


def _calls(session, calls: int) -> dict:
    """``calls`` calls in turn, each kept with its read-back row, as the
    harness keeps them; returns the check's numbers."""
    kept, host = {}, {}
    for k in range(calls):
        out = session.step(session.inputs(k))
        kept[k] = out.clone()
        host[k] = session.readback_source(out).cpu().numpy()
    return session.check(kept, host, session.final_state(), calls)


def _within(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in numbers)


def test_the_cell_finds_its_files_and_reports_its_metrics():
    bench = Bench()
    paths, cfg, traffic, limits = _files()
    assert load_module(paths["session"]).SESSION is PhaseBatch
    assert cfg["view"]["channels"] == "PHASE" and cfg["reduced"] == ["pairs"]
    assert traffic["horizon_frames"] == 2048 and traffic["frames_per_call"] == 128
    assert set(limits) == {"mid_gap", "phase_gap", "state_gap", "phase_state_gap", "binmax_off", "readback_gap"}
    assert limits["readback_gap"] == 0
    per_layer = {m["name"] for m in bench.metrics_for(CELL, "per_layer")}
    assert per_layer == set(NEW_METRICS) | {"processor.host_us", "processor.launches_per_call", "device.idle_pct"}
    assert {m["name"] for m in bench.metrics_for(CELL, "end_to_end")} == {"latency_p95_ms", "setup_s"}
    for name in NEW_METRICS:
        assert paths[f"metric {name}"].is_file()


def test_the_program_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and list(r)[-1] == "checks"


def test_the_reference_in_float32_is_correct():
    _, cfg, traffic, _ = _files()
    shrink(cfg, traffic)
    r = _run(ReferencePhase(phase_design(cfg["view"]), cfg["pairs"], torch.float32, torch.device("cpu")))
    assert r["correct"], r["checks"]


def test_the_control_is_not_correct():
    r = _run("control")
    assert not r["correct"], r["checks"]


class PhaseStateNotCarried:
    """The program with its phase state put back after every call."""

    def __init__(self, port: PortPhase):
        self.port = port

    def __getattr__(self, name):
        return getattr(self.port, name)

    def process(self, frames):
        saved = self.port.state_phase().clone()
        out = self.port.process(frames)
        self.port.state_phase().copy_(saved)
        return out


def _plant(fault: str, monkeypatch):
    """Plant ``fault`` in the program's modules for the test's length."""
    from signalizer_tpu_torch.kernels import phase_decay_db as g
    from signalizer_tpu_torch.kernels import spectrum

    if fault == "mid_half_dropped":
        tail = spectrum.phase_decay_db

        def doubled(constant, state, vals, valid=None):
            return tail(constant, state, vals * torch.tensor([[2.0], [1.0]]), valid)

        monkeypatch.setattr(spectrum, "phase_decay_db", doubled)
    elif fault == "pole_for_phase_pole":
        monkeypatch.setattr(g, "phase_poles", lambda constant: constant.decay_poles[:, None])
    elif fault == "difference_for_sum":
        stage1 = spectrum.window_fft_mag

        def right_negated(constant, frames):
            spec = stage1(constant, frames)
            return torch.stack([spec[..., 0, :], -spec[..., 1, :]], dim=-2)

        monkeypatch.setattr(spectrum, "window_fft_mag", right_negated)
    elif fault == "last_maximum":

        def last(values, constant):
            band = torch.where(constant.band_mask, values[..., constant.band_idx], -torch.inf)
            width = band.shape[-1]
            from_end = torch.argmax(band.flip(-1), dim=-1)  # the first maximum from the end
            bins = constant.band_idx[:, 0] + (width - 1 - from_end)
            return torch.where(constant.single_mask, constant.single_bin.long(), bins)

        monkeypatch.setattr(spectrum, "_binmax_argbin", last)
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("fault", ["mid_half_dropped", "pole_for_phase_pole", "difference_for_sum"])
def test_a_fault_in_the_program_is_not_correct(fault, monkeypatch):
    _plant(fault, monkeypatch)
    r = _run()
    assert not r["correct"], r["checks"]


def test_a_phase_state_left_out_of_the_carry_is_not_correct():
    _, cfg, traffic, _ = _files()
    shrink(cfg, traffic)
    port = _session(cfg, traffic).program
    r = _run(PhaseStateNotCarried(port))
    assert not r["correct"], r["checks"]


def _tied(cfg, traffic, program=None):
    """A session on frames whose left channels are one impulse at each
    frame's centre (a flat magnitude spectrum: every bin of a chunk ties
    exactly, in float32 as in float64) and whose right channels are noise
    well under it; the frames do not overlap. The cell's traffic has no
    exact ties: there the first-maximum rule cannot show."""
    shrink(cfg, traffic)
    w = cfg["view"]["window_size"]
    traffic["hop"] = w
    s = _session(cfg, traffic, program)
    g = torch.Generator().manual_seed(5)
    s.audio[:, 0] = 0.0
    s.audio[:, 0, w // 2::w] = 0.5
    s.audio[:, 1] = 0.002 * torch.randn(s.audio[:, 1].shape, generator=g)
    return s


def test_the_first_maximum_rule_holds_on_exact_ties(monkeypatch):
    """The program passes on exact ties; the last maximum in its place
    fails."""
    _, cfg, traffic, limits = _files()
    assert _within(_calls(_tied(cfg, traffic), 4), limits)
    _, cfg, traffic, limits = _files()
    _plant("last_maximum", monkeypatch)
    numbers = _calls(_tied(cfg, traffic), 4)
    assert not _within(numbers, limits), numbers


def test_a_float32_flip_on_a_near_tie_is_not_a_fault(monkeypatch):
    """At the cell's widths (4096 points, 1024 px), 2 pairs x 128 frames x 3
    calls: the program with its argbin flipped to the second bin wherever a
    chunk's two largest powers agree within 1e-4 relative (a few times the
    float32 FFT's error on a noise bin 40 dB under the tone) passes the
    check at the cell's limits."""
    from signalizer_tpu_torch.kernels import spectrum

    first = spectrum._binmax_argbin
    flips = []

    def flipped(values, constant):
        bins = first(values, constant)
        g = torch.where(constant.band_mask, values[..., constant.band_idx], -torch.inf)
        top = g.topk(2, dim=-1)
        near = (top.values[..., 0] - top.values[..., 1] <= 1e-4 * top.values[..., 0]) & ~constant.single_mask
        near &= ~constant.interp_mask & torch.isfinite(top.values[..., 1]) & (top.values[..., 0] > 0)
        flips.append(int(near.sum()))
        return torch.where(near, constant.band_idx[:, 0] + top.indices[..., 1], bins)

    _, cfg, traffic, limits = _files()
    cfg["pairs"] = 2
    traffic.update(spans=3)
    s = _session(cfg, traffic)
    monkeypatch.setattr(spectrum, "_binmax_argbin", flipped)
    numbers = _calls(s, 3)
    assert sum(flips) >= 3
    assert _within(numbers, limits), numbers
    assert numbers["binmax_off"] > 0  # the flips show, as a share


def _record(trace=None):
    from portbench import trace as tracing

    tr = tracing.Trace(device=[("window_fft_mag_kernel", 0.0, 0.1), ("phase_decay_db_kernel", 0.1, 0.12),
                               ("phase_walk_kernel", 0.12, 0.13), ("Memcpy DtoH (Device -> Pinned)", 0.13, 0.14)],
                       host=[("call", 0.0, 0.1)], window=(0.0, 1.0))
    return harness.Record(calls=10, frames=20480, window_s=2.0, latencies_s=[0.001], host_call_s=[1e-4],
                          setup_s=1.0, work={"phase_decay_db": {"bytes": 3.35e9}}, trace=tr if trace is None else trace)


def test_the_roofline_reads_gs_kernels():
    mod = load_module(harness.HERE / "metrics" / "phase_decay_db_roofline.py")
    # 10 calls of a 1 ms bound against 30 ms of G's kernels
    assert mod.read(_record()) == pytest.approx(10 * 1e-3 / 0.03 * 100.0)
    assert mod.read(harness.Record(**{**_record().__dict__, "trace": None})) is None
    assert mod.read(harness.Record(**{**_record().__dict__, "work": {}})) is None


def _phase_spans():
    us = 1000
    out = []
    for t in (0, 10_000 * us, 20_000 * us):
        root = len(out)
        out.append(("spectrum.process", t, t + 1500 * us, -1))
        out.append(("ring.frames", t + 10 * us, t + 50 * us, root))
        out.append(("kernel.window_fft_mag", t + 50 * us, t + 100 * us, root))
        out.append(("phase.values", t + 100 * us, t + 1100 * us, root))
        out.append(("kernel.phase_decay_db", t + 1100 * us, t + 1160 * us, root))
    return out


@pytest.mark.parametrize("name,want", [("phase_values.host_us", 1000.0), ("phase_decay_db.host_us", 60.0)])
def test_the_span_readers(name, want, monkeypatch):
    mod = load_module(harness.HERE / "metrics" / f"{name}.py")
    monkeypatch.setattr(program_spans, "read_spans", _phase_spans)
    assert mod.read(types.SimpleNamespace(calls=2)) == pytest.approx(want)
    monkeypatch.setattr(program_spans, "read_spans", lambda: None)
    assert mod.read(types.SimpleNamespace(calls=2)) is None
    monkeypatch.setattr(program_spans, "read_spans", lambda: [("spectrum.process", 0, 1, -1)])
    assert mod.read(types.SimpleNamespace(calls=1)) is None  # a program without the span


def test_the_phase_reference_imports_nothing_of_the_program():
    assert guard.reference_imports(harness.HERE / "reference") == []
    code = ("import sys, portbench.reference.phase; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'signalizer_tpu_torch', 'signalizer_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_work_of_kernel_g_at_the_cell():
    """G's least bytes at the cell: values in, display values out, both
    states in and out, the slope map: ~50.9 MB, 15.2 us at 3.35 TB/s."""
    from portbench.peaks import least_seconds

    _, cfg, traffic, _ = _files()
    traffic["spans"] = 1  # one span of audio: the work does not depend on it
    g = _session(cfg, traffic, "control").work()["phase_decay_db"]
    vals, out, states = 16 * 128 * 2 * 1024 * 4, 16 * 128 * 2 * 2 * 1024 * 4, 2 * 16 * 2 * 1024 * 4
    assert g["bytes"] == vals + out + 2 * states + 1024 * 4
    assert least_seconds(g) * 1e6 == pytest.approx(15.18, abs=0.01)
    assert math.isclose(g["flops"], 30.0 * out / 4)
