"""The traced run's arithmetic on a made-up timeline: busy and idle time,
what the host did in each gap, the kernels' names."""

import pytest

from portbench import trace as tracing


def timeline():
    device = [("void (anonymous namespace)::window_fft_mag_kernel<12>(float const*, int)", 1.0, 3.0),
              ("void display_map_kernel(float*)", 3.0, 4.0),
              ("Memcpy DtoH (Device -> Pinned)", 6.0, 7.0),
              ("void display_map_kernel(float*)", 6.5, 7.5)]
    host = [("call", 0.0, 0.6), ("wait", 0.6, 5.5), ("call", 5.5, 6.0)]
    return tracing.Trace(device=device, host=host, window=(0.0, 8.0))


def test_busy_and_gaps():
    t = timeline()
    assert t.busy_s() == pytest.approx(2.0 + 1.0 + 1.5)
    assert t.idle_gaps() == [(0.0, 1.0), (4.0, 6.0), (7.5, 8.0)]
    assert [e[0] for e in t.device_to_host()] == ["Memcpy DtoH (Device -> Pinned)"]
    assert len(t.kernels()) == 3


def test_breakdown_names_ops_and_host_activity():
    b = timeline().breakdown()
    assert sorted(b["device_ops"]) == [["Memcpy DtoH", 1.0], ["display_map_kernel", 2.0],
                                       ["window_fft_mag_kernel", 2.0]]
    assert dict(b["idle_gaps"]) == {"call": 1.0, "wait": 2.0, "host": 0.5}


def test_short_names():
    assert tracing.short_name("void at::native::(anonymous namespace)::foo<float, 4>(at::Tensor)") == "foo"
    assert tracing.short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
