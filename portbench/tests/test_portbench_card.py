"""Each cell on the card, as a short run: correct, with every metric the
cell reports. These take the ``cuda`` fixture and skip without a card; run
them on the card with ``python -m pytest portbench/tests/test_portbench_card.py``."""

import pytest

from portbench.harness import Bench, run_cell

CELLS = [w["name"] for w in Bench().spec["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_short_run_on_the_card_is_correct(cuda, cell, trace):
    bench = Bench()
    r = run_cell(cell, 2**32 + 17, 1.0, trace, cuda, bench=bench)
    assert r["correct"], r["checks"]
    want = {m["name"] for m in bench.metrics_for(cell, "per_layer" if trace else "end_to_end")}
    assert set(r["metrics"]) == want
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert len(r["breakdown"]["device_ops"]) <= 10
