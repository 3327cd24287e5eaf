"""BENCHMARK.json against its contract, and every file a cell needs found
by name."""

import json
import re
import shutil

import pytest

from portbench import harness
from portbench.harness import Bench, load_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = Bench().spec


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len({c["name"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in SPEC["workloads"]] + [c["why"] for c in SPEC["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    by_name = {m["name"]: m for m in SPEC["end_to_end"]}
    assert by_name["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_per_layer_entries():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells


def test_per_layer_metrics_move_what_their_cells_report():
    bench = Bench()
    for m in SPEC["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            assert m["moves"] in {e["name"] for e in bench.metrics_for(cell, "end_to_end")}, (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    bench = Bench()
    paths = bench.files(bench.cell(cell))
    cfg = json.loads(paths["config"].read_text())
    entry = bench.config(bench.cell(cell)["config"])
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert entry["file"].startswith("portbench/")
    assert hasattr(load_module(paths["session"]), "SESSION")
    limits = json.loads(paths["limits"].read_text())
    assert all(v >= 0 for v in limits.values())


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = Bench()
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.metrics_for(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics_for(w["name"], "per_layer")


@pytest.mark.parametrize("missing", ["traffic", "metric"])
def test_a_workload_naming_a_missing_file_is_refused(tmp_path, missing):
    shutil.copytree(harness.HERE, tmp_path / "portbench")
    spec = json.loads(json.dumps(SPEC))
    w = dict(spec["workloads"][0], name="spectrum_sep16.nowhere")
    if missing == "traffic":
        w["traffic"] = "nowhere"
    else:
        spec["per_layer"].append({"name": "nowhere.us", "workloads": [w["name"]], "unit": "us", "better": "lower", "source": "host_clock",
                                  "layer": "processor", "moves": "latency_p95_ms"})
    spec["workloads"].append(w)
    shutil.copy(tmp_path / "portbench" / "limits" / f"{SPEC['workloads'][0]['name']}.json",
                tmp_path / "portbench" / "limits" / f"{w['name']}.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tmp_path)
    bench.files(bench.cell(SPEC["workloads"][1]["name"]))  # a cell whose files are all there
    with pytest.raises(FileNotFoundError, match="nowhere"):
        bench.files(bench.cell(w["name"]))
