"""The benchmark's files are found by name and agree with BENCHMARK.json."""

import json
import re

import pytest

from portbench import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
WORKLOADS = {w["name"]: w for w in SPEC["workloads"]}
METRICS = harness.metric_modules()
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert harness.NAME_RE.match(entry["name"]) and LINE.match(entry["source"]) and LINE.match(entry["why"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    data = harness.load("configs", entry["name"])
    assert data["reduced"] == entry["reduced"] and all(harness.NAME_RE.match(k) for k in entry["reduced"])


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_file(name):
    entry, data = WORKLOADS[name], harness.load("workloads", name)
    assert harness.NAME_RE.match(name) and LINE.match(entry["why"]) and entry["why"] == data["why"]
    assert (entry["config"], entry["traffic"], entry["chips"]) == (data["config"], data["traffic"], data["chips"])
    harness.load("configs", data["config"])
    harness.load("traffic", data["traffic"])
    assert (harness.BENCH / "entries" / f"{data['entry']}.py").exists()
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for metric, unit in data["end_to_end"].items():
        assert e2e[metric]["unit"] == unit and name in e2e[metric].get("workloads", [name])
    assert set(data["limits"]) and all(v > 0 for v in data["limits"].values())


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_names_and_units(metric):
    assert harness.NAME_RE.match(metric["name"]) and harness.UNIT_RE.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in harness.SOURCES
    assert all(w in WORKLOADS for w in metric.get("workloads", []))


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_file(metric):
    mod = METRICS[metric["name"]]
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.BETTER, mod.MOVES) == (
        metric["layer"], metric["unit"], metric["source"], metric["better"], metric["moves"])
    assert callable(mod.read)
    for w in metric["workloads"]:  # the cell reports the end-to-end metric that this one moves
        assert metric["moves"] in harness.load("workloads", w)["end_to_end"]


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_cell_reads_its_per_layer_metrics_from_the_spec(name):
    """A run reports the per-layer metrics that BENCHMARK.json lists for its
    cell, and those of a metric without a list that moves one of its metrics."""
    e2e = harness.load("workloads", name)["end_to_end"]
    want = {m["name"] for m in SPEC["per_layer"] if name in m["workloads"]}
    assert {m["name"] for m in harness.per_layer_for(name, e2e)} == want
    unlisted = {"name": "x", "moves": next(m for m in e2e if m != "setup_s")}
    assert harness.per_layer_for(name, e2e, SPEC["per_layer"] + [unlisted])[-1] is unlisted


def test_every_metric_file_is_listed():
    assert set(METRICS) == {m["name"] for m in SPEC["per_layer"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for name in WORKLOADS:
        e2e = harness.load("workloads", name)["end_to_end"]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(name in m["workloads"] for m in SPEC["per_layer"])
