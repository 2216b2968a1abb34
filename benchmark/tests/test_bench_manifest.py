"""Every cell, configuration, driver and metric of ``BENCHMARK.json`` loads
by name, and the manifest keeps to the shape its contract asks."""

import json
import re

import pytest

from benchmark.harness import manifest

BENCH = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads(cfg):
    data = manifest.config(cfg["name"])
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"] == []
    assert data["hidden_size"] == 768 and data["num_layers"] == 12 and data["num_heads"] == 12


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = manifest.workload(cell)
    assert wl["config"] == entry["config"] and wl["traffic"] == entry["traffic"]
    assert wl["chips"] == entry["chips"] == 1
    drv = manifest.driver(wl["driver"])
    assert hasattr(drv.Driver, "check") and set(drv.Driver.E2E) <= {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in manifest.end_to_end_metrics(cell, BENCH)}
    assert "setup_s" in e2e and e2e - {"setup_s"} and e2e <= {"setup_s", *drv.Driver.E2E}
    assert manifest.per_layer_metrics(cell, BENCH)
    assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_loads(metric):
    mod = manifest.metric(metric["name"])
    assert callable(mod.read)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for cell in metric["workloads"]:
        assert metric["moves"] in {m["name"] for m in manifest.end_to_end_metrics(cell, BENCH)}


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    assert all(re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_a_per_layer_metric_and_pairs_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for cell in CELLS:
        assert manifest.per_layer_metrics(cell, BENCH)
