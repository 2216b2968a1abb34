"""Find a cell's files by name.

``BENCHMARK.json`` at the root names the cells and metrics; each cell's
parameters live in ``workloads/<cell>.json``, its model in
``configs/<config>.json``, its traffic kind in ``drivers/<driver>.py`` and
each per-layer metric in ``metrics/<metric>.py``.  Adding a cell, a
configuration, a driver or a metric is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict[str, Any]:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> Dict[str, Any]:
    """A cell's parameters, with its name."""
    path = BENCH_DIR / "workloads" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no cell {name!r}: {path} does not exist")
    return {"name": name, **_json(path)}


def workload_names() -> List[str]:
    """Every cell with a workload file, listed in ``BENCHMARK.json`` or not."""
    return sorted(p.stem for p in (BENCH_DIR / "workloads").glob("*.json"))


def config(name: str) -> Dict[str, Any]:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise KeyError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return _module(BENCH_DIR / "drivers" / f"{name}.py", f"benchmark_driver_{name}")


def metric(name: str) -> ModuleType:
    """A per-layer metric's reader (its file name is the metric's name)."""
    return _module(BENCH_DIR / "metrics" / f"{name}.py", "benchmark_metric_" + name.replace(".", "_"))


def per_layer_metrics(cell: str, bench: Dict[str, Any] | None = None) -> List[Dict[str, Any]]:
    """The per-layer metrics ``BENCHMARK.json`` asks of ``cell``: those that
    list it, and those that list no cells but move an end-to-end metric the
    cell reports."""
    bench = manifest() if bench is None else bench
    reported = {m["name"] for m in end_to_end_metrics(cell, bench)}
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (cell in cells) if cells is not None else (m["moves"] in reported):
            out.append(m)
    return out


def end_to_end_metrics(cell: str, bench: Dict[str, Any] | None = None) -> List[Dict[str, Any]]:
    bench = manifest() if bench is None else bench
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
