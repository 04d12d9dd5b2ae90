"""The benchmark as data: BENCHMARK.json at the root of the checkout, and
the files it names, found by name.

A cell (`workloads` entry) names a configuration, whose file is given in
`configs`, and a traffic mix, rtbench/traffic/<traffic>.json. The limits of
the cell's `correct` are rtbench/limits/<cell>.json. A per-layer
metric's reader is rtbench/metrics/<name>.py, with a function
`read(trace, run)` → a number, or None where the trace holds nothing to
read. A later change adds a configuration, a traffic mix, a metric or a
cell by adding files and entries; none of these lookups changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
METRICS_DIR = HERE / "metrics"
LIMITS_DIR = HERE / "limits"


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration `name`: its file, as BENCHMARK.json names it."""
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, section: str, workload: str) -> list:
    """The metrics of `section` ("end_to_end" or "per_layer") that cell
    `workload` reports: those without a workloads list, and those whose
    list names it."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


def reader(name: str, root: Path = METRICS_DIR):
    """The `read` function of per-layer metric `name`
    (root/<name>.py)."""
    path = root / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader {path} for metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"rtbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def limits(workload: str, root: Path = LIMITS_DIR) -> dict:
    """The limits of cell `workload`'s `correct` (root/<workload>.json)."""
    path = root / f"{workload}.json"
    if not path.exists():
        raise FileNotFoundError(f"no limits {path} for cell {workload!r}")
    return {k: v for k, v in json.loads(path.read_text()).items()
            if k != "about"}
