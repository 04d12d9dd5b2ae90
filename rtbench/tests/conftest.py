"""The record driver's cells, which BENCHMARK.json does not hold while the
program's copy of a batch to host memory spreads their runs past the
bounds (PERF.md): `record_root` is a root whose BENCHMARK.json holds them,
for the tests that drive them."""

import json
import shutil
from pathlib import Path

import pytest

from rtbench import spec

ROOT = Path(__file__).resolve().parents[2]
RECORD8 = "island_720p.record8"
DP4 = "island_1080p.record_dp4"
RECORD_CELLS = [
    {"name": RECORD8, "config": "island_720p", "traffic": "record8",
     "chips": 1, "why": "record on one card at 1280x720"},
    {"name": DP4, "config": "island_1080p", "traffic": "record_dp4",
     "chips": 4, "why": "record --dp 4 at 1920x1080"}]
# the per-layer metrics whose readers take the record driver's values
SHARED = ("host_call_ms", "readback_ms", "torch_ops_ms",
          "raytrace_roofline_pct", "fxaa_roofline_pct", "device_idle_pct",
          "frame_mfu")
GATHER = {"name": "gather_ms", "unit": "ms", "better": "lower",
          "source": "device_trace", "layer": "frame-DP gather",
          "moves": "fps", "workloads": [DP4]}


@pytest.fixture
def record_root(tmp_path):
    """A root whose BENCHMARK.json holds the record cells, the shared
    per-layer metrics listing them, and gather_ms, besides the
    benchmark's own."""
    bench = spec.load_benchmark()
    bench["workloads"] += RECORD_CELLS
    bench["per_layer"].append(GATHER)
    for m in bench["per_layer"]:
        if m["name"] in SHARED:
            m["workloads"] = m["workloads"] + [RECORD8, DP4]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(ROOT / "rtbench" / "configs",
                    tmp_path / "rtbench" / "configs")
    return tmp_path
