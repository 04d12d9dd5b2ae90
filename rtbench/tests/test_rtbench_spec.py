"""The benchmark as data: configurations, traffic mixes and metrics found
by name, and a new one added in a copy by new files and entries alone."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from rtbench import generator, spec

ROOT = Path(__file__).resolve().parents[2]


def test_every_cell_finds_its_files():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        conf = spec.config(bench, w["config"])
        assert conf["name"] == w["config"]
        for k in ("width", "height", "procedural_sky_shape"):
            assert k in conf["render"]
        assert generator.load_traffic(w["traffic"])["loop"] == "closed"
        e2e = [m["name"] for m in spec.metrics_of(bench, "end_to_end",
                                                   w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(bench, "per_layer", w["name"])
        assert set(spec.limits(w["name"])) == {
            "frame_rmse", "frame_px_off_pct", "state_gap",
            "state_flags_apart"}


def test_unknown_names_are_refused():
    bench = spec.load_benchmark()
    with pytest.raises(KeyError):
        spec.cell(bench, "no_such.cell")
    with pytest.raises(KeyError):
        spec.config(bench, "no_such_config")
    with pytest.raises(FileNotFoundError):
        generator.load_traffic("no_such_traffic")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        spec.limits("no_such.cell")


def test_a_new_cell_by_new_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and a cell; nothing there before is edited, and the
    harness finds each by name."""
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "rtbench/configs/island_720p.json")
                      .read_text())
    conf = {**conf, "name": "island_640",
            "render": {**conf["render"], "width": 640, "height": 480}}
    (tmp_path / "rtbench/configs/island_640.json").write_text(
        json.dumps(conf))
    fly = json.loads((ROOT / "rtbench/traffic/fly.json").read_text())
    (tmp_path / "rtbench/traffic/dusk_fly.json").write_text(json.dumps(
        {**fly, "start_hour": [17.0, 19.0]}))
    shutil.copy(tmp_path / "rtbench/limits/island_720p.fly.json",
                tmp_path / "rtbench/limits/island_640.dusk_fly.json")
    (tmp_path / "rtbench/metrics/frames_traced.py").write_text(
        "def read(trace, run):\n    return trace.frames or None\n")
    bench["configs"].append({**bench["configs"][0], "name": "island_640",
                             "file": "rtbench/configs/island_640.json"})
    bench["workloads"].append({"name": "island_640.dusk_fly",
                               "config": "island_640",
                               "traffic": "dusk_fly", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "fps",
                               "workloads": ["island_640.dusk_fly"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from rtbench import spec, generator, trace\n"
        "b = spec.load_benchmark()\n"
        "w = spec.cell(b, 'island_640.dusk_fly')\n"
        "c = spec.config(b, w['config'])\n"
        "f = generator.Flight(generator.load_traffic(w['traffic']), 3)\n"
        "names = [m['name'] for m in spec.metrics_of(b, 'per_layer', "
        "w['name'])]\n"
        "old = [m['name'] for m in spec.metrics_of(b, 'per_layer', "
        "'island_720p.fly')]\n"
        "r = spec.reader('frames_traced')(trace.Trace([], [], 7), {})\n"
        "assert spec.limits(w['name'])['state_flags_apart'] == 0\n"
        "print(json.dumps([spec.__file__, c['render']['width'], "
        "f.start.hour, f.start.cam_preset, names, old, r]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, check=True)
    path, width, hour, preset, names, old, r = json.loads(out.stdout)
    assert path.startswith(str(tmp_path))
    assert width == 640 and 17.0 <= hour < 19.0 and preset in (0, 1)
    assert "frames_traced" in names and "frames_traced" not in old
    assert r == 7
