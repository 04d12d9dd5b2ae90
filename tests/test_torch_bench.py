"""bench_torch.py, the port's benchmark script, against bench.py on the CPU.

  - camera_path(i) for i in 0..240 and every state the benchmark freezes
    (configuration 1, the four sea levels, FXAA on and off, the four hours,
    the worst pose, the crossfade start) equal bench.py's: exactly on
    fields made of adds and multiplies, within TRIG_ULP on the camera
    position (tests/test_torch_sim.py's contract);
  - main() at 160x96 prints one JSON line with bench.py's keys and a
    details dict with every configuration's key;
  - the parity gate pointed at tests/golden/ (96x160, the 64x128 sky)
    passes the golden contract: RMSE < 2e-3 and < 0.3 % of pixels off by
    more than 2 levels;
  - at a size with no goldens and no --skip-parity the script exits 2
    before it renders anything;
  - with no card and no --device cpu it raises;
  - the worst-state probe and the soak, on a small CPU Engine: the probe
    reads every pose of its grid and names the slowest, the soak reports
    each segment and carries the camera script and the clock across them;
  - no file of the port, and none of its root scripts, imports JAX, the JAX
    package, bench.py, the tests or PIL.
"""

import ast
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
import raytracing_cuda_tpu_torch
from raytracing_cuda_tpu.sim import state as jsim
from tests.test_torch_sim import assert_state_match

torch.set_num_threads(2)

ROOT = Path(bench_torch.__file__).parent

# every frozen state of bench.py:737-808
PRESETS = {
    "config1_mountains": dict(day=14.0, cam_preset=1, aa=False),
    **{f"sea_{s}": dict(cam_preset=0, sea=s) for s in (-4.5, -2.0, 0.0, 2.0)},
    "fxaa_on": dict(cam_preset=0, aa=True),
    "fxaa_off": dict(cam_preset=0, aa=False),
    **{f"hour_{d}": dict(day=d, cam_preset=1) for d in (6.0, 14.0, 18.0, 1.0)},
    "worst_pose": dict(day=17.6, yaw=315.0),
    "defaults": dict(),
}


def test_camera_path_equals_bench():
    for i in range(241):
        want, got = bench.camera_path(i), bench_torch.camera_path(i)
        assert want._fields == got._fields
        for key in want._fields:
            a = np.asarray(getattr(want, key))
            b = np.asarray(getattr(got, key))
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, key)
    moves = [int(bench_torch.camera_path(i).move_forward) for i in (0, 59, 60,
                                                                    120)]
    assert moves == [1, 1, 0, 1]


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_state_equals_bench(name):
    assert_state_match(bench.preset_state(**PRESETS[name]),
                       bench_torch.preset_state(**PRESETS[name]))
    assert not bool(bench_torch.preset_state(**PRESETS[name]).play)


def test_crossfade_start_state_equals_bench():
    """bench.py:789-790: the initial state at day 8.05, settled, playing."""
    from raytracing_cuda_tpu_torch.sim import state as tsim

    want = jsim.settle(jsim.init_state()._replace(
        day_time=jnp.float32(8.05)))
    got = tsim.settle(tsim.init_state()._replace(
        day_time=torch.tensor(8.05, dtype=torch.float32)))
    assert_state_match(want, got)
    assert 0 < float(got.sky_vars[0]) < 1 and bool(got.play)


def test_golden_state_equals_the_goldens_states():
    from tests.test_golden import CASES, make_state

    assert bench_torch.CASES == CASES
    for kw in CASES.values():
        assert_state_match(make_state(**kw), bench_torch.golden_state(**kw))


def small_engine(w=160, h=96):
    from raytracing_cuda_tpu_torch.app.loop import Engine
    from raytracing_cuda_tpu_torch.utils.config import RenderConfig

    return Engine(RenderConfig(width=w, height=h,
                               procedural_sky_shape=(64, 128)), "cpu")


DETAIL_KEYS = {"mountains_640x480_noaa_ms", "island_sea_sweep_ms",
               "fxaa_on_ms", "fxaa_off_ms", "fxaa_cost_ms", "time_of_day_ms",
               "crossfade_sustained_fps", "low_sun_worst_ms",
               "low_sun_worst_fps", "sustained"}


def test_main_prints_one_json_line_with_every_configuration(capsys):
    rc = bench_torch.main(["--device", "cpu", "--size", "160x96", "--frames",
                           "4", "--skip-parity"])
    cap = capsys.readouterr()
    assert rc == 0
    lines = cap.out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "sustained_fps_160x96_animated"
    assert out["unit"] == "fps" and out["value"] > 0
    assert abs(out["vs_baseline"] - out["value"] / 60.0) < 1e-3
    assert out["crossfade_fps"] > 0
    assert "parity_ok" not in out and "parity_rmse_max" not in out
    details = json.loads(cap.err[cap.err.index("{"):])
    assert DETAIL_KEYS <= set(details)
    assert len(details["island_sea_sweep_ms"]) == 4
    assert len(details["time_of_day_ms"]) == 4
    assert details["sustained"]["frames"] == 4
    assert details["device"] == "cpu"
    # the CPU has no CUDA events: no *_events twin of a host-clock reading
    assert not [k for k in [*details, *out] if k.endswith("_events")]


def test_skip_configs_and_batch(capsys):
    rc = bench_torch.main(["--device", "cpu", "--size", "160x96", "--frames",
                           "5", "--skip-parity", "--skip-configs", "--batch",
                           "2", "--no-sky-cache"])
    cap = capsys.readouterr()
    out = json.loads(cap.out.strip())
    assert rc == 0 and "crossfade_fps" not in out
    details = json.loads(cap.err[cap.err.index("{"):])
    assert not DETAIL_KEYS & (set(details) - {"sustained"})
    assert details["sustained"]["frames"] == 5


def test_parity_gate_passes_on_the_small_goldens(monkeypatch):
    """The gate as main() runs it, on the 96x160 goldens of tests/golden/
    (rendered by the JAX oracle with the 64x128 procedural sky)."""
    root = str(ROOT / "tests" / "golden")
    monkeypatch.setattr(bench_torch, "GOLDEN_SIZE", (160, 96))
    assert bench_torch.golden_dir(160, 96, root) == root
    details = {}
    ok, rmses = bench_torch.parity_check(small_engine(), details, root)
    assert ok and set(rmses) == set(bench_torch.CASES)
    assert max(rmses.values()) < bench_torch.GOLDEN_RMSE
    assert max(details["parity_off_frac"].values()) < (
        bench_torch.GOLDEN_OFF_FRAC)
    assert details["parity_rmse"] == rmses


def test_parity_gate_fails_a_wrong_frame(monkeypatch, tmp_path):
    """Goldens of another state miss the contract, and main() would exit
    1: the gate can fail."""
    from raytracing_cuda_tpu_torch.utils.images import load_png, save_png

    src = ROOT / "tests" / "golden"
    names = list(bench_torch.CASES)
    for name, other in zip(names, names[1:] + names[:1]):
        save_png(load_png(str(src / f"{other}.png")),
                 str(tmp_path / f"{name}.png"))
    monkeypatch.setattr(bench_torch, "GOLDEN_SIZE", (160, 96))
    ok, rmses = bench_torch.parity_check(small_engine(), {}, str(tmp_path))
    assert not ok and min(rmses.values()) > bench_torch.GOLDEN_RMSE


def test_goldens_exist_for_720p_and_1080p_only():
    assert bench_torch.golden_dir(1280, 720) == bench_torch.GOLDEN_ROOT
    assert bench_torch.golden_dir(1920, 1080) == os.path.join(
        bench_torch.GOLDEN_ROOT, "1920x1080")
    assert bench_torch.golden_dir(640, 480) is None


def test_exits_2_without_goldens(capsys, monkeypatch):
    def no_engine(*a, **kw):
        raise AssertionError("rendered before refusing the size")

    import raytracing_cuda_tpu_torch.app.loop as loop

    monkeypatch.setattr(loop, "Engine", no_engine)
    assert bench_torch.main(["--device", "cpu", "--size", "160x96"]) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "--skip-parity" in cap.err


def test_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the no-CUDA refusal cannot be checked")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.main(["--quick"])


def test_probe_reads_every_pose_and_names_the_slowest():
    from experiments import worst_state_probe_torch as wsp

    st = wsp.pose_state(17.6, 315.0)
    assert float(st.day_time) == np.float32(17.6) and not bool(st.play)
    assert float(st.cam.hor_angle) == 315.0
    assert float(st.cam.ver_angle) == np.float32(wsp.PITCH)
    lines = []
    ms, pose, readings = wsp.probe(small_engine(96, 48), days=(14.0, 17.6),
                                   yaws=(0, 180), n=1, out=lines.append)
    assert set(readings) == {(14.0, 0), (14.0, 180), (17.6, 0), (17.6, 180)}
    # no kernel on the CPU: ranked by the host-clock frame time
    assert all(k is None and f > 0 for k, f in readings.values())
    assert readings[pose][1] == ms == max(f for _, f in readings.values())
    assert len(lines) == 2 and lines[1].startswith("day 17.6:")
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: the refusal cannot be checked")
        wsp.main(["--size", "96x48"])


def test_soak_reports_each_segment_and_carries_the_script_across():
    from experiments import soak_torch
    from raytracing_cuda_tpu_torch.sim import state as tsim

    eng, lines = small_engine(96, 48), []
    rows = soak_torch.soak(eng, 2, 3, 12.0, out=lines.append)
    assert len(rows) == 2 and len(lines) == 3
    assert lines[2].startswith("floor ") and "over 6 frames" in lines[2]
    for row in rows:
        assert row["fps"] > 0 and row["host_fps"] > 0 and row["rss_gb"] > 0
        assert row["device_peak_bytes"] is None          # no card here
    # the segments are one run: the state after them is the script's
    # frames 0..5 from day 12 (the warm-up frames leave no trace)
    st = tsim.settle(tsim.init_state()._replace(
        day_time=torch.tensor(12.0, dtype=torch.float32)))
    for i in range(6):
        st = tsim.animate(st, bench_torch.camera_path(i), 1 / 60)
    assert torch.equal(eng.state.day_time, st.day_time)
    assert torch.equal(eng.state.cam.pos, st.cam.pos)
    assert rows[1]["clock"] == eng.time_string()


def _imports(path: Path):
    """(module name, at module level?) of every import in a file."""
    tree = ast.parse(path.read_text())
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in top


SCRIPTS = ["chip_smoke.py", "bench_torch.py", "__torch_entry__.py",
           "experiments/worst_state_probe_torch.py",
           "experiments/soak_torch.py"]


def test_port_and_scripts_import_nothing_of_jax():
    """Anywhere in a file: jax, the JAX package, bench.py, the tests. At
    module level also PIL (the card's machine has none; `--gif` imports it
    inside its branch)."""
    files = sorted(Path(raytracing_cuda_tpu_torch.__file__).parent.rglob(
        "*.py")) + [ROOT / d for d in SCRIPTS]
    assert len(files) > 20
    assert sorted(str(p.relative_to(ROOT)) for p in (ROOT / "experiments")
                  .glob("*_torch.py")) == sorted(SCRIPTS[3:])
    banned = ("jax", "raytracing_cuda_tpu", "bench", "tests")
    for f in files:
        for mod, top in _imports(f):
            root = mod.split(".")[0]
            assert root not in banned, f"{f}: imports {mod}"
            assert not (top and root == "PIL"), f"{f}: imports {mod} at top"
