"""The record driver (rtbench/record.py) and its traffic: the seeded pan is
the CLI's `scripted_action`, whole runs on the CPU at a small size (one
device, and frame DP over a mesh of 4 repeated CPU entries) are correct,
the controls and a broken timed path are not, and the fly cells' result
line keeps its keys.

A whole run is driven here (set-up, the window, the check) at 48x96 with a
64x128 sky, skipping only the harness's look for a card. The record cells
(their traffic and limits are in rtbench/) are not in BENCHMARK.json
(PERF.md); the tests run them from a root whose BENCHMARK.json holds them
(conftest.py `record_root`).
"""

import numpy as np
import pytest
import torch

from rtbench import calibrate, correct, generator, record, run

RECORD8 = "island_720p.record8"
DP4 = "island_1080p.record_dp4"
SMALL = {"width": 96, "height": 48, "procedural_sky_shape": [64, 128]}
PAN = generator.load_traffic("record8")


@pytest.fixture
def root(record_root):
    return record_root


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_pan_at_phase_zero_is_the_clis_scripted_action():
    from raytracing_cuda_tpu_torch.__main__ import RECORD_DT, scripted_action

    pan = generator.Pan({**PAN, "pan": {**PAN["pan"],
                                        "phase_frames": [0.0, 0.0]}}, 7)
    want = np.stack([scripted_action(i).pack(RECORD_DT) for i in range(300)])
    np.testing.assert_array_equal(pan.take(300), want)


def test_a_seed_gives_one_pan_whatever_the_pieces():
    a, b = generator.Pan(PAN, 2**31 + 77), generator.Pan(PAN, 2**31 + 77)
    whole = a.take(2017)
    parts = np.concatenate([b.take(1), b.take(999), b.take(1017)])
    assert a.start == b.start and a.phase == b.phase
    np.testing.assert_array_equal(whole, parts)
    other = generator.Pan(PAN, 2**31 + 78)
    assert not np.array_equal(other.take(len(whole)), whole)


@pytest.mark.parametrize("traffic", ["record8", "record_dp4"])
@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 5, 2**33 + 1])
def test_the_pan_in_range(traffic, seed):
    params = generator.load_traffic(traffic)
    assert generator.driver_of(params) == "record"
    pan = generator.Pan(params, seed)
    v = pan.take(500)
    lo, hi = params["start_hour"]
    assert lo <= pan.start.hour < hi
    assert pan.start.cam_preset in params["start_presets"]
    assert 0.0 <= pan.phase < params["pan"]["phase_frames"][1]
    assert v.dtype == np.float32
    np.testing.assert_array_equal(v[:, generator.DT], np.float32(1 / 30))
    np.testing.assert_array_equal(v[:, generator.TIME], 1)
    np.testing.assert_array_equal(v[:, [generator.TIME_PRESET,
                                        generator.CAM_PRESET]], -1)
    assert np.abs(v[:, generator.MDX]).max() <= 3.0
    held = np.delete(v, [generator.MDX, generator.TIME, generator.TIME_PRESET,
                         generator.CAM_PRESET, generator.DT], axis=1)
    assert not held.any()


def test_the_fly_traffic_is_the_fly_driver(root):
    assert generator.driver_of(generator.load_traffic("fly")) == "fly"
    assert run.Cell("island_720p.fly").driver == "fly"
    assert run.Cell(RECORD8, root).driver == "record"


def test_an_unknown_driver_is_refused(monkeypatch, root):
    load = generator.load_traffic
    monkeypatch.setattr(generator, "load_traffic",
                        lambda name: {**load(name), "driver": "teleport"})
    with pytest.raises(ValueError):
        run.Cell(RECORD8, root)


@pytest.mark.parametrize("cell, mesh", [(RECORD8, None),
                                        (DP4, ["cpu"] * 4)])
def test_a_record_run_on_the_cpu_is_correct(cell, mesh, root):
    res = run.run_cell(cell, 2**31 + 41, 0.5, False, device="cpu",
                       root=root, render_over=SMALL, mesh=mesh)
    K = run.Cell(cell, root).params["batch"]
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] >= K and res["attempted"] % K == 0
    assert set(res["metrics"]) == {"fps", "frame_latency_ms_p99", "setup_s"}
    assert res["device"]["count"] == 1
    assert list(res)[-1] == "checks"


def test_the_sample_is_one_whole_batch_drawn_from_the_seed():
    def kept(seed, batches=200, K=8):
        sample = record.BatchSample(np.random.default_rng([seed, 1]),
                                    (K, 2, 3, 3))
        for b in range(batches):
            sample.offer(b, np.full((K, 2, 3, 3), b % 256, np.uint8))
        return sample.kept

    a = kept(2**31 + 9)
    assert kept(2**31 + 9).keys() == a.keys()
    first = min(a)
    assert first % 8 == 0 and sorted(a) == list(range(first, first + 8))
    assert all((img == (first // 8) % 256).all() for img in a.values())
    firsts = {min(kept(s)) for s in range(40)}
    assert len(firsts) > 5


def test_the_fly_cells_result_keys_are_unchanged():
    res = run.run_cell("island_720p.fly", 2**31 + 43, 0.3, False,
                       device="cpu", render_over=SMALL)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert list(res["device"]) == ["platform", "kind", "count",
                                   "memory_peak_bytes"]
    assert res["device"]["count"] == 1


@pytest.mark.parametrize("control", calibrate.CONTROLS)
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_the_control_is_not_correct_on_the_pan(seed, control, root):
    """Each control put in the program's place fails the record cells'
    limits against the float32 reference, on the record traffic."""
    for cell_name in (RECORD8, DP4):
        cell = run.Cell(cell_name, root, render_over=SMALL)
        pan = generator.Pan(cell.params, seed)
        vecs = pan.take(96)
        keep = {10, 95}
        final, kept = correct.reference_states(cell.render, pan.start, vecs,
                                               keep)
        want_state = correct.state_numbers(final)
        want_frames = correct.reference_frames(cell.render, kept, "cpu")
        got = calibrate.control_outputs(control, cell.render, pan.start,
                                        vecs, keep, "cpu", want_state, kept)
        readings = correct.compare(*got, want_state, want_frames)
        ok, _ = correct.judge(readings, cell.limits)
        assert not ok, cell_name


def _frozen_step(state, av):
    return state


def _altered(method, how):
    def call(self, *args, **kwargs):
        imgs = method(self, *args, **kwargs).clone()
        if how == "answer_altered":
            return imgs.flip(-1)
        if how == "one_slot_altered":
            imgs[1] = 255 - imgs[1]         # one slot of every batch
            return imgs
        imgs[len(imgs) // 2:] = 0           # half the batch left out
        return imgs
    return call


def _first_entry_only(place, entries):
    """The gather of a frame-DP batch over `entries` mesh entries (one call
    each, in order) with every block but the first entry's left out: those
    frames keep a cleared buffer."""
    calls = [0]

    def placed(frames, bands, entry, n):
        if calls[0] % entries == 0:
            place(frames, bands, entry, n)
        else:
            frames.zero_()
        calls[0] += 1
    return placed


FAULTS = ["state_unchanged", "answer_altered", "half_left_out",
          "one_slot_altered", "fxaa_skipped"]


@pytest.mark.parametrize("cell, fault", [
    *[(RECORD8, f) for f in FAULTS],
    *[(DP4, f) for f in FAULTS + ["exchange_left_out"]]])
def test_a_broken_record_path_is_not_correct(cell, fault, monkeypatch,
                                             root):
    from raytracing_cuda_tpu_torch.app import loop
    from raytracing_cuda_tpu_torch.parallel import mesh
    from raytracing_cuda_tpu_torch.render import fxaa, pipeline
    from raytracing_cuda_tpu_torch.sim import state as sim

    if fault == "state_unchanged":
        monkeypatch.setattr(sim, "animate_packed", _frozen_step)
        monkeypatch.setattr(pipeline, "animate_packed", _frozen_step)
    elif fault in ("answer_altered", "half_left_out", "one_slot_altered"):
        for name in ("step_and_frame_batch", "render_script_dp"):
            monkeypatch.setattr(loop.Engine, name, _altered(
                getattr(loop.Engine, name), fault))
    elif fault == "fxaa_skipped":
        # the filter left out while the state's toggle stays on
        monkeypatch.setattr(fxaa, "fxaa_batch", lambda image: image)
        monkeypatch.setattr(mesh, "fxaa_batch", lambda image: image)
    else:
        # the gather of frame DP: only the first entry's block is placed
        monkeypatch.setattr(loop, "place_bands", _first_entry_only(
            loop.place_bands, run.Cell(cell, root).entry["chips"]))
    res = run.run_cell(cell, 17, 0.5, False, device="cpu", root=root,
                       render_over=SMALL)
    assert not res["correct"] and res["failed"] >= 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell, mesh", [(RECORD8, None),
                                        (DP4, ["cuda:0"] * 4)])
def test_a_short_record_run_on_the_card(card, cell, mesh, traced, root):
    res = run.run_cell(cell, 31, 1.0, traced, device=card, mesh=mesh,
                       root=root,
                       render_over={"width": 160, "height": 96,
                                    "procedural_sky_shape": [64, 128]})
    assert res["correct"] and res["device"]["platform"] == "gpu"
    if not traced:
        assert res["metrics"]["fps"]["value"] > 0
        return
    m = res["metrics"]
    assert m["readback_ms"]["value"] > 0 and m["torch_ops_ms"]["value"] > 0
    assert m["host_call_ms"]["value"] > 0
    assert 0 < m["frame_mfu"]["value"] < 100
    assert ("gather_ms" in m) == (cell == DP4)
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
