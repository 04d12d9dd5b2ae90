"""The reference against the port's CPU Engine, its control, and runs of
the harness on the CPU with the timed path broken underneath: each fault
must read as not correct.

A whole run is driven here (set-up, the window, the check) at 48x96 with a
64x128 sky, skipping only the harness's look for a card.
"""

import numpy as np
import pytest
import torch

from rtbench import calibrate, correct, generator, run
from rtbench import reference as ref

SMALL = {"width": 96, "height": 48, "procedural_sky_shape": [64, 128]}
CELL = "island_720p.fly"
FLY = generator.load_traffic("fly")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _engine_frames(seed, n, keep):
    """The port's CPU Engine flown n frames of seed's flight →
    (start, actions, final state, {i: frame})."""
    from raytracing_cuda_tpu_torch.sim.actions import Action

    f = generator.Flight(FLY, seed)
    vecs = f.take(n)
    eng = run.build_engine({**run.Cell(CELL).render, **SMALL}, "cpu")
    eng.set_state(run.program_start(f.start, True))
    frames = {}
    for i, a in enumerate(Action.unpack(v) for v in vecs):
        img = eng.step_and_frame(a, float(a.unpack_dt(vecs[i])))
        if i in keep:
            frames[i] = img.numpy().copy()
    return f.start, vecs, correct.state_numbers(eng.state), frames


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_reference_equals_the_port_on_the_cpu(seed):
    keep = {0, 57, 239}
    start, vecs, state, frames = _engine_frames(seed, 240, keep)
    want_state, want_frames = correct.reference_outputs(
        {**run.Cell(CELL).render, **SMALL}, start, vecs, keep, "cpu")
    # the same float32 step on the same device: the states agree bit for
    # bit; the frames come from another raytracer (the megakernel's plain
    # version against the oracle) and a sky evaluated elsewhere (numpy's
    # exp against torch's), so a few pixels part by a level or two
    assert state == want_state
    for i in keep:
        rmse, off = correct.frame_gaps(frames[i], want_frames[i])
        assert rmse < 1e-3 and off < 0.1


@pytest.mark.parametrize("control", calibrate.CONTROLS)
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_the_control_is_not_correct(seed, control):
    """Each control put in the program's place (the reference in bfloat16;
    its float32 states rendered in bfloat16; FXAA left out with the toggle
    on; panoramas of half the size) fails the cell's limits against the
    float32 reference."""
    cell = run.Cell(CELL, render_over=SMALL)
    f = generator.Flight(FLY, seed)
    vecs = f.take(120)
    keep = {10, 119}
    final, kept = correct.reference_states(cell.render, f.start, vecs, keep)
    want_state = correct.state_numbers(final)
    want_frames = correct.reference_frames(cell.render, kept, "cpu")
    got = calibrate.control_outputs(control, cell.render, f.start, vecs,
                                    keep, "cpu", want_state, kept)
    readings = correct.compare(*got, want_state, want_frames)
    ok, checks = correct.judge(readings, cell.limits)
    assert not ok
    assert readings["frame_px_off_pct"] > cell.limits["frame_px_off_pct"]


def test_a_run_on_the_cpu_is_correct():
    res = run.run_cell(CELL, 2**31 + 41, 1.0, False, device="cpu",
                       render_over=SMALL)
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] >= 2
    assert set(res["metrics"]) == {"fps", "frame_latency_ms_p99", "setup_s"}
    assert list(res)[-1] == "checks"
    for v in res["checks"].values():
        assert v["value"] <= v["limit"]


def _frozen_step(state, av):
    return state


def _swap_channels(step):
    def altered(self, action=None, dt=1 / 60):
        return step(self, action, dt).flip(-1)
    return altered


def _half_rows(step):
    def halved(self, action=None, dt=1 / 60):
        img = step(self, action, dt).clone()
        img[img.shape[0] // 2:] = 0
        return img
    return halved


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "half_left_out", "fxaa_skipped"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from raytracing_cuda_tpu_torch.app.loop import Engine
    from raytracing_cuda_tpu_torch.render import fxaa
    from raytracing_cuda_tpu_torch.sim import state as sim

    if fault == "state_unchanged":
        monkeypatch.setattr(sim, "animate_packed", _frozen_step)
    elif fault == "answer_altered":
        monkeypatch.setattr(Engine, "step_and_frame",
                            _swap_channels(Engine.step_and_frame))
    elif fault == "fxaa_skipped":
        # the filter left out while the state's toggle stays on
        monkeypatch.setattr(fxaa, "fxaa", lambda image: image)
    else:
        monkeypatch.setattr(Engine, "step_and_frame",
                            _half_rows(Engine.step_and_frame))
    res = run.run_cell(CELL, 17, 1.0, False, device="cpu",
                       render_over=SMALL)
    assert not res["correct"] and res["failed"] >= 1


def test_start_state_matches_the_port():
    from raytracing_cuda_tpu_torch.sim import state as sim
    for preset in (0, 1):
        s = generator.Start(float(np.float32(13.37)), preset)
        port = correct.state_numbers(run.program_start(s, True))
        mine = correct.state_numbers(ref.start_state(s.hour, preset, True))
        assert port == mine
    assert sim is not None
