"""The fly traffic: one stream per seed, its parameters' ranges, its events,
and the camera kept about the island."""

import json

import numpy as np
import pytest
import torch

from rtbench import generator as g
from rtbench import reference as ref

FLY = g.load_traffic("fly")
PER_S = round(1 / FLY["frame_dt_s"])


def _starts(mask):
    """The frames where a run of True begins."""
    m = np.asarray(mask, bool)
    return np.flatnonzero(m & ~np.concatenate([[False], m[:-1]]))


def _runs(mask):
    """The lengths, in frames, of the runs of True."""
    m = np.concatenate([[False], np.asarray(mask, bool), [False]])
    d = np.diff(m.astype(int))
    return np.flatnonzero(d == -1) - np.flatnonzero(d == 1)


def test_a_seed_gives_one_stream_whatever_the_pieces():
    a = g.Flight(FLY, 2**31 + 77)
    b = g.Flight(FLY, 2**31 + 77)
    whole = a.take(40 * PER_S + 17)
    parts = np.concatenate([b.take(1), b.take(999),
                            b.take(40 * PER_S + 17 - 1000)])
    assert a.start == b.start
    np.testing.assert_array_equal(whole, parts)
    other = g.Flight(FLY, 2**31 + 78)
    assert not np.array_equal(other.take(len(whole)), whole)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 + 5, 2**33 + 1])
def test_fly_parameters_in_range(seed):
    f = g.Flight(FLY, seed)
    v = f.take(120 * PER_S)
    lo, hi = FLY["start_hour"]
    assert lo <= f.start.hour < hi
    assert f.start.cam_preset in FLY["start_presets"]
    assert v.dtype == np.float32
    np.testing.assert_array_equal(v[:, g.DT], np.float32(1 / 60))
    assert np.all(v[:, g.PLAY] == 1) and np.all(v[:, g.PAUSE] == 0)
    assert np.abs(v[:, [g.MDX, g.MDY]]).max() <= FLY["mouse"]["max_px"]
    # one movement key held in every frame
    keys = ((v[:, g.SIDE] != 0).astype(int) + (v[:, g.FORWARD] != 0)
            + (v[:, g.UP] != 0))
    assert np.all(keys == 1)
    assert set(np.unique(v[:, g.RUN])) <= {0, 1}
    assert set(np.unique(v[:, g.TIME_PRESET])) <= {-1, 0, 1, 2, 3}
    assert set(np.unique(v[:, g.CAM_PRESET])) <= {-1, 0, 1}

    ev = FLY["events"]
    at = np.sort(np.concatenate([
        np.flatnonzero(v[:, g.TIME_PRESET] >= 0),
        np.flatnonzero(v[:, g.CAM_PRESET] >= 0),
        _starts(v[:, g.TIME] != 0), _starts(v[:, g.SEA] != 0)]))
    gaps = np.diff(np.concatenate([[0], at])) / PER_S
    assert len(at) >= 120 / ev["every_s"][1] - 1
    assert np.all(gaps >= ev["every_s"][0] - 1e-9)
    assert np.all(gaps <= ev["every_s"][1] + 1e-9)
    for slot, span in ((g.TIME, ev["time_scrub_s"]), (g.SEA, ev["sea_s"])):
        held = _runs(v[:, slot] != 0) / PER_S
        assert np.all(held >= span[0] - 1e-9)
        assert np.all(held <= span[1] + 1e-9)

    fx = FLY["fxaa"]
    off, on = np.flatnonzero(v[:, g.AA_OFF]), np.flatnonzero(v[:, g.AA_ON])
    assert len(off) >= 2 and len(on) == len(off)
    assert off[0] / PER_S <= fx["first_s"][1] + 1e-9
    d = (on - off) / PER_S
    assert np.all(d >= fx["off_s"][0] - 1e-9)
    assert np.all(d <= fx["off_s"][1] + 1e-9)
    every = np.diff(off) / PER_S
    assert np.all(every >= fx["every_s"][0] - 1e-9)
    assert np.all(every <= fx["every_s"][1] + 1e-9)


def test_events_are_drawn_evenly():
    """Each event kind comes about a quarter of the time (a long flight,
    drawn for the count)."""
    v = g.Flight(FLY, 99).take(1200 * PER_S)
    n = [len(np.flatnonzero(v[:, g.TIME_PRESET] >= 0)),
         len(np.flatnonzero(v[:, g.CAM_PRESET] >= 0)),
         len(_starts(v[:, g.TIME] != 0)), len(_starts(v[:, g.SEA] != 0))]
    assert 100 < sum(n) < 250
    assert all(0.15 < k / sum(n) < 0.35 for k in n)


def test_bursts_and_shift():
    """Movement bursts of 0.5-3 s, but where the steering cuts one short
    or two alike follow each other, shift in about a fifth of the
    frames."""
    v = g.Flight(FLY, 5).take(600 * PER_S)
    held = v[:, [g.SIDE, g.FORWARD, g.UP, g.RUN]]
    starts = np.flatnonzero(np.any(held[1:] != held[:-1], axis=1)) + 1
    lengths = np.diff(np.concatenate([[0], starts, [len(v)]]))[:-1] / PER_S
    assert np.mean((lengths >= 0.5 - 1e-9) & (lengths <= 3.0 + 1e-9)) > 0.8
    assert 0.5 <= np.median(lengths) <= 3.0
    assert 0.12 < v[:, g.RUN].mean() < 0.28


@pytest.mark.parametrize("seed", [3, 2**31 + 9, 2**33])
def test_the_camera_stays_in_its_box(seed):
    """The generator's camera, flown 10 minutes, leaves its box by no more
    than a frame's run at speed, and goes back."""
    f = g.Flight(FLY, seed)
    cam = g.Camera(f.start.cam_preset)
    box, step = FLY["box"], 100.0 / PER_S + 1e-6
    far = 0.0
    for v in f.take(600 * PER_S):
        cam.step(v)
        far = max(far, max(abs(x) for x in cam.back(box)))
    assert far <= step


@pytest.mark.parametrize("seed", [4, 2**31 + 3])
def test_the_generators_camera_follows_the_state_step(seed):
    """The camera the generator steers by is where the reference's state
    step puts it, to float32's rounding, over a long stretch."""
    f = g.Flight(FLY, seed)
    vecs = f.take(40 * PER_S)
    cam = g.Camera(f.start.cam_preset)
    st = ref.start_state(f.start.hour, f.start.cam_preset, True)
    av = torch.from_numpy(vecs)
    with torch.inference_mode():
        for i, v in enumerate(vecs):
            cam.step(v)
            st = ref.sim.animate_packed(st, av[i])
            if i % 200 == 199:
                np.testing.assert_allclose(st.cam.pos.numpy(), cam.pos,
                                           atol=0.5)
                assert abs(float(st.cam.ver_angle) - cam.pitch) < 0.05
                yaw = abs(float(st.cam.hor_angle) - cam.yaw)
                assert min(yaw, 360 - yaw) < 0.05
                assert abs(float(st.sea_y) - cam.sea) < 0.01


def test_the_closed_loop_only():
    with pytest.raises(ValueError):
        g.Flight({**FLY, "loop": "open"}, 1)


def test_an_unknown_event_is_refused():
    params = {**FLY, "events": {**FLY["events"], "every_s": [0.1, 0.1],
                                "kinds": ["teleport"]}}
    with pytest.raises(ValueError):
        g.Flight(params, 1).take(60)


def test_traffic_file_is_data():
    text = (g.TRAFFIC_DIR / "fly.json").read_text()
    assert json.loads(text) == FLY
