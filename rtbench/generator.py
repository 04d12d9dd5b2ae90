"""The one traffic generator: a traffic file's parameters and a seed → the
viewer's start and its stream of per-frame inputs.

A traffic file names the driver that plays it (`"driver"`, rtbench/run.py
`DRIVERS`; `fly` where the key is absent), and so its stream: `Flight` for
the live viewer's user (below), `Pan` for the offline `record` job's
scripted pan.

A traffic file (rtbench/traffic/<name>.json) describes a user of the
interactive viewer: where the user starts (an hour, a camera viewpoint),
how the mouse looks about, how the movement keys are held, how often a key
event comes and of which kinds, and how often FXAA is switched off and on
again. `Flight(params, seed)` draws all of it from the seed, frame by frame,
as packed (16,) float32 action vectors, the Engine's wire format
(raytracing_cuda_tpu_torch/sim/actions.py `Action.pack`, slot 14 = dt).

The user stays near the island: the generator follows the camera with the
state step's own motion (rtbench/reference/state.py: mouse look, WASD/QE at
50 or 100 units a second, the sea's level, the viewpoint keys), and while
the camera is outside the traffic's box (x and z about the island, y within
a height above and below the sea) a movement key that leads it farther out
gives way to the key that leads it back, as the pitch is steered back from
its clamp. One seed gives one stream, whatever length is taken of it and
in how many pieces.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np

from rtbench.reference.state import (CAM_PRESETS_HOR, CAM_PRESETS_POS,
                                     CAM_PRESETS_VER, CAM_VIEW_DELTA,
                                     CAM_VIEW_LIMIT, MOVE_SPEED,
                                     RUN_SPEED_UP, SEA_SPEED)

# the packed action vector's slots
(SIDE, FORWARD, UP, RUN, MDX, MDY, TIME, PLAY, PAUSE, SEA, TIME_PRESET,
 CAM_PRESET, AA_ON, AA_OFF, DT) = range(15)
WIDTH = 16

# a held key → (slot, value): W/S forward, D/A side, Q/E up
KEYS = {"W": (FORWARD, 1), "S": (FORWARD, -1), "D": (SIDE, 1),
        "A": (SIDE, -1), "Q": (UP, 1), "E": (UP, -1)}
SEA_START = -4.5        # the sea's level in the initial state (scene.cpp:448)

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load_traffic(name: str, root: Path = TRAFFIC_DIR) -> dict:
    """The parameters of traffic mix `name` (root/<name>.json)."""
    path = root / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no traffic file {path}")
    return json.loads(path.read_text())


class Start(NamedTuple):
    """Where a run starts: the clock's hour (float32) and a camera preset."""

    hour: float
    cam_preset: int


def driver_of(params: dict) -> str:
    """The driver a traffic file names: `fly` where it names none."""
    return params.get("driver", "fly")


def _frames(seconds: float, dt: float) -> int:
    return max(1, int(round(seconds / dt)))


class Camera:
    """The camera and the sea as the state step moves them, in float64 on
    the host: close enough to the program's float32 state to tell where
    the camera is, which is all the steering asks."""

    def __init__(self, preset: int):
        self.sea = SEA_START
        self.preset(preset)

    def preset(self, k: int) -> None:
        self.pos = [float(x) for x in CAM_PRESETS_POS[k]]
        self.yaw = float(CAM_PRESETS_HOR[k])
        self.pitch = float(CAM_PRESETS_VER[k])

    def key_dir(self, key: str) -> tuple:
        """The unit direction key `key` moves the camera in, at its yaw."""
        slot, value = KEYS[key]
        if slot == UP:
            return (0.0, float(value), 0.0)
        rad = math.radians(self.yaw)
        c, s = math.cos(rad), math.sin(rad)
        fwd, side = (c, 0.0, s), (-s, 0.0, c)
        d = fwd if slot == FORWARD else side
        return tuple(value * x for x in d)

    def step(self, v: np.ndarray) -> None:
        """One frame's action (mouse + move, then the controls, as
        `animate_packed` orders them)."""
        side, fwd, up, run, mdx, mdy = v[:6].tolist()
        self.yaw = (self.yaw + CAM_VIEW_DELTA * mdx + 360.0) % 360.0
        self.pitch = min(max(self.pitch + CAM_VIEW_DELTA * mdy,
                             -CAM_VIEW_LIMIT), CAM_VIEW_LIMIT)
        if side or fwd or up:
            rad = math.radians(self.yaw)
            c, s = math.cos(rad), math.sin(rad)
            d = (c * fwd - s * side, up, s * fwd + c * side)
            norm = math.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
            step = MOVE_SPEED * (RUN_SPEED_UP if run > 0 else 1.0) \
                * float(v[DT]) / norm
            self.pos = [p + x * step for p, x in zip(self.pos, d)]
        if v[SEA]:
            self.sea += float(v[SEA]) * SEA_SPEED * float(v[DT])
        if v[CAM_PRESET] >= 0:
            self.preset(int(v[CAM_PRESET]))

    def back(self, box: dict) -> tuple:
        """The way back into `box` from the camera (zero inside it)."""
        lo = (box["x"][0], self.sea - box["below_sea"], box["z"][0])
        hi = (box["x"][1], self.sea + box["above_sea"], box["z"][1])
        return tuple(min(max(p, a), b) - p
                     for p, a, b in zip(self.pos, lo, hi))


class Flight:
    """A seeded user of the viewer (a traffic file's parameters): the start,
    then `take(n)` → the next n frames' packed actions, (n, 16) float32.

    Every frame holds one movement key (bursts of `move.burst_s`, shift in
    a `move.run_share` of them) and the mouse's smoothed random walk; the
    clock plays. A key event comes every `events.every_s`, its kind drawn
    evenly from `events.kinds`: a time preset pressed (keys 1-4), a camera
    viewpoint pressed (keys 5/6), the clock scrubbed (LEFT/RIGHT held
    `time_scrub_s`), the sea raised or lowered (UP/DOWN held `sea_s`).
    FXAA goes off for `fxaa.off_s` and on again every `fxaa.every_s`, the
    first time within `fxaa.first_s`."""

    def __init__(self, params: dict, seed: int):
        if params.get("loop") != "closed":
            raise ValueError("the generator drives a closed loop only")
        self.p = params
        self.dt = float(params["frame_dt_s"])
        self.rng = rng = np.random.default_rng(seed)
        lo, hi = params["start_hour"]
        hour = float(np.float32(rng.uniform(lo, hi)))
        presets = params["start_presets"]
        self.start = Start(hour, int(presets[rng.integers(len(presets))]))
        self.cam = Camera(self.start.cam_preset)
        self.f = 0                      # the next frame's index
        self.holds = []                 # [slot, value, first, last]
        self.next_event = self._after(params["events"]["every_s"])
        self.next_fxaa = self._after(params["fxaa"]["first_s"])
        self.mouse, self.target, self.retarget_at = [0.0, 0.0], None, 0
        self.key, self.run, self.until = None, False, 0

    def _u(self, span) -> float:
        return float(self.rng.uniform(span[0], span[1]))

    def _after(self, span) -> int:
        return self.f + _frames(self._u(span), self.dt)

    def _event(self, f: int) -> None:
        ev = self.p["events"]
        kind = ev["kinds"][self.rng.integers(len(ev["kinds"]))]
        sign = 1 if self.rng.random() < 0.5 else -1
        if kind == "time_preset":
            self.holds.append([TIME_PRESET, int(self.rng.integers(4)), f, f])
        elif kind == "cam_preset":
            self.holds.append([CAM_PRESET, int(self.rng.integers(2)), f, f])
        elif kind == "time_scrub":
            d = _frames(self._u(ev["time_scrub_s"]), self.dt)
            self.holds.append([TIME, sign, f, f + d - 1])
        elif kind == "sea":
            d = _frames(self._u(ev["sea_s"]), self.dt)
            self.holds.append([SEA, sign, f, f + d - 1])
        else:
            raise ValueError(f"unknown event kind {kind!r}")

    def _mouse(self, f: int, v: np.ndarray) -> None:
        m = self.p["mouse"]
        max_px = float(m["max_px"])
        if f >= self.retarget_at:
            tx, ty = self.rng.uniform(-max_px, max_px, 2).tolist()
            if abs(self.cam.pitch) > m["steer_back_deg"]:
                ty = -math.copysign(abs(ty), self.cam.pitch)
            self.target = (tx, ty)
            self.retarget_at = f + _frames(self._u(m["retarget_s"]), self.dt)
        ease = m["ease"]
        self.mouse = [x + ease * (t - x)
                      for x, t in zip(self.mouse, self.target)]
        v[MDX], v[MDY] = (min(max(x, -max_px), max_px) for x in self.mouse)

    def _move(self, f: int, v: np.ndarray) -> None:
        mv = self.p["move"]
        back = self.cam.back(self.p["box"])
        out = any(back)
        if out and self.key is not None:
            d = self.cam.key_dir(self.key)
            out = sum(a * b for a, b in zip(d, back)) <= 0
        if f >= self.until or out:
            if out:
                self.key = max(mv["keys"], key=lambda k: sum(
                    a * b for a, b in zip(self.cam.key_dir(k), back)))
            else:
                self.key = mv["keys"][self.rng.integers(len(mv["keys"]))]
            self.run = bool(self.rng.random() < mv["run_share"])
            self.until = f + _frames(self._u(mv["burst_s"]), self.dt)
        slot, value = KEYS[self.key]
        v[slot] = value
        v[RUN] = float(self.run)

    def _frame(self, v: np.ndarray) -> None:
        f = self.f
        v[DT] = np.float32(self.dt)
        v[PLAY] = 1 if self.p["clock"] == "play" else 0
        v[TIME_PRESET] = v[CAM_PRESET] = -1
        if f == self.next_event:
            self._event(f)
            self.next_event = self._after(self.p["events"]["every_s"])
        if f == self.next_fxaa:
            fx = self.p["fxaa"]
            d = _frames(self._u(fx["off_s"]), self.dt)
            self.holds += [[AA_OFF, 1, f, f], [AA_ON, 1, f + d, f + d]]
            self.next_fxaa = self._after(fx["every_s"])
        for slot, value, first, last in self.holds:
            if first <= f <= last:
                v[slot] = value
        self.holds = [h for h in self.holds if h[3] > f]
        self._mouse(f, v)
        self._move(f, v)
        self.cam.step(v)
        self.f += 1

    def take(self, n: int) -> np.ndarray:
        """The next n frames' packed actions, (n, 16) float32."""
        out = np.zeros((n, WIDTH), np.float32)
        for v in out:
            self._frame(v)
        return out


class Pan:
    """The offline `record` job's input (raytracing_cuda_tpu_torch/__main__.py
    `scripted_action`): frame i pans the mouse by
    `pan.mouse_dx_px * sin(pan.rad_per_frame * (i + i0))` with the clock
    scrubbed (`pan.time_control`) and nothing else held, every frame dt
    `frame_dt_s`. The seed draws where the job starts: an hour uniform over
    `start_hour`, a camera preset from `start_presets`, and the pan's phase
    i0 uniform over `pan.phase_frames` (the CLI's own start is i0 = 0).
    `take(n)` → the next n frames' packed actions, (n, 16) float32; one seed
    gives one stream, whatever the pieces it is taken in."""

    def __init__(self, params: dict, seed: int):
        if params.get("loop") != "closed":
            raise ValueError("the generator drives a closed loop only")
        self.p = pan = params["pan"]
        self.dt = float(params["frame_dt_s"])
        rng = np.random.default_rng(seed)
        lo, hi = params["start_hour"]
        hour = float(np.float32(rng.uniform(lo, hi)))
        presets = params["start_presets"]
        self.start = Start(hour, int(presets[rng.integers(len(presets))]))
        lo, hi = pan["phase_frames"]
        self.phase = float(rng.uniform(lo, hi))
        self.f = 0

    def take(self, n: int) -> np.ndarray:
        """The next n frames' packed actions, (n, 16) float32."""
        amp, rad = float(self.p["mouse_dx_px"]), float(self.p["rad_per_frame"])
        out = np.zeros((n, WIDTH), np.float32)
        # each frame's sine on the host's float64, as scripted_action's
        out[:, MDX] = [amp * np.sin((i + self.phase) * rad)
                       for i in range(self.f, self.f + n)]
        out[:, TIME] = self.p["time_control"]
        out[:, TIME_PRESET] = out[:, CAM_PRESET] = -1
        out[:, DT] = np.float32(self.dt)
        self.f += n
        return out
