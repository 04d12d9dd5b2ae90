"""Per-frame input actions (port of raytracing_cuda_tpu/sim/actions.py).

The reference polls Win32 key state every frame (GetAsyncKeyState,
scene.cpp:142-163 and 689-756). Here one frame of input is a plain record
of held-key values, so the same step function serves interactive windows,
scripted drivers and tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Action(NamedTuple):
    """One frame of input. Integer fields are -1/0/+1 'axis' values."""

    move_side: np.int32       # D - A            (scene.cpp:149)
    move_forward: np.int32    # W - S            (scene.cpp:151)
    move_up: np.int32         # Q - E            (scene.cpp:153)
    run: np.bool_             # shift held       (scene.cpp:156)
    mouse_dx: np.float32      # pixels since last frame (mouseMotion)
    mouse_dy: np.float32
    time_control: np.int32    # RIGHT - LEFT     (scene.cpp:691)
    set_play: np.bool_        # P held           (scene.cpp:700)
    set_pause: np.bool_       # O held           (scene.cpp:703)
    sea_control: np.int32     # UP - DOWN        (scene.cpp:708)
    time_preset: np.int32     # -1 none, 0..3 = keys 1-4 (scene.cpp:713-728)
    cam_preset: np.int32      # -1 none, 0 = key 5 island, 1 = key 6 mountains
    set_aa_on: np.bool_       # B held           (scene.cpp:750)
    set_aa_off: np.bool_      # V held           (scene.cpp:753)

    @staticmethod
    def idle() -> "Action":
        """No keys held, no mouse motion."""
        z = np.int32(0)
        f = np.bool_(False)
        return Action(
            move_side=z, move_forward=z, move_up=z, run=f,
            mouse_dx=np.float32(0), mouse_dy=np.float32(0),
            time_control=z, set_play=f, set_pause=f, sea_control=z,
            time_preset=np.int32(-1), cam_preset=np.int32(-1),
            set_aa_on=f, set_aa_off=f,
        )

    # --- packed wire format: one (16,) float32 vector, slot 14 = dt ---

    _PACK_FIELDS = ("move_side", "move_forward", "move_up", "run",
                    "mouse_dx", "mouse_dy", "time_control", "set_play",
                    "set_pause", "sea_control", "time_preset", "cam_preset",
                    "set_aa_on", "set_aa_off")

    def pack(self, dt: float = 0.0) -> np.ndarray:
        """One (16,) float32 vector (exact for all field ranges)."""
        v = np.zeros(16, np.float32)
        for i, name in enumerate(self._PACK_FIELDS):
            v[i] = np.float32(getattr(self, name))
        v[14] = np.float32(dt)
        return v

    @staticmethod
    def unpack_dt(v) -> np.float32:
        return np.float32(v[14])

    @staticmethod
    def unpack(v) -> "Action":
        """Rebuild an Action from a packed vector."""
        v = np.asarray(v, np.float32)
        g = {name: v[i] for i, name in enumerate(Action._PACK_FIELDS)}
        i32 = np.int32
        return Action(
            move_side=i32(g["move_side"]), move_forward=i32(g["move_forward"]),
            move_up=i32(g["move_up"]), run=np.bool_(g["run"] > 0),
            mouse_dx=g["mouse_dx"], mouse_dy=g["mouse_dy"],
            time_control=i32(g["time_control"]),
            set_play=np.bool_(g["set_play"] > 0),
            set_pause=np.bool_(g["set_pause"] > 0),
            sea_control=i32(g["sea_control"]),
            time_preset=i32(g["time_preset"]), cam_preset=i32(g["cam_preset"]),
            set_aa_on=np.bool_(g["set_aa_on"] > 0),
            set_aa_off=np.bool_(g["set_aa_off"] > 0),
        )
