"""Frame-state checkpoint / resume (port of raytracing_cuda_tpu/utils/
checkpoint.py).

The whole FrameState (camera pose, clock, sea level, FXAA flag, sky
weights) serialises to a small JSON document in the JAX package's
`state-v1` format, so a state saved by either package loads in the other
and round-trips exactly (float32 values survive JSON's doubles). A state
on a card is read back to the host to be saved; a loaded state goes to the
device asked for.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from raytracing_cuda_tpu_torch.core.types import Camera
from raytracing_cuda_tpu_torch.sim.state import FrameState, state_to

FORMAT = "raytracing_cuda_tpu/state-v1"


def state_to_dict(state: FrameState) -> dict:
    c = state.cam
    return {
        "format": FORMAT,
        "camera": {
            "pos": c.pos.tolist(),
            "hor_angle": float(c.hor_angle),
            "ver_angle": float(c.ver_angle),
            "fov": float(c.fov),
        },
        "day_time": float(state.day_time),
        "play": bool(state.play),
        "sea_y": float(state.sea_y),
        "aa": bool(state.aa),
        "sky_vars": state.sky_vars.tolist(),
        "recolor_vars": state.recolor_vars.tolist(),
    }


def state_from_dict(d: dict) -> FrameState:
    """The inverse of state_to_dict; every malformed document raises
    ValueError (as checkpoint.py:43-62 of the JAX package)."""
    if not isinstance(d, dict):
        raise ValueError(f"checkpoint must be a JSON object, got {type(d).__name__}")
    if d.get("format") != FORMAT:
        raise ValueError(f"unknown state format {d.get('format')!r}")
    try:
        c = d["camera"]
        if np.asarray(c["pos"], np.float32).shape != (3,):
            raise ValueError(
                f"camera.pos must be 3 scalars, got {c['pos']!r}")
        for key in ("sky_vars", "recolor_vars"):
            if np.asarray(d[key], np.float32).shape != (4,):
                raise ValueError(f"{key} must be 4 scalars, got {d[key]!r}")
        return _build_state(d, c)
    except (KeyError, TypeError) as e:
        raise ValueError(f"malformed checkpoint: {e!r}") from e


def _f32(v) -> torch.Tensor:
    return torch.tensor(np.asarray(v, np.float32))


def _build_state(d, c):
    return FrameState(
        cam=Camera(pos=_f32(c["pos"]), hor_angle=_f32(c["hor_angle"]),
                   ver_angle=_f32(c["ver_angle"]), fov=_f32(c["fov"])),
        day_time=_f32(d["day_time"]),
        play=torch.tensor(bool(d["play"])),
        sea_y=_f32(d["sea_y"]),
        aa=torch.tensor(bool(d["aa"])),
        sky_vars=_f32(d["sky_vars"]),
        recolor_vars=_f32(d["recolor_vars"]),
    )


def save_state(state: FrameState, path: str) -> None:
    with open(path, "w") as f:
        json.dump(state_to_dict(state), f, indent=2)


def load_state(path: str, device="cpu") -> FrameState:
    """The state saved at `path`, on `device`."""
    with open(path) as f:
        return state_to(state_from_dict(json.load(f)), device)
