"""Carry scenes and frame states in and out as plain numpy dicts.

A Scene or FrameState of either package becomes a dict of numpy arrays
(a NamedTuple's `_asdict()` after `np.asarray`, with the camera as a nested
dict or NamedTuple), so the same scene and state can be handed to both
packages without either importing the other.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracing_cuda_tpu_torch.core.types import Camera, Scene
from raytracing_cuda_tpu_torch.sim.state import FrameState


def _tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, copy=True))


def _fields(x) -> dict:
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def scene_from_numpy(fields) -> Scene:
    """Dict (or NamedTuple) of numpy arrays → Scene of CPU tensors."""
    fields = _fields(fields)
    return Scene(**{k: _tensor(fields[k]) for k in Scene._fields})


def state_from_numpy(fields) -> FrameState:
    """Dict (or NamedTuple) of numpy arrays, cam nested → FrameState."""
    fields = _fields(fields)
    cam = _fields(fields["cam"])
    return FrameState(
        cam=Camera(**{k: _tensor(np.asarray(cam[k], np.float32))
                      for k in Camera._fields}),
        **{k: _tensor(np.asarray(fields[k],
                                 bool if k in ("play", "aa") else np.float32))
           for k in FrameState._fields if k != "cam"})


def state_to_numpy(state: FrameState) -> dict:
    """FrameState (on any device) → dict of numpy arrays with the camera as
    a nested dict."""
    out = {k: v.cpu().numpy().copy() for k, v in state._asdict().items()
           if k != "cam"}
    out["cam"] = {k: v.cpu().numpy().copy()
                  for k, v in state.cam._asdict().items()}
    return out
