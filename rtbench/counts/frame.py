"""The whole frame's function (`Engine.step_and_frame`): one packed action
in, the state stepped, one uint8 frame out.

Inputs, read once: the action vector, the state and the scene (the sky's
texels are charged nothing: how many a frame needs depends on what it
sees). Outputs, written once: the frame and the state. Operations: a
pixel's ray set-up and shading (kernel A's) and its FXAA (kernel B's).
"""

from __future__ import annotations

from rtbench.counts import Count, scene_bytes
from rtbench.counts import fxaa, raytrace

STATE_BYTES = 4 * 16 + 2 * 4 * 18     # the action; the state read, written


def count(width: int, height: int, objects: dict) -> Count:
    px = width * height
    return Count(STATE_BYTES + scene_bytes(objects) + 3 * px,
                 px * (raytrace.OPS_RAY + raytrace.OPS_SHADE)
                 + fxaa.count(width, height).ops)
