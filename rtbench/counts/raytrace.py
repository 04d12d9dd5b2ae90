"""Kernel A's function (csrc/raytrace.cu `raytrace_kernel`): every pixel's
ray traced through the scene, out as 7 float32 planes (rgb, the sky's
weight and the direction it is looked up in).

Inputs, read once: the scene (counts.scene_bytes). Outputs, written once:
7 float32 planes a pixel. Operations: one ray's set-up and one shading a
pixel; no intersection test is charged, so no cull or acceleration
structure is assumed.
"""

from __future__ import annotations

from rtbench.counts import Count, scene_bytes

PLANES = 7
OPS_RAY = 24        # the primary ray from the frustum corners, normalised
OPS_SHADE = 200     # one hit's Phong with two lights, and its reflection


def count(width: int, height: int, objects: dict) -> Count:
    px = width * height
    return Count(scene_bytes(objects) + 4 * PLANES * px,
                 px * (OPS_RAY + OPS_SHADE))
