"""Roofline counts: the least work of each function the frame runs, from
the frame's shapes and the scene's published sizes alone, and the card's
published peaks (peaks.json).

A count charges the bytes of the function's inputs, read once, the bytes of
its outputs, written once, and the least operations a pixel needs. It never
reads the program's cull table, cluster bounds or tiling, so any
implementation of the same function is charged the same work and none can
read over 100 % of its roofline. Where a later change merges two stages
into one kernel, the merged function is charged the sum of its stages'
counts.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


class Count(NamedTuple):
    """A function's least work: bytes moved once and float32 operations."""

    nbytes: float
    ops: float

    def seconds(self, peaks: dict = PEAKS) -> float:
        """The least time on the card: the larger of the bytes at the
        peak bandwidth and the operations at the peak float32 rate."""
        return max(self.nbytes / peaks["bytes_per_s"],
                   self.ops / peaks["f32_ops_per_s"])

    def bound_by(self, peaks: dict = PEAKS) -> str:
        return ("bytes" if self.nbytes / peaks["bytes_per_s"]
                >= self.ops / peaks["f32_ops_per_s"] else "operations")

    def __add__(self, other: "Count") -> "Count":
        return Count(self.nbytes + other.nbytes, self.ops + other.ops)


# float32 words of the scene's published objects (kernel A's input):
# a triangle's three vertices and its material (color, shine, specular,
# mirror); a sphere's center, radius and material; the plane's point,
# normal and material; the two lights (position, color, intensity), the
# camera's position and four frustum corners, the ambient color
WORDS = {"triangles": 9 + 6, "spheres": 4 + 6, "planes": 6 + 6}
FRAME_WORDS = 2 * 7 + 5 * 3 + 3


def scene_bytes(objects: dict) -> int:
    """The bytes of the scene a frame reads: its objects (`objects`, the
    configuration's counts by kind) and the frame's lights and camera."""
    return 4 * (sum(WORDS[k] * n for k, n in objects.items()) + FRAME_WORDS)
