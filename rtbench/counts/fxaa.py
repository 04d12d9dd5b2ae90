"""Kernel B's function (csrc/fxaa.cu `fxaa_kernel`): FXAA over the uint8
frame.

Inputs, read once: the frame and its two halo rows. Outputs, written once:
the frame. Operations: 19 an interior pixel (its luminance, 7, and the
contrast test, 12); the blend of an edge pixel is not charged, as the
count of edges needs the frame before FXAA, which the timed path keeps to
itself.
"""

from __future__ import annotations

from rtbench.counts import Count

OPS_PIXEL = 19


def count(width: int, height: int) -> Count:
    return Count(3 * width * (height + 2) + 3 * width * height,
                 OPS_PIXEL * (width - 2) * (height - 2))
