"""Time-of-day material palettes.

Port of raytracing_cuda_tpu/scene/palettes.py.

scene.cpp:43-67. Each palette has 4 rows — morning / day / evening / night —
blended with the sky weights per frame. Integer RGB scaled by (1/255) and
optional extra factors, each multiply rounded to float32 like the C++ float3
operator* chain.
"""

from __future__ import annotations

import numpy as np


def _rgb(r, g, b, *factors):
    v = np.array([r, g, b], np.float32)
    v = (v * np.float32(1.0 / 255.0)).astype(np.float32)
    for f in factors:
        v = (v * np.float32(f)).astype(np.float32)
    return v


# matTree (scene.cpp:44-49): island + tree-top triangles
MAT_TREE = np.stack([
    _rgb(158, 114, 250),
    _rgb(218, 222, 255),
    _rgb(255, 166, 82),
    np.array([0.31, 0.25, 0.62], np.float32),
])

# matMount (scene.cpp:50-55)
MAT_MOUNT = np.stack([
    _rgb(224, 205, 255),
    _rgb(75, 111, 255),
    _rgb(255, 230, 103),
    np.array([0.02, 0.04, 0.09], np.float32),
])

# matLake (scene.cpp:56-61): the sea plane
MAT_LAKE = np.stack([
    _rgb(155, 4, 136),
    _rgb(20, 143, 248, 0.9),
    _rgb(255, 20, 20),
    np.array([0.0, 0.0, 0.0], np.float32),
])

# matAmbient (scene.cpp:62-67): global ambient tint
MAT_AMBIENT = np.stack([
    _rgb(139, 129, 197),
    _rgb(115, 136, 178, 0.7),
    _rgb(164, 132, 121),
    np.array([0.1, 0.2, 0.4], np.float32),
])

# initial ambient before the first recolor (scene.cpp:43)
AMBIENT_INIT = np.array([0.1, 0.2, 0.4], np.float32)
