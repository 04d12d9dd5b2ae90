"""Scene, camera and light containers (a frozen copy of
raytracing_cuda_tpu_torch/core/types.py).

Struct-of-arrays form of the reference's AoS POD types (structs.h:8-51):
type-partitioned compact arrays for intersection, plus global per-object
attribute arrays in the reference's 0..132 object order for shading and
nearest-hit tie-breaking. Fields are torch tensors; the host state machine
keeps them on the CPU in float32.

Object type codes follow the reference Primitive enum (structs.h:21-25):
0 = SPHERE, 1 = PLANE, 2 = TRIANGLE.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SPHERE, PLANE, TRIANGLE = 0, 1, 2

N_OBJECTS = 133  # OBJECTS_NUMBER, scene.h:11
N_LIGHTS = 2     # LIGHTS_NUMBER, scene.h:12


class Camera(NamedTuple):
    """Camera state (structs.h:8-19 minus derived fields); angles in degrees."""

    pos: torch.Tensor        # (3,)
    hor_angle: torch.Tensor  # scalar
    ver_angle: torch.Tensor  # scalar
    fov: torch.Tensor        # scalar (40)


class CameraRays(NamedTuple):
    """Frustum corner directions (cameraHelperAngles, scene.cpp:100-126)."""

    pos: torch.Tensor  # (3,)
    LD: torch.Tensor   # (3,) left-down corner ray
    RD: torch.Tensor
    LU: torch.Tensor
    RU: torch.Tensor


class Lights(NamedTuple):
    """Point lights (structs.h:46-51): sun at row 0, moon at row 1."""

    pos: torch.Tensor        # (2, 3)
    color: torch.Tensor      # (2, 3)
    intensity: torch.Tensor  # (2,)


class Scene(NamedTuple):
    """The scene as struct-of-arrays.

    Global arrays are in the reference's construction order (initObjects,
    scene.cpp:444-488); the sun and moon proxies are the last two spheres.
    """

    obj_type: torch.Tensor       # (N,) int32
    color: torch.Tensor          # (N, 3) f32, rewritten per frame by recolor
    shine: torch.Tensor          # (N,)
    specular: torch.Tensor       # (N,)
    mirror: torch.Tensor         # (N,)
    is_light: torch.Tensor       # (N,) bool
    center: torch.Tensor         # (N, 3) sphere centers
    static_normal: torch.Tensor  # (N, 3) tri/plane unit normals
    sph_gidx: torch.Tensor       # (S,) int32
    sph_pos: torch.Tensor        # (S, 3)
    sph_r: torch.Tensor          # (S,)
    tri_gidx: torch.Tensor       # (T,) int32
    tri_v0: torch.Tensor         # (T, 3)
    tri_e1: torch.Tensor         # (T, 3) v1 - v0
    tri_e2: torch.Tensor         # (T, 3) v2 - v0
    plane_pos: torch.Tensor      # (3,), y is the live sea level
    plane_normal: torch.Tensor   # (3,)
    tree_mask: torch.Tensor      # (N,) bool, recolored with MAT_TREE
    mount_mask: torch.Tensor     # (N,) bool, recolored with MAT_MOUNT

    @property
    def n_spheres(self) -> int:
        return self.sph_pos.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.tri_v0.shape[0]
