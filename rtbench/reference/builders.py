"""Procedural scene construction (a frozen copy of the island part of
raytracing_cuda_tpu_torch/scene/builders.py).

scene.cpp:177-488, 634-651. Builds the 133-object winter-island scene with
numpy on the host in float32, trig evaluated in float64 and rounded,
matching the C++ float3/double-libm mix. The finished struct-of-arrays
Scene holds CPU torch tensors. The reference's vecTree/vecMount recolor
index lists become boolean masks.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference.math3d import to_rad
from rtbench.reference.structs import (N_LIGHTS, N_OBJECTS, PLANE,
                                                  SPHERE, TRIANGLE, Lights,
                                                  Scene)

f32 = np.float32


def _rot_y(v, a):
    """Host rotY (transforms.h:15-22): double trig rounded to f32, f32 dot."""
    c = f32(np.cos(np.float64(a)))
    s = f32(np.sin(np.float64(a)))
    x, y, z = f32(v[0]), f32(v[1]), f32(v[2])
    return np.array([c * x + s * z, y, -s * x + c * z], f32)


class _SceneAccum:
    """Append-only object list mirroring the reference's Object* array."""

    def __init__(self):
        self.obj_type: list[int] = []
        self.color: list[np.ndarray] = []
        self.shine: list[float] = []
        self.specular: list[float] = []
        self.mirror: list[float] = []
        self.is_light: list[bool] = []
        # sphere: pos + radius; plane: pos + normal; triangle: v0/v1/v2
        self.p0: list[np.ndarray] = []
        self.p1: list[np.ndarray] = []
        self.p2: list[np.ndarray] = []
        self.vec_tree: list[int] = []
        self.vec_mount: list[int] = []
        self.vec_light: list[int] = []

    @property
    def i(self) -> int:
        return len(self.obj_type)

    def _push(self, typ, color, shine, specular, mirror, p0, p1, p2,
              light=False):
        self.obj_type.append(typ)
        self.color.append(np.asarray(color, f32))
        self.shine.append(f32(shine))
        self.specular.append(f32(specular))
        self.mirror.append(f32(mirror))
        self.is_light.append(bool(light))
        self.p0.append(np.asarray(p0, f32))
        self.p1.append(np.asarray(p1, f32))
        self.p2.append(np.asarray(p2, f32))

    def sphere(self, color, mirror, specular, shine, pos, size, light=False):
        """createSphere (scene.cpp:177-187)."""
        self._push(SPHERE, color, shine, specular, mirror, pos,
                   np.array([size, size, size], f32), np.zeros(3, f32), light)

    def plane(self, color, mirror, specular, shine, pos, normal):
        """createGround (scene.cpp:326-336)."""
        self._push(PLANE, color, shine, specular, mirror, pos, normal,
                   np.zeros(3, f32))

    def triangle(self, color, mirror, specular, shine, v0, v1, v2):
        self._push(TRIANGLE, color, shine, specular, mirror, v0, v1, v2)


def _add(a, b):
    return (np.asarray(a, f32) + np.asarray(b, f32)).astype(f32)


def _rgb_scaled(r, g, b, *factors):
    v = np.array([r, g, b], f32)
    v = (v * f32(1.0 / 255.0)).astype(f32)
    for fac in factors:
        v = (v * f32(fac)).astype(f32)
    return v


def create_snowman(s: _SceneAccum, offset, a):
    """createSnowman (scene.cpp:189-243): 11 spheres. `a` is radians."""
    white = (np.array([1, 1, 1], f32) * f32(0.8)).astype(f32)
    black = np.zeros(3, f32)
    mirror, specular, shine = 0.0, 1.0, 0.05

    def part(color, size, pos):
        s.sphere(color, mirror, specular, shine, _add(_rot_y(pos, a), offset),
                 size)

    part(white, 2.0, [0, 0, 0])            # belly
    part(white, 1.3, [0, 3, 0])            # head
    part(black, 0.2, [0.35, 3.2, 1.15])    # eyes
    part(black, 0.2, [-0.35, 3.2, 1.15])
    part(black, 0.1, [0.2, 2.3, 1.05])     # mouth
    part(black, 0.1, [-0.2, 2.3, 1.05])
    part(black, 0.1, [0.55, 2.5, 1.05])
    part(black, 0.1, [-0.55, 2.5, 1.05])
    part(black, 0.2, [0, 1, 1.6])          # buttons
    part(black, 0.2, [0, 0.3, 1.85])
    part(black, 0.2, [0, -0.5, 1.8])


def create_pyramid(s: _SceneAccum, color, mirror, specular, shine, pos, base,
                   height, angle):
    """createPyramid (scene.cpp:245-296): 4 triangles (base + 3 sides)."""
    y, x = f32(0.86), f32(0.5)
    v = f32(y * f32(1.0) / f32(3.0))
    t = f32(0.5)
    tris = np.array([
        [0, 0, 0], [1, 0, 0], [x, 0, y],   # down
        [0, 0, 0], [x, t, v], [1, 0, 0],   # front
        [0, 0, 0], [x, 0, y], [x, t, v],   # left
        [x, 0, y], [1, 0, 0], [x, t, v],   # right
    ], f32)
    # center, rotate, scale (non-uniform), offset — in the reference's order
    tris[:, 0] -= x
    tris[:, 2] -= v
    rad = to_rad(f32(angle))
    for k in range(12):
        p = _rot_y(tris[k], rad)
        p[0] *= f32(base)
        p[1] *= f32(height)
        p[2] *= f32(base)
        tris[k] = _add(p, pos)
    for k in range(4):
        s.triangle(color, mirror, specular, shine, tris[3 * k],
                   tris[3 * k + 1], tris[3 * k + 2])


def create_tree(s: _SceneAccum, offset, angle):
    """createTree (scene.cpp:298-324): top pyramid (recolorable) + trunk."""
    color1 = _rgb_scaled(100, 80, 200, 0.8)
    color2 = np.array([0.5, 0, 0], f32)
    mirror, specular, shine = 0.1, 1.0, 0.0
    create_pyramid(s, color1, mirror, specular, shine, _add([0, -1, 0], offset),
                   7, 19, angle)
    s.vec_tree.extend([s.i - 1, s.i - 2, s.i - 3, s.i - 4])
    create_pyramid(s, color2, mirror, specular, shine, _add([0, -2, 0], offset),
                   4, 8, angle)


def create_ground(s: _SceneAccum, offset):
    """createGround (scene.cpp:326-336): the mirror sea plane."""
    s.plane(_rgb_scaled(0, 0, 30), 0.6, 256, 0, offset,
            np.array([0, 1, 0], f32))


def create_mountain(s: _SceneAccum, offset, size, angle):
    """createMountain (scene.cpp:338-350): one recolorable pyramid."""
    color = _rgb_scaled(18, 31, 60, 0.4)
    create_pyramid(s, color, 0, 256, 0, offset, size, f32(1.5) * f32(size),
                   angle)
    s.vec_mount.extend([s.i - 1, s.i - 2, s.i - 3, s.i - 4])


def create_island(s: _SceneAccum, offset, size, d):
    """createIsland (scene.cpp:352-414): a 10-triangle box (recolorable)."""
    color = _rgb_scaled(100, 80, 200, 0.8)
    mirror, specular, shine = 0.1, 1.0, 0.0
    p = np.array([
        [0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1],
        [0, -d, 0], [1, -d, 0], [1, -d, 1], [0, -d, 1],
    ], f32)
    order = [0, 2, 1, 0, 3, 2,     # up
             4, 1, 5, 4, 0, 1,     # front
             6, 3, 7, 6, 2, 3,     # back
             5, 2, 6, 5, 1, 2,     # right
             7, 0, 4, 7, 3, 0]     # left
    tris = p[order].copy()
    tris[:, 0] = ((tris[:, 0] - f32(0.5)) * f32(size)).astype(f32)
    tris[:, 2] = ((tris[:, 2] - f32(0.5)) * f32(size)).astype(f32)
    tris = (tris + np.asarray(offset, f32)).astype(f32)
    for k in range(10):
        s.vec_tree.append(s.i)
        s.triangle(color, mirror, specular, shine, tris[3 * k],
                   tris[3 * k + 1], tris[3 * k + 2])


def create_igloo(s: _SceneAccum, offset, size1, size2):
    """createIgloo (scene.cpp:416-431): main dome + entry spheres."""
    white = (np.array([1, 1, 1], f32) * f32(0.8)).astype(f32)
    s.sphere(white, 0, 1, 0.05, _add([0, 0, 0], offset), size1)
    s.sphere(white, 0, 1, 0.05, _add([-6, 0, 6], offset), size2)


def create_light_objects(s: _SceneAccum, light_pos):
    """createLightObjects (scene.cpp:433-442): emissive sun/moon proxies."""
    s.vec_light.append(s.i)
    s.sphere(np.array([1, 0.8, 0.05], f32), 0, 0, 0, light_pos[0], 50,
             light=True)
    s.vec_light.append(s.i)
    s.sphere(np.array([0.9, 0.9, 1], f32), 0, 0, 0, light_pos[1], 50,
             light=True)


def init_lights() -> Lights:
    """initLights (scene.cpp:634-652): sun + moon, white, intensity 1."""
    return Lights(pos=torch.tensor([[-1000, 1000, 1000]] * 2,
                                   dtype=torch.float32),
                  color=torch.ones((N_LIGHTS, 3), dtype=torch.float32),
                  intensity=torch.ones(N_LIGHTS, dtype=torch.float32))


def build_objects() -> _SceneAccum:
    """initObjects (scene.cpp:444-488): the full 133-object scene."""
    s = _SceneAccum()
    level = -4.5
    create_ground(s, np.array([0, level, 0], f32))
    create_island(s, np.array([0, -4, 0], f32), 50, 2)
    create_snowman(s, np.array([-4, -2, 17], f32), to_rad(f32(-50)))
    create_snowman(s, np.array([-15, -2, 5], f32), to_rad(f32(-20)))
    create_tree(s, np.array([-22, -2, -10], f32), 90)
    create_tree(s, np.array([-10, -2, -20], f32), 90)
    create_tree(s, np.array([0, -2, -20], f32), 80)
    create_tree(s, np.array([17, -2, 2], f32), 90)
    create_tree(s, np.array([20, -2, 9], f32), 80)
    create_tree(s, np.array([12, -2, 22], f32), 70)

    # mountains: positions (incl. y = level) scaled by d = 4
    # (scene.cpp:464-479), built walking the ring so ISLAND_TRI_CLUSTERS
    # carves them into contiguous adjacent pairs
    d = f32(4)

    def mnt(ox, oz, size, angle):
        off = (np.array([ox, level, oz], f32) * d).astype(f32)
        create_mountain(s, off, f32(size) * d, angle)

    mnt(170, 0, 100, 0)     # east
    mnt(100, 30, 70, 0)
    mnt(100, -40, 50, 30)
    mnt(90, -100, 110, 45)  # south
    mnt(20, -100, 70, 0)
    mnt(-35, -90, 100, 0)
    mnt(-80, -40, 80, 0)    # west (sunset)
    mnt(-100, 65, 100, 0)
    mnt(-70, 100, 90, 0)    # north (sunrise)
    mnt(25, 140, 100, 0)
    mnt(60, 90, 50, 0)
    mnt(130, 90, 100, 0)

    create_igloo(s, np.array([4, -4, -4], f32), 10, 6)
    create_light_objects(s, init_lights().pos.numpy())
    if s.i != N_OBJECTS:
        raise RuntimeError(f"expected {N_OBJECTS} objects, built {s.i}")
    return s


def build_scene() -> Scene:
    """The island Scene (CPU float32 tensors)."""
    return _finalize_scene(build_objects())


def _finalize_scene(s: _SceneAccum) -> Scene:
    """Accumulated object list → struct-of-arrays Scene."""
    n = s.i
    obj_type = np.array(s.obj_type, np.int32)
    p0 = np.stack(s.p0)
    p1 = np.stack(s.p1)
    p2 = np.stack(s.p2)

    sph = np.nonzero(obj_type == SPHERE)[0].astype(np.int32)
    tri = np.nonzero(obj_type == TRIANGLE)[0].astype(np.int32)
    (pl,) = np.nonzero(obj_type == PLANE)[0]

    center = np.zeros((n, 3), f32)
    center[sph] = p0[sph]
    static_normal = np.zeros((n, 3), f32)
    static_normal[pl] = p1[pl]
    e1 = (p1[tri] - p0[tri]).astype(f32)
    e2 = (p2[tri] - p0[tri]).astype(f32)
    tn = np.cross(e1, e2).astype(f32)
    tn = (tn * (1.0 / np.sqrt(np.sum(tn * tn, -1, keepdims=True)))).astype(f32)
    static_normal[tri] = tn

    tree_mask = np.zeros(n, bool)
    tree_mask[s.vec_tree] = True
    mount_mask = np.zeros(n, bool)
    mount_mask[s.vec_mount] = True

    arrays = dict(
        obj_type=obj_type, color=np.stack(s.color),
        shine=np.array(s.shine, f32), specular=np.array(s.specular, f32),
        mirror=np.array(s.mirror, f32), is_light=np.array(s.is_light, bool),
        center=center, static_normal=static_normal,
        sph_gidx=sph, sph_pos=p0[sph], sph_r=p1[sph, 0],
        tri_gidx=tri, tri_v0=p0[tri], tri_e1=e1, tri_e2=e2,
        plane_pos=p0[pl], plane_normal=p1[pl],
        tree_mask=tree_mask, mount_mask=mount_mask)
    return Scene(**{k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in arrays.items()})
