"""The frame's packs on a card: one launch of csrc/packs.cu over a base
packed once per scene layout.

`pipeline.frame_packs_torch` derives a frame's scene, lights and rays and
packs the whole coefficient table and params vector anew each frame, about
540 small torch kernels. Almost all of what it writes is the same in every
frame: `derive_frame` changes only the colours of the tree- and
mountain-coloured rows and of the sea plane, the two light proxies' rows,
the bound of the sphere cluster(s) holding the lights and the params'
camera, lights, ambient and sea height.

`pack_base` packs the frame-invariant part once (a `PackBase`): the full
table and params of the scene as built, and, as data, the layout of what
moves (`moving_entries` lists it entry by entry). `pack_frame` then makes a
frame's packs in one launch that copies the base and recomputes only those
entries from the state, with the torch code's operations in its order, so
the two are equal bit for bit on the same card. On the CPU
`pipeline.frame_packs` runs the torch code, which reads no base.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from raytracing_cuda_tpu_torch.core.math3d import _DEG
from raytracing_cuda_tpu_torch.core.types import Scene
from raytracing_cuda_tpu_torch.render.cuda_rt import (
    C_CENTER, C_COL, C_POS2, MAX_CLUSTERS, N_CHANNELS, N_PARAMS, P_AMBIENT,
    P_CAMPOS, P_CLUSTERS, P_LCOL1, P_LINT, P_SEAY, cluster_bounds,
    cull_groups, pack_scene, sph_cluster_norm, tri_cluster_pads)
from raytracing_cuda_tpu_torch.sim.state import FrameState, device_constants

f32 = torch.float32

# a row's colour class (PackBase.row_class): static, or recoloured each
# frame from one of the palettes, in csrc/packs.cu's order
STATIC, TREE, MOUNT, LAKE = range(4)
PALETTES = ("MAT_TREE", "MAT_MOUNT", "MAT_LAKE", "MAT_AMBIENT")


class PackBase(NamedTuple):
    """The frame-invariant packs of one scene layout on one device, and
    where the frame's moving entries lie."""

    coef: torch.Tensor       # (R, N_CHANNELS) float32, the scene as built
    params: torch.Tensor     # (N_PARAMS,) float32: intensities, bounds
    row_class: torch.Tensor  # (R,) int32: STATIC, TREE, MOUNT or LAKE
    sph_r: torch.Tensor      # (R,) float32: a sphere row's radius, else 0
    moving: torch.Tensor     # (M, 3) int32: first row, rows, bound index
    lights: tuple            # the rows of the sun and moon proxies
    n_tri_rows: int
    n_sph_rows: int
    layout: tuple            # layout_key of the scene and clusters


def layout_key(scene: Scene, tri_clusters=None, sph_clusters=None,
               t_subs=None) -> tuple:
    """What a base must have been packed for: the scene's object counts and
    the rows under each cull bound (cull_groups)."""
    return (scene.n_triangles, scene.n_spheres,
            cull_groups(scene.n_triangles, scene.n_spheres, tri_clusters,
                        sph_clusters, t_subs))


def _object_rows(T: int, S: int, tri_clusters, sph_clusters):
    """The table row of each triangle and each sphere (pack_scene's
    layout) → ((T,), (S,)) int64 numpy."""
    rows, row = [], 1
    for cnt, pad in zip(tri_clusters or (T,),
                        tri_cluster_pads(T, tri_clusters)):
        rows.append(np.arange(row, row + cnt))
        row += pad
    tri = np.concatenate(rows)
    rows = []
    for cnt, pad in zip(*sph_cluster_norm(S, sph_clusters)[:2]):
        rows.append(np.arange(row, row + cnt))
        row += pad
    return tri, np.concatenate(rows)


def pack_base(scene: Scene, tri_clusters=None, sph_clusters=None,
              t_subs=None) -> PackBase:
    """The base of `scene`'s packs on its device: pack_scene and
    cluster_bounds of the scene as built (a frame's packs differ only in
    the entries moving_entries lists), each row's colour class as
    derive_frame recolours it (the sea plane from the lake palette, a
    mountain row from its own over a tree row's), the light proxies' rows
    (the last two spheres) and the sphere clusters that hold them. Built
    once per scene layout and device, outside any graph: it reads the
    scene's masks back to the host."""
    if t_subs and not tri_clusters:
        raise ValueError("t_subs requires tri_clusters")
    T, S = scene.n_triangles, scene.n_spheres
    if S < 2:
        raise ValueError(f"the scene has {S} spheres; its last two are the "
                         f"light proxies")
    dev = scene.color.device
    coef = pack_scene(scene, tri_clusters, sph_clusters)
    bounds = cluster_bounds(scene, tri_clusters, sph_clusters,
                            t_subs).reshape(-1)
    if bounds.numel() > 4 * MAX_CLUSTERS:
        raise ValueError(f"{bounds.numel() // 4} cull bounds exceed "
                         f"MAX_CLUSTERS={MAX_CLUSTERS}")
    params = torch.zeros(N_PARAMS, dtype=f32, device=dev)
    params[P_CLUSTERS:P_CLUSTERS + bounds.numel()] = bounds
    params[P_LINT:P_LINT + 2].fill_(1.0)         # move_lights' intensities

    tri_rows, sph_rows = _object_rows(T, S, tri_clusters, sph_clusters)
    tree = scene.tree_mask.cpu().numpy()
    mount = scene.mount_mask.cpu().numpy()
    obj_class = np.where(mount, MOUNT, np.where(tree, TREE, STATIC))
    row_class = np.zeros(coef.shape[0], np.int32)
    row_class[tri_rows] = obj_class[scene.tri_gidx.cpu().numpy()]
    row_class[sph_rows] = obj_class[scene.sph_gidx.cpu().numpy()]
    row_class[0] = LAKE                          # the sea plane, object 0
    sph_r = torch.zeros(coef.shape[0], dtype=f32, device=dev)
    sph_r[torch.from_numpy(sph_rows).to(dev)] = scene.sph_r

    key = layout_key(scene, tri_clusters, sph_clusters, t_subs)
    groups = key[2]
    s_counts = sph_cluster_norm(S, sph_clusters)[0]
    first_sph = len(groups) - len(s_counts)      # the sphere clusters' bounds
    moving, off = [], 0
    for k, cnt in enumerate(s_counts):
        if off + cnt > S - 2:                    # holds a light proxy
            moving.append((*groups[first_sph + k], first_sph + k))
        off += cnt
    return PackBase(
        coef=coef, params=params,
        row_class=torch.from_numpy(row_class).to(dev), sph_r=sph_r,
        moving=torch.tensor(moving, dtype=torch.int32).reshape(-1, 3).to(dev),
        lights=(int(sph_rows[S - 2]), int(sph_rows[S - 1])),
        n_tri_rows=sum(tri_cluster_pads(T, tri_clusters)),
        n_sph_rows=sum(sph_cluster_norm(S, sph_clusters)[1]), layout=key)


def base_to(base: PackBase, device) -> PackBase:
    """The base with every tensor on `device`."""
    return base._replace(**{name: getattr(base, name).to(device)
                            for name in ("coef", "params", "row_class",
                                         "sph_r", "moving")})


def moving_entries(base: PackBase):
    """What pack_frame writes over the base → (coef (R, N_CHANNELS),
    params (N_PARAMS,)) bool on the CPU: the colours of the classed rows;
    the light rows' centre, normal and |pos|²; the params' camera, corners,
    light positions and colours, ambient and sea height; the bounds of the
    clusters in `moving`. Every other entry of a frame's packs is the
    base's."""
    coef = torch.zeros(base.coef.shape, dtype=torch.bool)
    coef[base.row_class.cpu() != STATIC, C_COL:C_COL + 3] = True
    coef[list(base.lights), C_CENTER:C_POS2 + 1] = True
    params = torch.zeros(N_PARAMS, dtype=torch.bool)
    params[P_CAMPOS:P_LCOL1 + 3] = True
    params[P_AMBIENT:P_SEAY + 1] = True
    for _, _, g in base.moving.cpu().tolist():
        params[P_CLUSTERS + 4 * g:P_CLUSTERS + 4 * g + 4] = True
    return coef, params


def _tensor(name: str, t, device, dtype, shape) -> None:
    if (not isinstance(t, torch.Tensor) or t.dtype != dtype
            or t.device != device or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {device}, got "
                         f"{getattr(t, 'dtype', type(t))} "
                         f"{tuple(getattr(t, 'shape', ()))} on "
                         f"{getattr(t, 'device', None)}")


@functools.cache
def _library():
    """csrc/packs.cu built and loaded, its kernel's module loaded (so no
    capture loads it)."""
    from raytracing_cuda_tpu_torch import _build

    lib = _build.load("packs")
    lib.rt_packs_load.argtypes = []
    lib.rt_packs_load.restype = ctypes.c_int
    _build.check(lib, lib.rt_packs_load(), "loading the packs kernel")
    lib.rt_frame_packs.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 13 + [ctypes.c_float] * 2
        + [ctypes.c_void_p] * 3)
    lib.rt_frame_packs.restype = ctypes.c_int
    return lib


def pack_frame(base: PackBase, state: FrameState, aspect: float):
    """A frame's (coef, params) from `base` and `state` on the base's card:
    one launch of csrc/packs.cu on the current stream, counted on
    `launches`. aspect: width / height as the torch code reads it
    (float32). Raises on a base or state it does not take (another device,
    dtype or shape) and on a CPU base: the CPU runs
    pipeline.frame_packs_torch."""
    from raytracing_cuda_tpu_torch import _build

    dev = base.coef.device
    if dev.type != "cuda":
        raise ValueError(f"no packs kernel for device {dev}")
    R = base.coef.shape[0] if base.coef.ndim == 2 else 0
    _tensor("base.coef", base.coef, dev, f32, (R, N_CHANNELS))
    _tensor("base.params", base.params, dev, f32, (N_PARAMS,))
    _tensor("base.row_class", base.row_class, dev, torch.int32, (R,))
    _tensor("base.sph_r", base.sph_r, dev, f32, (R,))
    M = base.moving.shape[0] if base.moving.ndim == 2 else -1
    _tensor("base.moving", base.moving, dev, torch.int32, (M, 3))
    if not all(0 <= r < R for r in base.lights) or len(base.lights) != 2:
        raise ValueError(f"base.lights {base.lights} must be two rows of "
                         f"the {R}-row table")
    cam = state.cam
    fields = [("cam.pos", cam.pos, (3,))] + [
        (name, t, ()) for name, t in (
            ("cam.hor_angle", cam.hor_angle), ("cam.ver_angle", cam.ver_angle),
            ("cam.fov", cam.fov), ("day_time", state.day_time),
            ("sea_y", state.sea_y))] + [
        ("recolor_vars", state.recolor_vars, (4,))]
    c = device_constants(dev)
    consts = [(name, c[name], (4, 3)) for name in PALETTES] + [
        ("light_tilt", c["light_tilt"], ()),
        ("light_offset", c["light_offset"], (3,))]
    for name, t, shape in fields + consts:
        _tensor(name, t, dev, f32, shape)
    coef = torch.empty_like(base.coef)
    params = torch.empty_like(base.params)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rt_frame_packs(
            base.coef.data_ptr(), base.params.data_ptr(),
            base.row_class.data_ptr(), base.sph_r.data_ptr(),
            base.moving.data_ptr(), R, M, *base.lights,
            *(t.data_ptr() for _, t, _ in fields + consts),
            float(np.float32(aspect)), _DEG, coef.data_ptr(),
            params.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "packs kernel launch")
    pack_frame.launches += 1
    return coef, params


pack_frame.launches = 0
