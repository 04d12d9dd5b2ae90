"""Vectorized ray-primitive intersection (checkHit, kernel.cu:41-129).

Port of raytracing_cuda_tpu/ops/intersect.py: plain PyTorch ops on the
device of the rays, which the `oracle` render path runs.

Each routine tests a batch of rays against all primitives of one type at
once, masked lanes instead of branches, and nearest-hit and occlusion
reductions replace the reference's sequential loops (kernel.cu:144-151,
188-193).

Epsilon constants and accept/reject comparisons match the reference
(sphere kernel.cu:47-69, plane :71-94, Möller-Trumbore triangle :95-126),
quirks included: sphere hits keep a possibly negative near-root distance,
the sphere window compares float32 d2 with float32(-0.01), the plane normal
is never flipped toward the ray, triangles are backface-culled with
det < 0.001, and ties on t resolve to the lowest reference object index.

Lanes that miss carry garbage (a division by a zero determinant, a
parallel ray's plane distance): inf or NaN that the hit mask discards.
"""

from __future__ import annotations

import torch

from rtbench.reference.math3d import cross3, dot3
from rtbench.reference.structs import Scene

INF = float("inf")
_NO_WINNER = 10_000     # above every object index


def intersect_spheres(o, d, pos, r):
    """Geometric sphere test (kernel.cu:47-69).

    o, d: (..., 3) ray origins/directions. pos: (S, 3), r: (S,).
    Returns (hit (..., S) bool, t (..., S) f32). t is tca - thc and may be
    negative (origin inside the sphere) like the reference's.
    """
    L = pos - o[..., None, :]              # (..., S, 3)
    tca = dot3(L, d[..., None, :])         # (..., S)
    d2 = dot3(L, L) - tca * tca
    r2 = r * r
    hit = (tca > 0) & (d2 < r2) & (d2 > -0.01)
    thc = torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    return hit, tca - thc


def intersect_plane(o, d, ppos, pnormal):
    """Infinite plane test (kernel.cu:71-94). Returns (hit (...,), t (...,))."""
    denom = dot3(d, pnormal)
    t = dot3(ppos - o, pnormal) / denom
    hit = (denom * denom > 0.00001) & (t >= 0)
    return hit, t


def intersect_triangles(o, d, v0, e1, e2):
    """Möller-Trumbore with backface cull (kernel.cu:95-126).

    v0, e1, e2: (T, 3) with e1 = v1-v0, e2 = v2-v0.
    Returns (hit (..., T) bool, t (..., T)).
    """
    d_ = d[..., None, :]                   # (..., 1, 3)
    pvec = cross3(d_, e2)                  # (..., T, 3)
    det = dot3(e1, pvec)                   # (..., T)
    inv_det = 1.0 / det
    tvec = o[..., None, :] - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(d_, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    hit = ((det >= 0.001) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
           & (t >= 0))
    return hit, t


def _masked(hit, t):
    return torch.where(hit, t, INF)


def all_hits(scene: Scene, o, d):
    """Distances to every object: (t (..., N_concat), gidx (N_concat,)).

    Concat order is [plane, triangles, spheres]; gidx carries each slot's
    reference object index for tie-breaking and attribute gathers. Misses
    are +inf.
    """
    hit_p, t_p = intersect_plane(o, d, scene.plane_pos, scene.plane_normal)
    hit_t, t_t = intersect_triangles(o, d, scene.tri_v0, scene.tri_e1,
                                     scene.tri_e2)
    hit_s, t_s = intersect_spheres(o, d, scene.sph_pos, scene.sph_r)
    t = torch.cat([_masked(hit_p, t_p)[..., None], _masked(hit_t, t_t),
                   _masked(hit_s, t_s)], dim=-1)
    gidx = torch.cat([torch.zeros(1, dtype=torch.int32, device=t.device),
                      scene.tri_gidx, scene.sph_gidx])
    return t, gidx


def lowest_index_winner(t, gidx):
    """(hit_any, t_min, winner) of masked distances t (..., N) with object
    indices gidx (N,): the strict '<' scan's winner, the lowest index among
    the slots at t_min; -1 where every slot missed (all +inf, where
    t == t_min holds in every slot)."""
    t_min = torch.amin(t, dim=-1)
    hit_any = torch.isfinite(t_min)
    winner = torch.amin(torch.where(t == t_min[..., None], gidx, _NO_WINNER),
                        dim=-1)
    return hit_any, t_min, torch.where(hit_any, winner, -1)


def nearest_hit(scene: Scene, o, d):
    """Closest-hit query (kernel.cu:144-151).

    Returns (hit_any (...,), t_min (...,), winner_gidx (...,) int32).
    """
    return lowest_index_winner(*all_hits(scene, o, d))


def occluded(scene: Scene, o, d, max_dist):
    """Hard-shadow occlusion (kernel.cu:188-193).

    True where any non-emissive object intersects the ray closer than
    max_dist (...,). Light proxy spheres never occlude.
    """
    hit_p, t_p = intersect_plane(o, d, scene.plane_pos, scene.plane_normal)
    hit_t, t_t = intersect_triangles(o, d, scene.tri_v0, scene.tri_e1,
                                     scene.tri_e2)
    hit_s, t_s = intersect_spheres(o, d, scene.sph_pos, scene.sph_r)
    sph_blocks = ~scene.is_light[scene.sph_gidx.long()]

    md = max_dist[..., None]
    any_tri = torch.any(hit_t & (t_t < md), dim=-1)
    any_sph = torch.any(hit_s & sph_blocks & (t_s < md), dim=-1)
    any_pl = hit_p & (t_p < max_dist)
    return any_pl | any_tri | any_sph
