"""Intersection tests as hoisted linear forms (port of
raytracing_cuda_tpu/ops/linear_forms.py), which the `fast` render path runs.

The reference tests rays against objects with per-pair vector math
(checkHit, kernel.cu:41-129): Möller-Trumbore materializes a cross product
per (ray, triangle) pair and the sphere test a center-offset vector per
(ray, sphere) pair. Every accept/reject quantity in those tests is linear in
a 12-dim per-ray feature vector

    F(o, d) = [d, o, m = o×d, o·d, |o|², 1]

with per-object constant coefficients. Scalar triple products split as
  det  = e1·(d×e2)            = d·(e2×e1)
  u·det = tvec·(d×e2)          = m·e2 + d·(v0×e2)          (tvec = o - v0)
  v·det = d·(tvec×e1)          = -m·e1 + d·(e1×v0)
  t·det = e2·(tvec×e1)         = o·n - v0·n                 (n = e1×e2)
and the geometric sphere test as
  tca  = (pos-o)·d             = d·pos - (o·d)
  |L|² = |pos-o|²              = |pos|² - 2 o·pos + |o|²
  d²   = |L|² - tca².

So one pass over all objects is a handful of (chunk, n_objects) elementwise
broadcasts with no (chunk, n_objects, 3) intermediates. The accept tests
compare det-scaled quantities instead of dividing (det ≥ 0.001 > 0 after
the backface cull, so inequalities keep their direction, kernel.cu:104-126).

Epsilons and accept/reject logic match the reference (sphere
kernel.cu:47-69, plane :71-94, triangle :95-126).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracing_cuda_tpu_torch.core.math3d import cross3, dot3
from raytracing_cuda_tpu_torch.core.types import Scene
from raytracing_cuda_tpu_torch.ops.intersect import INF, lowest_index_winner


class TriPack(NamedTuple):
    """Per-triangle coefficient rows, each (T, 3) / (T,)."""

    c_det: torch.Tensor   # e2×e1: det = d·c_det
    a_u: torch.Tensor     # v0×e2: u·det = d·a_u + m·e2
    b_u: torch.Tensor     # e2
    a_v: torch.Tensor     # e1×v0: v·det = d·a_v − m·e1
    b_v: torch.Tensor     # e1
    n: torch.Tensor       # e1×e2: t·det = o·n − v0·n
    v0n: torch.Tensor     # (T,) v0·n


class SpherePack(NamedTuple):
    """Per-sphere coefficients, (S, 3) / (S,)."""

    pos: torch.Tensor   # centers
    pos2: torch.Tensor  # (S,) |pos|²
    r2: torch.Tensor    # (S,) radius²


class RayFeatures(NamedTuple):
    """Per-ray derived features, shapes (..., 3) / (...,)."""

    o: torch.Tensor
    d: torch.Tensor
    m: torch.Tensor    # o×d
    od: torch.Tensor   # o·d
    oo: torch.Tensor   # |o|²


def tri_pack(scene: Scene) -> TriPack:
    """Triangle coefficients from the scene's (v0, e1, e2): 78 rows for the
    island, derived once per frame."""
    v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
    n = cross3(e1, e2)
    return TriPack(c_det=cross3(e2, e1), a_u=cross3(v0, e2), b_u=e2,
                   a_v=cross3(e1, v0), b_v=e1, n=n, v0n=dot3(v0, n))


def sphere_pack(scene: Scene) -> SpherePack:
    """Per-frame sphere coefficients (sun/moon proxies move each frame)."""
    return SpherePack(pos=scene.sph_pos,
                      pos2=dot3(scene.sph_pos, scene.sph_pos),
                      r2=scene.sph_r * scene.sph_r)


def ray_features(o, d) -> RayFeatures:
    return RayFeatures(o=o, d=d, m=cross3(o, d), od=dot3(o, d), oo=dot3(o, o))


def _bdot(v, c):
    """(..., 3) per-ray vector × (K, 3) per-object rows → (..., K), as
    component broadcasts."""
    return (v[..., 0, None] * c[:, 0] + v[..., 1, None] * c[:, 1]
            + v[..., 2, None] * c[:, 2])


def tri_dets(tp: TriPack, F: RayFeatures):
    """det-scaled Möller-Trumbore quantities, each (..., T)."""
    det = _bdot(F.d, tp.c_det)
    u_det = _bdot(F.d, tp.a_u) + _bdot(F.m, tp.b_u)
    v_det = _bdot(F.d, tp.a_v) - _bdot(F.m, tp.b_v)
    t_det = _bdot(F.o, tp.n) - tp.v0n
    return det, u_det, v_det, t_det


def tri_hit_mask(det, u_det, v_det, t_det):
    """Backface cull + barycentric + t ≥ 0 (kernel.cu:104-126).

    u+v ≤ 1 with u,v ≥ 0 implies u ≤ 1, so that reference test is subsumed.
    """
    return ((det >= 0.001) & (u_det >= 0) & (v_det >= 0)
            & (u_det + v_det <= det) & (t_det >= 0))


def sphere_terms(sp: SpherePack, F: RayFeatures):
    """(tca, d2) geometric-method terms, each (..., S) (kernel.cu:47-69)."""
    tca = _bdot(F.d, sp.pos) - F.od[..., None]
    ll = sp.pos2 - 2.0 * _bdot(F.o, sp.pos) + F.oo[..., None]
    d2 = ll - tca * tca
    return tca, d2


def sphere_hit_mask(sp: SpherePack, tca, d2):
    return (tca > 0) & (d2 < sp.r2) & (d2 > -0.01)


def plane_terms(scene: Scene, F: RayFeatures):
    """(denom, t_num) for the sea plane (kernel.cu:71-94), each (...,)."""
    pn = scene.plane_normal
    denom = dot3(F.d, pn)
    t_num = dot3(scene.plane_pos, pn) - dot3(F.o, pn)
    return denom, t_num


def nearest_hit_fast(scene: Scene, tp: TriPack, sp: SpherePack,
                     F: RayFeatures):
    """Closest-hit over all objects (kernel.cu:144-151).

    Returns (hit_any (...,), t (...,), winner_gidx (...,) int32). Ties
    resolve to the lowest reference object index like the sequential
    strict-'<' scan.
    """
    det, u_det, v_det, t_det = tri_dets(tp, F)
    tri_hit = tri_hit_mask(det, u_det, v_det, t_det)
    t_tri = torch.where(tri_hit, t_det / torch.where(tri_hit, det, 1.0), INF)

    tca, d2 = sphere_terms(sp, F)
    sph_hit = sphere_hit_mask(sp, tca, d2)
    t_sph = torch.where(
        sph_hit, tca - torch.sqrt(torch.clamp(sp.r2 - d2, min=0.0)), INF)

    denom, t_num = plane_terms(scene, F)
    t_pl = t_num / denom
    pl_hit = (denom * denom > 0.00001) & (t_pl >= 0)
    t_pl = torch.where(pl_hit, t_pl, INF)

    t = torch.cat([t_pl[..., None], t_tri, t_sph], dim=-1)
    gidx = torch.cat([torch.zeros(1, dtype=torch.int32, device=t.device),
                      scene.tri_gidx, scene.sph_gidx])
    return lowest_index_winner(t, gidx)


def occluded_fast(scene: Scene, tp: TriPack, sp: SpherePack, sph_blocks,
                  F: RayFeatures, max_dist):
    """Hard-shadow query (kernel.cu:188-193): any non-light object with
    t < max_dist. Division- and sqrt-free but for the plane.

    sph_blocks: (S,) bool — light proxy spheres never occlude.
    """
    det, u_det, v_det, t_det = tri_dets(tp, F)
    tri_hit = tri_hit_mask(det, u_det, v_det, t_det)
    # t < dist  ⟺  t_det < dist·det   (det > 0 after cull)
    any_tri = torch.any(tri_hit & (t_det < max_dist[..., None] * det), dim=-1)

    tca, d2 = sphere_terms(sp, F)
    sph_hit = sphere_hit_mask(sp, tca, d2) & sph_blocks
    # t = tca − thc < dist ⟺ tca − dist < thc; thc ≥ 0 so either tca < dist
    # or (tca−dist)² < thc² = r² − d2.
    delta = tca - max_dist[..., None]
    closer = (delta < 0) | (delta * delta < sp.r2 - d2)
    any_sph = torch.any(sph_hit & closer, dim=-1)

    denom, t_num = plane_terms(scene, F)
    t_pl = t_num / denom
    any_pl = (denom * denom > 0.00001) & (t_pl >= 0) & (t_pl < max_dist)
    return any_pl | any_tri | any_sph
