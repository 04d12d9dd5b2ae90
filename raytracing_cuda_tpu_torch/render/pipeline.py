"""Per-frame render pipeline (port of raytracing_cuda_tpu/render/pipeline.py,
`render_frame_static_sky` and `_pallas_base`, pipeline.py:83-152).

One frame is: derive the frame's scene and rays on the host, pack them into
the coefficient table and params vector, then on the device run the
megakernel (7 planes), the flat pair sky lookup from the static panorama
stack, `quantize(rgb + mw·sky)` (reference.py:139-142), and FXAA when the
state's toggle is on. The reference's launchKernel (kernel.cu:406-462) has
the same split: host state and constant uploads, then kernels.
"""

from __future__ import annotations

import torch

from raytracing_cuda_tpu_torch.core.types import Scene
from raytracing_cuda_tpu_torch.render.cuda_rt import (
    MAX_CLUSTERS, P_CLUSTERS, cluster_bounds, pack_params, pack_scene,
    raytrace_planes, sph_cluster_norm, tri_cluster_pads)
from raytracing_cuda_tpu_torch.render.fxaa import apply_fxaa
from raytracing_cuda_tpu_torch.scene.textures import sample_sky_packed_pair
from raytracing_cuda_tpu_torch.sim.state import (FrameState, camera_rays,
                                                 derive_frame)


def quantize(color: torch.Tensor) -> torch.Tensor:
    """rgbToInt packing (kernel.cu:26-32): clamp(c*255, 0, 255), truncate."""
    return torch.clamp(color * 255.0, 0.0, 255.0).to(torch.uint8)


def host_packs(scene: Scene, state: FrameState, height: int, width: int,
               aspect: float | None = None, tri_clusters=None,
               sph_clusters=None, t_subs=None):
    """Host half of a frame (derive_frame, camera_rays, then the packing of
    render_base_planes_pallas, pallas_rt.py:1226-1254) → (coef, params,
    n_tri_rows, n_sph_rows), float32 on the host."""
    if t_subs and not tri_clusters:
        raise ValueError("t_subs requires tri_clusters")
    if aspect is None:
        aspect = width / height
    scene_f, lights, ambient = derive_frame(scene, state)
    rays = camera_rays(state.cam, aspect)
    coef = pack_scene(scene_f, tri_clusters, sph_clusters)
    params = pack_params(rays, lights, ambient, scene_f.plane_pos[1])
    bounds = cluster_bounds(scene_f, tri_clusters, sph_clusters,
                            t_subs).reshape(-1)
    if bounds.numel() > 4 * MAX_CLUSTERS:
        raise ValueError(f"{bounds.numel() // 4} cull bounds exceed "
                         f"MAX_CLUSTERS={MAX_CLUSTERS}")
    params[P_CLUSTERS:P_CLUSTERS + bounds.numel()] = bounds
    n_tri_rows = sum(tri_cluster_pads(scene_f.n_triangles, tri_clusters))
    n_sph_rows = sum(sph_cluster_norm(scene_f.n_spheres, sph_clusters)[1])
    return coef, params, n_tri_rows, n_sph_rows


def _base(coef, params, n_tri_rows: int, n_sph_rows: int, sky_pack,
          sky_h: int, sky_w: int, state: FrameState, height: int,
          width: int) -> torch.Tensor:
    """Device half before FXAA: megakernel + deferred sky + quantize →
    (height, width, 3) uint8 on the device of `coef`."""
    r, g, b, mw, mdx, mdy, mdz = raytrace_planes(coef, params, height, width,
                                                 n_tri_rows, n_sph_rows)
    mdir = torch.stack([mdx, mdy, mdz], dim=-1)
    sky = sample_sky_packed_pair(sky_pack, sky_h, sky_w, mdir,
                                 state.day_time / 24.0, state.sky_vars)
    return quantize(torch.stack([r, g, b], dim=-1) + mw[..., None] * sky)


def render_frame_static_sky(scene: Scene, state: FrameState, sky_pack,
                            sky_h: int, sky_w: int, height: int, width: int,
                            aspect: float | None = None, tri_clusters=None,
                            sph_clusters=None, t_subs=None) -> torch.Tensor:
    """One frame from the static (4, H*W) sky stack → (H, W, 3) uint8 on the
    device of `sky_pack`."""
    coef, params, nt, ns = host_packs(scene, state, height, width, aspect,
                                      tri_clusters, sph_clusters, t_subs)
    dev = sky_pack.device
    base = _base(coef.to(dev), params.to(dev), nt, ns, sky_pack, sky_h, sky_w,
                 state, height, width)
    return apply_fxaa(base, bool(state.aa))
