"""Plain raytracer (a frozen copy of
raytracing_cuda_tpu_torch/render/reference.py, the port's `oracle` path):
the reference's raytracing megakernel (kernel.cu:131-259) as an iterative
bounce loop carrying (origin, direction, throughput, color, live-mask) over
masked lanes, batched intersections + reductions for the nearest-hit and
shadow loops, and the per-ray four-texture sky blend (kernel.cu:156-163)
through `sky.ProceduralSky.lookup`.

Plain PyTorch ops on the device of the rays, in their dtype (float32 for
the reference, bfloat16 for its control). Pixels are processed in
fixed-size chunks so the (chunk, objects, 3) intersection intermediates
stay bounded at any resolution.

Semantics preserved:
  - emissive short-circuit for sun/moon proxies (kernel.cu:169)
  - Phong: ambient tint, 2 lights, hard shadows over non-light objects,
    shadow/reflection ray epsilon 0.001 (kernel.cu:172-206)
  - mirror weighting refColor*kR + phong*(1-kR), depth 4, black beyond
    (kernel.cu:209-225)
  - final packing clamp(c*255, 0, 255) truncated to integer (kernel.cu:26-32)

Lanes that are dead or missed compute on garbage (hit_pos = o + d·inf, the
plane's attributes under a clamped winner index, pow of a NaN), which the
masks discard; directions stay finite, so every sky lookup is of a finite
direction.
"""

from __future__ import annotations

import torch

from rtbench.reference.math3d import dot3, normalize, true_div
from rtbench.reference.structs import (SPHERE, CameraRays, Lights,
                                                  Scene)
from rtbench.reference.intersect import nearest_hit, occluded

MAX_DEPTH = 4  # kernel.cu:11 — bounces run depths 0..MAX_DEPTH inclusive


def primary_rays(cam: CameraRays, height: int, width: int):
    """Per-pixel ray directions by bilinear frustum-corner interpolation
    (kernel.cu:244-253). Returns (height, width, 3) normalized directions
    on the device of `cam`, in its dtype."""
    dev, dt = cam.LD.device, cam.LD.dtype
    px = true_div(torch.arange(width, dtype=torch.float32, device=dev),
                  float(width - 1)).to(dt)[None, :, None]
    py = true_div(torch.arange(height, dtype=torch.float32, device=dev),
                  float(height - 1)).to(dt)[:, None, None]
    vd = cam.LD + (cam.RD - cam.LD) * px          # (1, W, 3)
    vu = cam.LU + (cam.RU - cam.LU) * px
    target = vu - (vu - vd) * py                  # (H, W, 3)
    return normalize(target)


def shade(scene: Scene, lights: Lights, ambient, o, d, t, gidx, shadow):
    """One bounce's shading of the nearest hits (kernel.cu:166-218).

    gidx (...,) is the winner per ray, -1 on a miss, whose lanes shade the
    plane's attributes at a hit point at infinity and are masked by the
    caller. shadow(hit_pos, sdir, sdist, need) → occluded (...,) bool for
    one light; need marks the lanes whose answer can matter (a lit,
    non-emissive hit). Returns (col, emissive, kr, phong, new_o, refl).
    """
    gi = torch.clamp(gidx, min=0).long()
    col = scene.color[gi]
    shine = scene.shine[gi]
    spec_exp = scene.specular[gi]
    kr = scene.mirror[gi]
    emissive = scene.is_light[gi]

    hit_pos = o + d * t[..., None]
    normal = torch.where((scene.obj_type[gi] == SPHERE)[..., None],
                         normalize(hit_pos - scene.center[gi]),
                         scene.static_normal[gi])

    # --- Phong with hard shadows (kernel.cu:172-206) ---
    phong = col * ambient
    for i in range(2):
        lvec = lights.pos[i] - hit_pos
        sdist = torch.sqrt(dot3(lvec, lvec))
        sdir = lvec / sdist[..., None]
        angle = torch.clamp(dot3(normal, sdir), min=0.0)
        occ = shadow(hit_pos, sdir, sdist,
                     (gidx >= 0) & ~emissive & (angle > 0))
        angle = torch.where(occ, 0.0, angle)
        phong = phong + (col * lights.color[i]) * (
            angle * lights.intensity[i])[..., None]

        light_dir = -sdir
        spec_dir = normalize(
            light_dir - 2.0 * dot3(normal, light_dir)[..., None] * normal)
        spec = (torch.pow(torch.clamp(-dot3(spec_dir, d), min=0.0), spec_exp)
                * shine * angle)
        phong = phong + torch.where(shine > 0, spec, 0.0)[..., None]

    # --- mirror bounce (kernel.cu:209-218) ---
    refl = normalize(d - 2.0 * dot3(normal, d)[..., None] * normal)
    return col, emissive, kr, phong, hit_pos + refl * 0.001, refl


def trace_image(scene: Scene, lights: Lights, ambient, sky_lookup, o, d):
    """Iterative trace (kernel.cu:131-225) over a batch of rays.

    o, d: (..., 3); sky_lookup(d) → the sky's (..., 3) color in [0, 1].
    Returns linear color (..., 3) in d's dtype (pre-quantization).
    """
    shape = d.shape[:-1]
    color_acc = torch.zeros(shape + (3,), dtype=d.dtype, device=d.device)
    throughput = torch.ones(shape, dtype=d.dtype, device=d.device)
    live = torch.ones(shape, dtype=torch.bool, device=d.device)

    def shadow(hit_pos, sdir, sdist, need):
        return occluded(scene, hit_pos + sdir * 0.001, sdir, sdist)

    for _ in range(MAX_DEPTH + 1):
        hit_any, t, gidx = nearest_hit(scene, o, d)

        # --- miss → sky (kernel.cu:154-163) ---
        sky_rgb = sky_lookup(d)
        miss = live & ~hit_any
        color_acc = color_acc + torch.where(
            miss[..., None], throughput[..., None] * sky_rgb, 0.0)

        col, emissive, kr, phong, new_o, refl = shade(
            scene, lights, ambient, o, d, t, gidx, shadow)

        # --- emissive sun/moon proxies (kernel.cu:169) ---
        lit = live & hit_any & emissive
        color_acc = color_acc + torch.where(
            lit[..., None], throughput[..., None] * col, 0.0)

        shaded = live & hit_any & ~emissive
        color_acc = color_acc + torch.where(
            shaded[..., None], (throughput * (1.0 - kr))[..., None] * phong,
            0.0)

        bounce_on = shaded & (kr > 0)
        o = torch.where(bounce_on[..., None], new_o, o)
        d = torch.where(bounce_on[..., None], refl, d)
        throughput = torch.where(bounce_on, throughput * kr, throughput)
        live = bounce_on
    return color_acc


def quantize(color: torch.Tensor) -> torch.Tensor:
    """rgbToInt packing (kernel.cu:26-32): clamp(c*255, 0, 255), truncate."""
    return torch.clamp(color * 255.0, 0.0, 255.0).to(torch.uint8)


def chunked_rays(cam: CameraRays, height: int, width: int, chunk: int):
    """The frame's primary rays as (n_chunks, chunk, 3), the last chunk
    padded with the direction (0, 1, 0) (straight up: sky only), and the
    frame's pixel count."""
    flat = primary_rays(cam, height, width).reshape(-1, 3)
    n_px = height * width
    chunk = min(chunk, n_px)
    pad = -n_px % chunk
    if pad:
        up = torch.zeros((pad, 3), dtype=flat.dtype, device=flat.device)
        up[:, 1].fill_(1.0)
        flat = torch.cat([flat, up])
    return flat.reshape(-1, chunk, 3), n_px


def render_base_image(scene: Scene, lights: Lights, ambient, sky_lookup,
                      cam: CameraRays, height: int, width: int,
                      chunk: int = 32768):
    """Render the pre-FXAA framebuffer: (height, width, 3) uint8.

    scene, lights, ambient and cam lie on one device, sky_lookup reads
    there; pixels are traced in `chunk`-sized batches.
    """
    chunks, n_px = chunked_rays(cam, height, width, chunk)
    out = [quantize(trace_image(scene, lights, ambient, sky_lookup,
                                cam.pos.expand_as(d), d))
           for d in chunks]
    return torch.cat(out)[:n_px].reshape(height, width, 3)
