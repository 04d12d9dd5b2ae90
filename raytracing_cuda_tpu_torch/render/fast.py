"""Restructured raytracer, the `fast` render path (port of
raytracing_cuda_tpu/render/fast.py): same semantics as render.reference.

Three structural differences from the parity oracle (render/reference.py),
none observable in the output:

1. **Linear-form intersections** (ops.linear_forms): the per-(ray, object)
   3-vector math of checkHit (kernel.cu:41-129) is hoisted into per-object
   constants × a per-ray feature vector, so one pass over all objects is an
   elementwise sweep over (chunk, n_objects) planes with no
   (chunk, n_objects, 3) intermediates.

2. **Deferred sky gather**: a ray misses at most once (a miss kills it), so
   instead of an equirect texture gather per bounce (kernel.cu:156-163 runs
   inside the recursion) the loop records (miss_throughput, miss_direction)
   and a single gather per pixel resolves the sky after the loop.

3. **Per-chunk early exit** (`early_exit=True`): inside each chunk the
   bounce iterations and the per-light occlusion sweeps run only while any
   lane still needs them, recovering the sequential reference's early-outs
   (kernel.cu:192, 222) at chunk granularity. Sky-only chunks pay one
   bounce; most chunks skip the deep reflection levels. Each test reads one
   flag back to the host (on a card: a stream synchronisation, up to 15 per
   chunk), which a CUDA graph capture forbids. With `early_exit=False`
   every level and both sweeps of each level run, masked, and nothing is
   read back: the form the Engine's CUDA graphs capture (app/loop.py),
   where the JAX package decides each exit on the device (`lax.cond`).
   Both forms give the same pixels: a bounce with no live lane changes no
   lane, and a skipped sweep leaves every lane as the sweep would. A lane
   that needs no sweep has a light angle of ±0, which adds nothing to its
   colour whether the sweep zeroes it or not, or NaN from a zero light
   distance, whose NaN ray no sweep finds occluded. For the same reason
   the chunk size never changes a pixel.
"""

from __future__ import annotations

import torch

from raytracing_cuda_tpu_torch.core.types import CameraRays, Lights, Scene
from raytracing_cuda_tpu_torch.ops import linear_forms as lf
from raytracing_cuda_tpu_torch.render.reference import (MAX_DEPTH,
                                                        chunked_rays,
                                                        quantize, shade)
from raytracing_cuda_tpu_torch.scene.textures import sample_sky

f32 = torch.float32


def trace_chunk(scene: Scene, tp: lf.TriPack, sp: lf.SpherePack, sph_blocks,
                lights: Lights, ambient, o, d, early_exit: bool = True):
    """Trace one chunk of rays through the full bounce loop.

    Returns (color_acc, miss_w, miss_dir): linear hit-path color plus the
    deferred sky term — final color = color_acc + miss_w * sky(miss_dir).
    early_exit: skip a bounce or a shadow sweep that no lane needs, decided
    on the host; False runs them all, masked (module docstring, 3).
    """
    shape = d.shape[:-1]
    throughput = torch.ones(shape, dtype=f32, device=d.device)
    color_acc = torch.zeros(shape + (3,), dtype=f32, device=d.device)
    live = torch.ones(shape, dtype=torch.bool, device=d.device)
    miss_w = torch.zeros(shape, dtype=f32, device=d.device)
    miss_dir = d                        # weight 0 ⇒ value unused

    for _ in range(MAX_DEPTH + 1):
        if early_exit and not bool(live.any()):
            break
        F = lf.ray_features(o, d)
        hit_any, t, gidx = lf.nearest_hit_fast(scene, tp, sp, F)

        # --- miss → record deferred sky term (kernel.cu:154-163) ---
        miss = live & ~hit_any
        miss_w = torch.where(miss, throughput, miss_w)
        miss_dir = torch.where(miss[..., None], d, miss_dir)

        def shadow(hit_pos, sdir, sdist, need, live=live):
            if early_exit and not bool((live & need).any()):
                return torch.zeros_like(need)
            Fs = lf.ray_features(hit_pos + sdir * 0.001, sdir)
            return lf.occluded_fast(scene, tp, sp, sph_blocks, Fs, sdist)

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

        live = shaded & (kr > 0)
        o = torch.where(live[..., None], new_o, o)
        d = torch.where(live[..., None], refl, d)
        throughput = torch.where(live, throughput * kr, throughput)
    return color_acc, miss_w, miss_dir


def render_base_image_fast(scene: Scene, lights: Lights, ambient, sky_blended,
                           day_frac, cam: CameraRays, height: int, width: int,
                           row0: int = 0, total_height: int | None = None,
                           chunk: int = 65536, early_exit: bool = True):
    """Render the pre-FXAA framebuffer: (height, width, 3) uint8.

    Drop-in replacement for render.reference.render_base_image with the same
    semantics; frames agree but for borderline pixels at geometric edges.
    early_exit=False runs every bounce and sweep, masked, with no value
    read back to the host (a CUDA graph can capture it); the pixels are
    the same bit for bit.
    """
    chunks, n_px = chunked_rays(cam, height, width, row0, total_height,
                                chunk)
    tp = lf.tri_pack(scene)
    sp = lf.sphere_pack(scene)
    sph_blocks = ~scene.is_light[scene.sph_gidx.long()]

    out = []
    for d in chunks:
        color, miss_w, miss_dir = trace_chunk(
            scene, tp, sp, sph_blocks, lights, ambient,
            cam.pos.expand_as(d), d, early_exit)
        sky = sample_sky(sky_blended, miss_dir, day_frac)
        out.append(quantize(color + miss_w[..., None] * sky))
    return torch.cat(out)[:n_px].reshape(height, width, 3)
