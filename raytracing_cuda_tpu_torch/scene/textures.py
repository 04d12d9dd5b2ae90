"""Sky panoramas: the reference panoramas and procedural ones, the
per-frame blend, packing and the flat lookups (port of the flat part of
raytracing_cuda_tpu/scene/textures.py).

The reference binds four equirectangular panoramas (morning/day/evening/
night, scene.cpp:626-632) as point-sampled CUDA textures and blends all four
per sky ray with truncating uchar4 arithmetic (kernel.cu:156-163,
structs.h:86-91). The weights are uniform per frame and at most two are
nonzero, so the four panoramas are packed once into a static (4, H*W) int32
stack and each miss ray fetches at most two texels and blends them with the
same truncation. On a GPU the per-pixel gather is exact and cheap, so the
JAX package's grouped resolve (one gather per pixel group, a TPU gather
workaround) has no counterpart here.

The `fast` and `oracle` render paths, and the kernel path without the
static stack, blend the four panoramas once per frame into one uint8
texture instead (`blend_sky`, bit-identical to blending per ray because the
weights are uniform across the frame) and pay one gather per sky ray
(`sample_sky`, `sample_sky_packed`).
"""

from __future__ import annotations

import hashlib
import os
from typing import Tuple

import numpy as np
import torch

from raytracing_cuda_tpu_torch.core.math3d import PI, true_div
from raytracing_cuda_tpu_torch.core.types import SkyTextures
from raytracing_cuda_tpu_torch.utils.images import load_png

SKY_NAMES = ("morning", "day", "evening", "night")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# where the reference's backgrounds/{morning,day,evening,night}.png go (they
# are not shipped with the repository), and the cache of decoded arrays
REFERENCE_BACKGROUNDS = os.path.join(_REPO_ROOT, "assets", "backgrounds")
CACHE_DIR = os.path.join(_REPO_ROOT, "assets", "cache")

_HALF_PI = float(PI / np.float32(2.0))
_PI = float(PI)
_TWO_PI = float(np.float32(2.0) * PI)
_INV_255 = float(np.float32(1.0 / 255.0))


def procedural_skies(height: int = 256, width: int = 512) -> np.ndarray:
    """Deterministic synthetic panoramas, (4, H, W, 3) uint8 (numpy).

    A vertical sky→horizon gradient per time of day, a sun/moon glow band,
    and hash-noise stars at night (numpy default_rng(1234), so the star
    field matches the JAX package bit for bit).
    """
    ys = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    xs = np.linspace(0.0, 1.0, width, endpoint=False,
                     dtype=np.float32)[None, :, None]
    # per-time (zenith_rgb, horizon_rgb, glow_rgb, glow_x)
    params = [
        ((70, 110, 190), (255, 170, 110), (255, 210, 120), 0.25),   # morning
        ((90, 150, 235), (200, 225, 255), (255, 255, 230), 0.50),   # day
        ((60, 50, 120), (250, 120, 80), (255, 150, 90), 0.75),      # evening
        ((8, 10, 30), (25, 30, 60), (200, 200, 230), 0.50),         # night
    ]
    out = np.zeros((4, height, width, 3), np.float32)
    for i, (zen, hor, glow, gx) in enumerate(params):
        zen = np.array(zen, np.float32)
        hor = np.array(hor, np.float32)
        glow = np.array(glow, np.float32)
        grad = zen + (hor - zen) * np.clip(ys * 2.0, 0.0, 1.0)
        dx = np.minimum(np.abs(xs - gx), 1.0 - np.abs(xs - gx)) * 2.0
        dy = np.abs(ys - 0.45) * 2.0
        halo = np.exp(-(dx**2 + dy**2) * 14.0)
        img = grad + glow * halo * 0.8
        if i == 3:  # stars
            rng = np.random.default_rng(1234)
            stars = (rng.random((height, width, 1)) > 0.9985).astype(np.float32)
            img = img + stars * 200.0 * (ys < 0.55)
        out[i] = img
    return np.clip(out, 0, 255).astype(np.uint8)


def load_reference_skies(path: str = REFERENCE_BACKGROUNDS,
                         downsample: int = 1, cache: bool = True) -> np.ndarray:
    """The four reference panoramas {morning,day,evening,night}.png under
    `path`, (4, H, W, 3) uint8 (textures.py:71-95 of the JAX package).

    RGB or RGBA PNGs (alpha dropped), decoded by utils.images.load_png;
    downsample=k point-samples every k-th texel of each axis. The decoded
    array is cached as .npz under assets/cache/, keyed by the directory's
    absolute path and k. Raises FileNotFoundError naming the first missing
    file.
    """
    tag = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:8]
    cache_file = os.path.join(CACHE_DIR, f"skies_{tag}_ds{downsample}.npz")
    if cache and os.path.exists(cache_file):
        return np.load(cache_file)["texels"]
    files = [os.path.join(path, f"{name}.png") for name in SKY_NAMES]
    for f in files:
        if not os.path.exists(f):
            raise FileNotFoundError(
                f"reference sky panorama {f} is missing: copy the reference's "
                f"backgrounds/{{{','.join(SKY_NAMES)}}}.png there")
    texels = np.stack([load_png(f)[::downsample, ::downsample]
                       for f in files])
    if cache:
        os.makedirs(CACHE_DIR, exist_ok=True)
        np.savez_compressed(cache_file, texels=texels)
    return texels


def load_skies(source: str = "auto", downsample: int = 1,
               procedural_shape: Tuple[int, int] = (2048, 4096),
               path: str = REFERENCE_BACKGROUNDS) -> SkyTextures:
    """Sky textures by source (textures.py:98-110 of the JAX package):
    'reference' (the panoramas under `path`, point-sampled by downsample),
    'procedural', or 'auto': reference where `path` exists, else
    procedural."""
    if source == "auto":
        source = "reference" if os.path.exists(path) else "procedural"
    if source == "reference":
        texels = load_reference_skies(path, downsample)
    elif source == "procedural":
        texels = procedural_skies(*procedural_shape)
    else:
        raise ValueError(f"unknown sky source {source!r}")
    return SkyTextures(texels=texels)


def blend_sky(texels: torch.Tensor, sky_vars: torch.Tensor) -> torch.Tensor:
    """Pre-blend the four panoramas (4, H, W, 3) uint8 with the frame's
    skyVars (4,) float32 → (H, W, 3) uint8 on the device of `texels`.

    The reference's per-ray blend (kernel.cu:158-162): each texel scaled in
    float32 and truncated to uchar (structs.h:86-88), then summed (the
    weights sum to 1, so no uchar overflow).
    """
    sv = torch.as_tensor(sky_vars, dtype=torch.float32).to(texels.device)
    acc = torch.zeros(texels.shape[1:], dtype=torch.uint8,
                      device=texels.device)
    for i in range(4):
        acc = acc + (texels[i].to(torch.float32) * sv[i]).to(torch.uint8)
    return acc


def pack_sky(blended: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 → flat (H*W,) int32 of r | g << 8 | b << 16."""
    b32 = blended.to(torch.int32)
    return (b32[..., 0] | (b32[..., 1] << 8) | (b32[..., 2] << 16)).reshape(-1)


def pack_sky_all(texels: torch.Tensor) -> torch.Tensor:
    """All four panoramas (4, H, W, 3) uint8 → static (4, H*W) int32 stack."""
    return torch.stack([pack_sky(texels[i]) for i in range(4)])


def sky_blend_bands(sky_vars: torch.Tensor):
    """→ (ia, ib, wa, wb): the ≤2 active panoramas and their weights, 0-d
    tensors on the device of sky_vars (int64 indices, float32 weights).

    calc_sky_vars (scene.cpp:778-804) yields at most two nonzero adjacent
    weights summing to 1, so the 4-way truncated blend collapses to two
    terms: trunc(tex_a·wa) + trunc(tex_b·wb) equals Σ trunc(tex_i·w_i).
    Where one panorama is pure, wb = 0 and wa = 1.
    """
    sv = torch.as_tensor(sky_vars, dtype=torch.float32)
    ia = torch.argmax(sv)
    masked = torch.where(torch.arange(4, device=sv.device) == ia,
                         torch.full_like(sv, -1.0), sv)
    ib = torch.argmax(masked)
    return (ia, ib, sv.gather(0, ia.reshape(1)).reshape(()),
            torch.clamp(masked.gather(0, ib.reshape(1)), min=0.0).reshape(()))


def _day_frac(day_frac, device):
    """The day fraction as a float32 0-d tensor on `device`: a tensor as it
    is, a host number rounded to float32 first."""
    if not isinstance(day_frac, torch.Tensor):
        day_frac = torch.tensor(np.float32(day_frac))
    return day_frac.to(device=device, dtype=torch.float32)


def _equirect_indices(h: int, w: int, d: torch.Tensor, day_frac):
    """Direction (..., 3) → texel (iy, ix) (kernel.cu:156-163). day_frac:
    float32 day_time / 24, a tensor that broadcasts against d's leading
    axes (or a host number)."""
    y = 1.0 - true_div(torch.asin(torch.clamp(d[..., 1], -1.0, 1.0))
                       + _HALF_PI, _PI)
    x = torch.remainder(true_div(torch.atan2(d[..., 0], d[..., 2]) + _PI,
                                 _TWO_PI) + _day_frac(day_frac, d.device),
                        1.0)
    ix = torch.clamp((x * w).to(torch.int32), 0, w - 1)
    iy = torch.clamp((y * h).to(torch.int32), 0, h - 1)
    return iy, ix


def sample_sky(blended: torch.Tensor, d: torch.Tensor, day_frac):
    """Equirectangular sky lookup (kernel.cu:156-163) on a blend_sky
    texture → (..., 3) f32 in [0,1].

    y from asin(dir.y); x from atan2(dir.x, dir.z) shifted by the day
    fraction so the sky rotates with the clock; point sampling with clamp
    addressing like the reference's CUDA texture setup (kernel.cu:429-436).
    day_frac is the float32 day_time / 24.
    """
    h, w = blended.shape[0], blended.shape[1]
    iy, ix = _equirect_indices(h, w, d, day_frac)
    texel = blended.reshape(-1, 3)[(iy * w + ix).to(torch.int64)]
    return texel.to(torch.float32) * _INV_255


def _unpack_rgb(texel: torch.Tensor) -> torch.Tensor:
    return torch.stack([texel & 0xFF, (texel >> 8) & 0xFF,
                        (texel >> 16) & 0xFF], dim=-1).to(torch.float32)


def sample_sky_packed(packed: torch.Tensor, h: int, w: int, d: torch.Tensor,
                      day_frac):
    """Equirect lookup (kernel.cu:156-163) on a pack_sky plane → (..., 3)
    f32 in [0,1]; day_frac as in sample_sky."""
    iy, ix = _equirect_indices(h, w, d, day_frac)
    return _unpack_rgb(packed[(iy * w + ix).to(torch.int64)]) * _INV_255


def sample_sky_packed_pair(packed_all: torch.Tensor, h: int, w: int,
                           d: torch.Tensor, day_frac, sky_vars):
    """Flat equirect lookup on a pack_sky_all stack → (..., 3) f32 in [0,1].

    day_frac is the float32 day_time / 24 and sky_vars the (4,) weights,
    tensors on the device of `packed_all`: the two active panoramas come
    from sky_blend_bands on the device, and both are always fetched, so no
    value is read back to the host. Where one panorama is pure (wb = 0,
    wa = 1) the second term is floor(t·0) = 0 and the first is t itself.
    """
    iy, ix = _equirect_indices(h, w, d, day_frac)
    idx = (iy * w + ix).to(torch.int64)
    ia, ib, wa, wb = sky_blend_bands(torch.as_tensor(
        sky_vars, dtype=torch.float32, device=packed_all.device))
    flat, n = packed_all.reshape(-1), packed_all.shape[1]
    ta, tb = flat[idx + ia * n], flat[idx + ib * n]
    rgb = torch.stack(
        [torch.floor(((ta >> s) & 0xFF).to(torch.float32) * wa)
         + torch.floor(((tb >> s) & 0xFF).to(torch.float32) * wb)
         for s in (0, 8, 16)], dim=-1)
    return rgb * _INV_255


def sample_sky_packed_pair_batch(packed_all: torch.Tensor, h: int, w: int,
                                 d: torch.Tensor, day_fracs, sky_vars):
    """K-frame flat lookup, the vmapped resolve of pipeline.py:257-261:
    d (K, ..., 3) with day_fracs (K,) and sky_vars (K, 4), one per frame
    → (K, ..., 3) f32, frame k equal to sample_sky_packed_pair on it."""
    return torch.stack([sample_sky_packed_pair(packed_all, h, w, dk, df, sv)
                        for dk, df, sv in zip(d, day_fracs, sky_vars)])
