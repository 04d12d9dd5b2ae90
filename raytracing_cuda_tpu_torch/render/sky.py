"""The sky lookup and quantize: kernel A's seven planes of K frames → their
uint8 base frames, `quantize(rgb + mw · sky)` with the sky looked up in the
static (4, H*W) panorama stack (scene/textures.py).

On a card this is one launch of csrc/sky.cu, which reads the planes where
kernel A wrote them; on the CPU `sky_quantize_torch`, the torch composition
(`sample_sky_packed_pair_batch`, then `quantize`) that the kernel is held to
bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from raytracing_cuda_tpu_torch.core.math3d import true_div
from raytracing_cuda_tpu_torch.render.packs import _tensor
from raytracing_cuda_tpu_torch.render.reference import quantize
from raytracing_cuda_tpu_torch.scene.textures import (
    _HALF_PI, _INV_255, _PI, _TWO_PI, sample_sky_packed_pair_batch)

f32 = torch.float32


def sky_quantize_torch(planes, sky_pack: torch.Tensor, sky_h: int,
                       sky_w: int, day_time: torch.Tensor,
                       sky_vars: torch.Tensor) -> torch.Tensor:
    """sky_quantize in torch ops on any device: each frame's flat pair
    lookup (day_frac = day_time / 24 as a true division), then quantize."""
    r, g, b, mw, mdx, mdy, mdz = planes
    sky = sample_sky_packed_pair_batch(
        sky_pack, sky_h, sky_w, torch.stack([mdx, mdy, mdz], dim=-1),
        true_div(day_time, 24.0), sky_vars)
    return quantize(torch.stack([r, g, b], dim=-1) + mw[..., None] * sky)


@functools.cache
def _library():
    """csrc/sky.cu built and loaded, its kernel's module loaded (so no
    capture loads it)."""
    from raytracing_cuda_tpu_torch import _build

    lib = _build.load("sky")
    lib.rt_sky_load.argtypes = []
    lib.rt_sky_load.restype = ctypes.c_int
    _build.check(lib, lib.rt_sky_load(), "loading the sky kernel")
    lib.rt_sky_quantize.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 2)
    lib.rt_sky_quantize.restype = ctypes.c_int
    return lib


def sky_quantize(planes, sky_pack: torch.Tensor, sky_h: int, sky_w: int,
                 day_time: torch.Tensor,
                 sky_vars: torch.Tensor) -> torch.Tensor:
    """K frames' base frames → (K, H, W, 3) uint8 on the planes' device.

    planes: kernel A's (r, g, b, mw, mdx, mdy, mdz), each a contiguous (K,
    H, W) float32 tensor; sky_pack the (4, sky_h * sky_w) int32 stack
    (pack_sky_all); day_time (K,) and sky_vars (K, 4) float32, frame k's
    clock and sky weights; all on one device. Raises on any other input. A
    CUDA tensor launches csrc/sky.cu once on the current stream, counted on
    `launches` and `frames`; a CPU tensor runs sky_quantize_torch."""
    if len(planes) != 7:
        raise ValueError(f"sky_quantize takes kernel A's 7 planes, got "
                         f"{len(planes)}")
    dev = planes[0].device
    shape = tuple(planes[0].shape)
    if len(shape) != 3 or 0 in shape:
        raise ValueError(f"the planes must be (K, H, W) with no empty axis, "
                         f"got {shape}")
    K, H, W = shape
    for name, p in zip(("r", "g", "b", "mw", "mdx", "mdy", "mdz"), planes):
        _tensor(name, p, dev, f32, shape)
    _tensor("sky_pack", sky_pack, dev, torch.int32, (4, sky_h * sky_w))
    _tensor("day_time", day_time, dev, f32, (K,))
    _tensor("sky_vars", sky_vars, dev, f32, (K, 4))
    if dev.type != "cuda":
        return sky_quantize_torch(planes, sky_pack, sky_h, sky_w, day_time,
                                  sky_vars)
    from raytracing_cuda_tpu_torch import _build

    out = torch.empty((K, H, W, 3), dtype=torch.uint8, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rt_sky_quantize(
            *(p.data_ptr() for p in planes), sky_pack.data_ptr(), sky_h,
            sky_w, day_time.data_ptr(), sky_vars.data_ptr(), K, H, W,
            _HALF_PI, _PI, _TWO_PI, _INV_255, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sky kernel launch")
    sky_quantize.launches += 1
    sky_quantize.frames += K
    return out


sky_quantize.launches = 0
sky_quantize.frames = 0
