"""FXAA anti-aliasing post-pass (port of raytracing_cuda_tpu/render/fxaa.py).

The reference's antialiasing kernel (kernel.cu:262-403) on the quantized
uint8 frame: Rec.709 luminance, a contrast skip, a 12-tap blend factor
through smoothstep, and a horizontal/vertical pick of the ±1 neighbour;
image-border pixels pass through.

`fxaa` (one frame), `fxaa_batch` (K frames in one launch) and `fxaa_ext` (a
row band with one halo row above and below, as row-sharded frames run it)
dispatch on the device of their input: a CPU tensor runs the plain PyTorch
version (`fxaa_ext_torch`, the JAX package's XLA stencil `fxaa_ext`, and
`fxaa_torch`, the same on the edge-padded frame), a CUDA tensor launches
csrc/fxaa.cu (replaces the Pallas kernel launched at fxaa.py:265) or
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raytracing_cuda_tpu_torch.core.math3d import true_div

f32 = torch.float32

CONTRAST_THRESHOLD = 0.0312   # kernel.cu:289
RELATIVE_THRESHOLD = 0.063    # kernel.cu:290
LUMA_WEIGHTS = (0.2126729, 0.7151522, 0.0721750)  # Rec.709, kernel.cu:293


_C1, _C2, _C3 = (float(np.float32(c)) for c in LUMA_WEIGHTS)
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) in float32: one rounding of a*b + c (computed in f64,
    where the product and, for 0..255 pixel values, the sum are exact)."""
    return (a.double() * b + c.double()).float()


def luminance(img_f32: torch.Tensor) -> torch.Tensor:
    """min(255, r*c1 + g*c2 + b*c3) / 255 (kernel.cu:293-298), rounded as
    XLA compiles the JAX package's stencil — the arithmetic that wrote the
    golden frames: min(255, fma(b, c3, fma(r, c1, g*c2))) * f32(1/255).

    The Pallas source spells a separately rounded sum and a true divide
    (fxaa.py:173); that form resolves a few luminance-comparison ties the
    other way and misses the 96x160 classic golden (RMSE 0.0029 > 2e-3,
    as JAX's own stencil does when run eagerly), while the compiled form
    reproduces it.
    """
    r, g, b = img_f32[..., 0], img_f32[..., 1], img_f32[..., 2]
    lum = _fma(b, _C3, _fma(r, _C1, g * _C2))
    return torch.clamp(lum, max=255.0) * _INV_255


def fxaa_ext_torch(image_ext: torch.Tensor, row0: int,
                   total_height: int) -> torch.Tensor:
    """Plain FXAA over a vertically extended band (the JAX package's
    fxaa_ext, fxaa.py:45-111): (h + 2, W, 3) uint8, the band with one halo
    row above and one below → the filtered band, (h, W, 3) uint8. A
    (K, h + 2, W, 3) stack filters each frame's band. row0 and total_height
    place the band in its frame: a pixel is interior by its global row
    row0 + y, so the halo rows at the frame's top and bottom are never
    read."""
    if image_ext.ndim == 4:
        return torch.stack([fxaa_ext_torch(e, row0, total_height)
                            for e in image_ext])
    h, w = image_ext.shape[0] - 2, image_ext.shape[1]
    dev = image_ext.device
    # edge-pad by one column on each side (only border pixels, which pass
    # through, ever read the padding)
    xs = torch.clamp(torch.arange(-1, w + 1, device=dev), 0, w - 1)
    ip = image_ext.to(f32)[:, xs]                    # (h+2, w+2, 3)
    lp = luminance(ip)

    def tap(a, dy, dx):
        return a[dy:dy + h, dx:dx + w]

    lm, ln, ls = tap(lp, 1, 1), tap(lp, 0, 1), tap(lp, 2, 1)
    le, lw = tap(lp, 1, 2), tap(lp, 1, 0)
    lne, lnw, lse, lsw = tap(lp, 0, 2), tap(lp, 0, 0), tap(lp, 2, 2), tap(lp, 2, 0)
    mx, mn = torch.maximum, torch.minimum

    # contrast + skip threshold (kernel.cu:337-354)
    high = mx(mx(mx(mx(le, lw), ln), ls), lm)
    low = mn(mn(mn(mn(le, lw), ln), ls), lm)
    contrast = high - low
    skip = contrast < torch.clamp(RELATIVE_THRESHOLD * high,
                                  min=CONTRAST_THRESHOLD)

    # blend factor: 12-tap neighbourhood filter + smoothstep (kernel.cu:364-375)
    filt = true_div(2.0 * (le + lw + ls + ln) + lne + lnw + lse + lsw, 12.0)
    filt = torch.clamp(torch.abs(filt - lm) / contrast, max=1.0)
    blend = filt * filt * (3.0 - 2.0 * filt)

    # edge direction from second-derivative taps (kernel.cu:377-392)
    hor = (torch.abs(ln + ls - 2.0 * lm) * 2.0
           + torch.abs(lne + lse - 2.0 * le) + torch.abs(lnw + lsw - 2.0 * lw))
    ver = (torch.abs(le + lw - 2.0 * lm) * 2.0
           + torch.abs(lne + lnw - 2.0 * ln) + torch.abs(lse + lsw - 2.0 * ls))
    is_hor = (hor >= ver)[..., None]
    pick_n = (torch.abs(ln - lm) >= torch.abs(ls - lm))[..., None]
    pick_e = (torch.abs(le - lm) >= torch.abs(lw - lm))[..., None]
    neighbor = torch.where(
        is_hor, torch.where(pick_n, tap(ip, 0, 1), tap(ip, 2, 1)),
        torch.where(pick_e, tap(ip, 1, 2), tap(ip, 1, 0)))

    b = blend[..., None]
    out = torch.clamp(neighbor * b + tap(ip, 1, 1) * (1.0 - b), 0.0,
                      255.0).to(torch.uint8)

    r = row0 + torch.arange(h, device=dev)[:, None]
    c = torch.arange(w, device=dev)[None, :]
    interior = (r > 0) & (r < total_height - 1) & (c > 0) & (c < w - 1)
    return torch.where((interior & ~skip)[..., None], out, image_ext[1:-1])


def fxaa_torch(image: torch.Tensor) -> torch.Tensor:
    """Plain FXAA on a (H, W, 3) uint8 frame → (H, W, 3) uint8: the band
    form on the frame edge-padded by one row (fxaa.py:114-117)."""
    h = image.shape[0]
    ys = torch.clamp(torch.arange(-1, h + 1, device=image.device), 0, h - 1)
    return fxaa_ext_torch(image[ys], 0, h)


def fxaa_batch_torch(images: torch.Tensor) -> torch.Tensor:
    """Plain FXAA on a (K, H, W, 3) uint8 batch, one fxaa_torch per frame."""
    return torch.stack([fxaa_torch(img) for img in images])


def _launch(images: torch.Tensor, halo: bool = False, row0: int = 0,
            total_height: int | None = None) -> torch.Tensor:
    """One launch of csrc/fxaa.cu over a (K, rows, W, 3) uint8 stack: K
    whole frames (rows = H) or, with halo, K bands of rows - 2 rows with
    their halo rows, placed at row0 in frames of total_height rows."""
    from raytracing_cuda_tpu_torch import _build

    if (images.dtype != torch.uint8 or images.ndim != 4
            or images.shape[3] != 3 or not images.is_contiguous()):
        raise ValueError(f"fxaa takes contiguous (H, W, 3) uint8 frames, "
                         f"got {images.dtype} {tuple(images.shape)}")
    K, rows, W = images.shape[:3]
    h = rows - 2 if halo else rows
    if not 1 <= K <= 65535:
        raise ValueError(f"K = {K} frames; the kernel takes 1 to 65535")
    if h < 1 or W < 1:
        raise ValueError(f"empty band: {h} rows of {W} pixels")
    total_height = h if total_height is None else total_height
    lib = _build.load("fxaa")
    fn = lib.rt_fxaa
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((K, h, W, 3), dtype=torch.uint8, device=images.device)
    # the kernel reads band row 0 (below the halo row) and the rows around
    # it; a full frame's border rows pass through and read nothing outside
    band0 = images.data_ptr() + (W * 3 if halo else 0)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = fn(band0, rows * W * 3, out.data_ptr(), K, h, W, int(row0),
                 int(total_height), stream)
    _build.check(lib, err, "fxaa kernel launch")
    return out


def _on_cuda(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"no fxaa kernel for device {t.device}")


def fxaa(image: torch.Tensor) -> torch.Tensor:
    """FXAA on a full (H, W, 3) uint8 frame → (H, W, 3) uint8."""
    if image.device.type == "cpu":
        return fxaa_torch(image)
    _on_cuda(image)
    out = _launch(image[None])[0]
    fxaa.launches += 1
    return out


fxaa.launches = 0


def fxaa_batch(images: torch.Tensor) -> torch.Tensor:
    """FXAA on each frame of a (K, H, W, 3) uint8 batch in one launch
    (gridDim.z = K; the counterpart of lax.map(fxaa_pallas, base) at
    pipeline.py:273-275). Counts one launch and K frames."""
    if images.device.type == "cpu":
        return fxaa_batch_torch(images)
    _on_cuda(images)
    out = _launch(images)
    fxaa_batch.launches += 1
    fxaa_batch.frames += images.shape[0]
    return out


fxaa_batch.launches = 0
fxaa_batch.frames = 0


def fxaa_ext(image_ext: torch.Tensor, row0: int,
             total_height: int) -> torch.Tensor:
    """FXAA on a halo'd row band, (h + 2, W, 3) uint8 → (h, W, 3) uint8,
    or on K frames' bands at once, (K, h + 2, W, 3) → (K, h, W, 3) in one
    launch (gridDim.z = K). The band form of fxaa_ext_pallas
    (fxaa.py:232-283) that row-sharded frames run. CPU tensors run
    fxaa_ext_torch; CUDA tensors launch csrc/fxaa.cu, counting one launch
    and K frames."""
    if image_ext.device.type == "cpu":
        return fxaa_ext_torch(image_ext, row0, total_height)
    _on_cuda(image_ext)
    single = image_ext.ndim == 3
    out = _launch(image_ext[None] if single else image_ext, halo=True,
                  row0=row0, total_height=total_height)
    fxaa_ext.launches += 1
    fxaa_ext.frames += out.shape[0]
    return out[0] if single else out


fxaa_ext.launches = 0
fxaa_ext.frames = 0


def apply_fxaa(image: torch.Tensor, enabled) -> torch.Tensor:
    """FXAA with the on/off toggle (kernel.cu:275-278 passthrough) of one
    frame, (H, W, 3), or of K frames, (K, H, W, 3), one toggle each.

    enabled is the state's `aa` flag as a bool tensor (0-d, or (K,) for K
    frames), or a host bool. A tensor selects on the device: the filter
    always runs (kernel B on a card, one launch) and torch.where keeps the
    base frame where the flag is off, so the toggle is never read back to
    the host and a CUDA graph replays the same work whatever it holds. A
    host bool skips the filter where it is off."""
    if not isinstance(enabled, torch.Tensor):
        return (fxaa if image.ndim == 3 else fxaa_batch)(image) \
            if enabled else image
    out = fxaa(image) if image.ndim == 3 else fxaa_batch(image)
    on = enabled.to(image.device).reshape(
        enabled.shape + (1,) * (image.ndim - enabled.ndim))
    return torch.where(on, out, image)
