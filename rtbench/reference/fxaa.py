"""Plain FXAA (a frozen copy of the plain half of
raytracing_cuda_tpu_torch/render/fxaa.py), the reference's antialiasing
kernel (kernel.cu:262-403) on a quantized uint8 frame: Rec.709 luminance, a
contrast skip, a 12-tap blend factor through smoothstep, and a
horizontal/vertical pick of the ±1 neighbour; image-border pixels pass
through. The float arithmetic runs in `dtype` (float32 for the reference,
bfloat16 for its control).
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference.math3d import true_div

CONTRAST_THRESHOLD = 0.0312   # kernel.cu:289
RELATIVE_THRESHOLD = 0.063    # kernel.cu:290
LUMA_WEIGHTS = (0.2126729, 0.7151522, 0.0721750)  # Rec.709, kernel.cu:293


_C1, _C2, _C3 = (float(np.float32(c)) for c in LUMA_WEIGHTS)
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) in a's dtype: one rounding of a*b + c (computed in f64,
    where the product and, for 0..255 pixel values, the sum are exact)."""
    return (a.double() * b + c.double()).to(a.dtype)


def luminance(img: torch.Tensor) -> torch.Tensor:
    """min(255, r*c1 + g*c2 + b*c3) / 255 (kernel.cu:293-298), rounded as
    the golden frames were written: min(255, fma(b, c3, fma(r, c1, g*c2)))
    * f32(1/255)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    lum = _fma(b, _C3, _fma(r, _C1, g * _C2))
    return torch.clamp(lum, max=255.0) * _INV_255


def fxaa_torch(image: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Plain FXAA on a (H, W, 3) uint8 frame → (H, W, 3) uint8: the frame
    edge-padded by one row and one column (only border pixels, which pass
    through, ever read the padding)."""
    h, w, dev = image.shape[0], image.shape[1], image.device
    ys = torch.clamp(torch.arange(-1, h + 1, device=dev), 0, h - 1)
    xs = torch.clamp(torch.arange(-1, w + 1, device=dev), 0, w - 1)
    ip = image[ys][:, xs].to(dtype)                    # (h+2, w+2, 3)
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

    r = torch.arange(h, device=dev)[:, None]
    c = torch.arange(w, device=dev)[None, :]
    interior = (r > 0) & (r < h - 1) & (c > 0) & (c < w - 1)
    return torch.where((interior & ~skip)[..., None], out, image)
