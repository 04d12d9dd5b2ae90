"""The four procedural sky panoramas, evaluated where a lookup lands.

The panoramas are those of raytracing_cuda_tpu_torch/scene/textures.py
`procedural_skies` (a vertical sky→horizon gradient per time of day, a
sun/moon glow band, and stars at night from numpy's default_rng(1234)),
written here again from its formulas: each texel is a function of its row
and column, so the reference evaluates the texels its rays look up instead
of building four (H, W, 3) arrays. The lookup is the reference's per-ray
four-texture blend (kernel.cu:156-163): each panorama's texel scaled by its
weight and truncated to uchar (structs.h:86-88), then summed.

The arithmetic runs in `dtype` (float32 for the reference, bfloat16 for its
control).
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference.math3d import PI, true_div

_HALF_PI = float(PI / np.float32(2.0))
_PI = float(PI)
_TWO_PI = float(np.float32(2.0) * PI)
_INV_255 = float(np.float32(1.0 / 255.0))

# per time of day: zenith rgb, horizon rgb, glow rgb, glow x
PANORAMAS = (
    ((70, 110, 190), (255, 170, 110), (255, 210, 120), 0.25),   # morning
    ((90, 150, 235), (200, 225, 255), (255, 255, 230), 0.50),   # day
    ((60, 50, 120), (250, 120, 80), (255, 150, 90), 0.75),      # evening
    ((8, 10, 30), (25, 30, 60), (200, 200, 230), 0.50),         # night
)
NIGHT = 3


class ProceduralSky:
    """The panoramas of `height` x `width` texels on `device`: their row
    and column coordinates and the night panorama's star mask."""

    def __init__(self, height: int, width: int, device, dtype=torch.float32):
        self.h, self.w, self.dtype = height, width, dtype
        ys = np.linspace(0.0, 1.0, height, dtype=np.float32)
        xs = np.linspace(0.0, 1.0, width, endpoint=False, dtype=np.float32)
        self.ys = torch.from_numpy(ys).to(device).to(dtype)
        self.xs = torch.from_numpy(xs).to(device).to(dtype)
        stars = np.random.default_rng(1234).random((height, width, 1))
        self.stars = torch.from_numpy(stars[..., 0] > 0.9985).to(device)
        self.rgb = [tuple(torch.tensor(c, dtype=torch.float32).to(device)
                          .to(dtype) for c in p[:3]) for p in PANORAMAS]

    def texels(self, i: int, iy: torch.Tensor, ix: torch.Tensor):
        """Panorama i's texels at rows iy, columns ix → (..., 3), whole
        numbers 0..255 in self.dtype."""
        zen, hor, glow = self.rgb[i]
        gx = PANORAMAS[i][3]
        y, x = self.ys[iy][..., None], self.xs[ix][..., None]
        grad = zen + (hor - zen) * torch.clamp(y * 2.0, 0.0, 1.0)
        dx = torch.minimum(torch.abs(x - gx), 1.0 - torch.abs(x - gx)) * 2.0
        dy = torch.abs(y - 0.45) * 2.0
        halo = torch.exp(-(dx ** 2 + dy ** 2) * 14.0)
        img = grad + glow * halo * 0.8
        if i == NIGHT:
            star = self.stars[iy, ix][..., None].to(self.dtype)
            img = img + star * 200.0 * (y < 0.55).to(self.dtype)
        return torch.floor(torch.clamp(img, 0.0, 255.0))

    def indices(self, d: torch.Tensor, day_frac: torch.Tensor):
        """Direction (..., 3) → texel (iy, ix) (kernel.cu:156-163); day_frac
        the clock's day_time / 24 shifts the sky with the clock."""
        y = 1.0 - true_div(torch.asin(torch.clamp(d[..., 1], -1.0, 1.0))
                           + _HALF_PI, _PI)
        x = torch.remainder(true_div(torch.atan2(d[..., 0], d[..., 2]) + _PI,
                                     _TWO_PI) + day_frac.to(d.dtype), 1.0)
        ix = torch.clamp((x * self.w).to(torch.int64), 0, self.w - 1)
        iy = torch.clamp((y * self.h).to(torch.int64), 0, self.h - 1)
        return iy, ix

    def lookup(self, d: torch.Tensor, day_frac: torch.Tensor, weights):
        """The sky seen along directions d (..., 3) → (..., 3) in [0, 1]:
        the four panoramas blended by `weights` (the state's sky_vars) with
        the reference's truncation; a panorama of weight 0 adds nothing
        and is not evaluated."""
        iy, ix = self.indices(d, day_frac)
        acc = torch.zeros(d.shape, dtype=self.dtype, device=d.device)
        for i, w in enumerate(weights.to(self.dtype).tolist()):
            if w != 0:
                acc = acc + torch.floor(self.texels(i, iy, ix) * w)
        return acc * _INV_255
