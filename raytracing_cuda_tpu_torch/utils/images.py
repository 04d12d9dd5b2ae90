"""Image helpers (port of raytracing_cuda_tpu/utils/images.py): frame RMSE and
a PNG reader that needs no PIL.

`load_png` decodes 8-bit RGB (and RGBA, alpha dropped) non-interlaced PNGs
with zlib and numpy, handling the five scanline filters — the format of
every golden frame in tests/golden/.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def rmse(a, b) -> float:
    """Per-pixel RMSE on the 0..1 scale (the golden parity metric)."""
    a = np.asarray(a, np.float64) / 255.0
    b = np.asarray(b, np.float64) / 255.0
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters → (h, w, bpp) uint8.

    Pixel (y, x) depends on its left, upper and upper-left neighbours only,
    so all pixels on one anti-diagonal x + y = t are independent: the decode
    walks h + w - 1 diagonals, each as a few numpy ops over its pixels.
    """
    rows = np.frombuffer(raw, np.uint8).reshape(h, w * bpp + 1)
    ftype = rows[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {ftype.max()}")
    line = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    # decoded pixels with a zero row on top and a zero column on the left
    dec = np.zeros((h + 1, w + 1, bpp), np.int32)
    for t in range(h + w - 1):
        y = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        x = t - y
        a = dec[y + 1, x]          # left
        b = dec[y, x + 1]          # up
        c = dec[y, x]              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select(
            [ftype[y, None] == k for k in (1, 2, 3, 4)],
            [a, b, (a + b) >> 1, paeth], 0)
        dec[y + 1, x + 1] = (line[y, x] + pred) & 0xFF
    return dec[1:, 1:].astype(np.uint8)


def load_png(path: str) -> np.ndarray:
    """8-bit RGB/RGBA non-interlaced PNG → (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    channels = {2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA non-interlaced PNGs are "
                         f"supported (depth {depth}, color type {ctype}, "
                         f"interlace {interlace})")
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w, channels)
    return np.ascontiguousarray(pix[..., :3])
