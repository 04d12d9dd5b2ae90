"""Image helpers (port of raytracing_cuda_tpu/utils/images.py): frame RMSE,
the SSAA box resolve, and a PNG writer and reader that need no PIL.

`save_png` writes 8-bit RGB PNGs with zlib and numpy (filter 0 on every
row). `load_png` decodes 8-bit RGB (and RGBA, alpha dropped) non-interlaced
PNGs, handling the five scanline filters — the format of every golden
frame in tests/golden/ and of the native frame writer's output.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_host(image) -> np.ndarray:
    """Framebuffer (a tensor on any device, or an array) → host array."""
    if hasattr(image, "detach"):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def box_downsample(image, n: int) -> np.ndarray:
    """Average n×n pixel boxes — the SSAA resolve of `render/record --ssaa
    N` (images.py:30-44 of the JAX package, the same numpy arithmetic):
    (H·n, W·n, C) uint8 → (H, W, C) uint8, rounded half-up."""
    img = to_host(image)
    if n == 1:
        return img
    h, w = img.shape[0] // n, img.shape[1] // n
    acc = img.astype(np.float32).reshape(h, n, w, n, -1).mean(axis=(1, 3))
    return (acc + 0.5).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def save_png(image, path: str, level: int = 6) -> None:
    """(H, W, 3) uint8 → 8-bit RGB PNG at zlib `level` (0-9)."""
    img = np.ascontiguousarray(to_host(image))
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"save_png needs (H, W, 3) uint8, got {img.shape} "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),        # filter 0
                           img.reshape(h, w * 3)], axis=1)
    data = (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


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
    if not ftype.any():                    # no filter on any row
        return rows[:, 1:].reshape(h, w, bpp).copy()
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
