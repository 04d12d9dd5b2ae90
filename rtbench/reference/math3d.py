"""Rotations and small vector helpers (a frozen copy of
raytracing_cuda_tpu_torch/core/math3d.py).

The reference's transforms.h:7-40 and structs.h:54-101 float3 operators.
Functions dispatch on their input: numpy for host-side scene building
(double trig rounded to float32, like the C++ float3/double-libm mix), torch
for the float32 state machine. Vector products are written out op by op so
no library kernel contracts them into fused multiply-adds.
"""

from __future__ import annotations

import numpy as np
import torch

# The reference's PI macro (scene.h:5, kernel.cu:12) — deliberately truncated.
PI = np.float32(3.141592)
_DEG = float(PI / np.float32(180.0))     # f32-exact, so torch math stays f32


def _is_np(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, float, int))


def to_rad(angle):
    """Degrees → radians with the reference's truncated PI (scene.cpp:89-91)."""
    if _is_np(angle):
        return (PI / np.float32(180.0)) * angle
    return angle * _DEG


def _cos_sin(a):
    if _is_np(a):
        return np.cos(a), np.sin(a)
    return torch.cos(a), torch.sin(a)


def _stack(xs, v):
    return np.stack(xs, -1) if _is_np(v) else torch.stack(xs, -1)


def rot_y(v, a):
    """rotY(vec, a) (transforms.h:15-22), componentwise."""
    c, s = _cos_sin(a)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return _stack([c * x + s * z, y + 0 * c, -s * x + c * z], v)


def rot_z(v, a):
    """rotZ (transforms.h:33-40), componentwise."""
    c, s = _cos_sin(a)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return _stack([c * x - s * y, s * x + c * y, z + 0 * c], v)


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE divide on every device. PyTorch's CUDA division by
    a Python (or CPU 0-d) scalar multiplies by its rounded reciprocal,
    which is not the same float; a divisor filled on x's device (no host
    copy, so no stream sync) keeps the divide."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def dot3(a, b):
    """float3 dot (structs.h:60-62) along the last axis, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    """float3 cross (structs.h:64-66) along the last axis of torch tensors,
    broadcasting the leading axes; each product and difference rounded on
    its own."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def normalize(v):
    """float3 normalize (structs.h:82-84): v * (1/norm)."""
    if _is_np(v):
        return v * (1.0 / np.sqrt(dot3(v, v))[..., None])
    return v * (1.0 / torch.sqrt(dot3(v, v)))[..., None]
