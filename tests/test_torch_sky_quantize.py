"""The sky lookup and quantize wrapper (render/sky.py) on the CPU.

On a card `sky_quantize` is one launch of csrc/sky.cu, held bit for bit to
`sky_quantize_torch` there (tests/test_torch_cuda.py, `-k sky`). Here: a
CPU tensor runs that torch composition, which equals the one the pipeline
ran before the kernel (the single frame's `sample_sky_packed_pair` and the
K-frame `sample_sky_packed_pair_batch`, then `quantize`), and the wrapper
refuses what the kernel would not take on every device.
"""

import numpy as np
import pytest
import torch

from raytracing_cuda_tpu_torch import _build
from raytracing_cuda_tpu_torch.app import loop
from raytracing_cuda_tpu_torch.core.math3d import true_div
from raytracing_cuda_tpu_torch.render.cuda_rt import (raytrace_planes,
                                                      raytrace_planes_batch)
from raytracing_cuda_tpu_torch.render.fxaa import fxaa, fxaa_batch, fxaa_ext
from raytracing_cuda_tpu_torch.render.packs import pack_frame
from raytracing_cuda_tpu_torch.render.reference import quantize
from raytracing_cuda_tpu_torch.render.sky import (sky_quantize,
                                                  sky_quantize_torch)
from raytracing_cuda_tpu_torch.scene.textures import (
    pack_sky_all, procedural_skies, sample_sky_packed_pair,
    sample_sky_packed_pair_batch)
from raytracing_cuda_tpu_torch.sim.state import calc_sky_vars

torch.set_num_threads(2)

SKY_H, SKY_W = 64, 128
H, W = 24, 40


@pytest.fixture(scope="module")
def sky_pack():
    return pack_sky_all(torch.from_numpy(procedural_skies(SKY_H, SKY_W)))


def sky_planes(K: int, seed: int, h: int = H, w: int = W,
               sky: bool = False):
    """Seven (K, h, w) float32 planes: colours in and beyond [0, 1], a miss
    weight of 0 on about a third of the pixels (none where `sky`), unit
    directions with the atan2 seam (x = ±0, z < 0) and asin's ends (y = ±1
    and just past) in the first row (as far as it reaches)."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(-0.2, 1.2, (3, K, h, w)).astype(np.float32)
    mw = rng.uniform(1e-3, 1.0, (K, h, w)).astype(np.float32)
    if not sky:
        mw[rng.random((K, h, w)) < 0.33] = 0.0
    d = rng.standard_normal((3, K, h, w)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    edge = np.array([[0.0, 0.0, -1.0], [-0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                     [0.0, -1.0, 0.0], [0.0, 1.0000001, 0.0],
                     [0.0, -1.0000001, 0.0], [-1e-30, 0.3, -0.9],
                     [1e-30, -0.3, -0.9]], np.float32)
    n = min(w, len(edge))
    d[:, :, 0, :n] = edge[:n].T[:, None, :]
    return tuple(torch.from_numpy(np.ascontiguousarray(p))
                 for p in (*rgb, mw, *d))


def sky_clocks(hours):
    day_time = torch.tensor(np.float32(hours))
    return day_time, torch.stack([calc_sky_vars(t) for t in day_time])


@pytest.mark.parametrize("hour", [0.0, 5.0, 9.0, 14.0, 17.25, 23.999998])
def test_one_frame_equals_the_single_lookup_and_quantize(sky_pack, hour):
    """K = 1: the composition _base ran before the kernel, bit for bit."""
    planes = sky_planes(1, seed=int(hour * 7))
    day_time, sky_vars = sky_clocks([hour])
    r, g, b, mw, mdx, mdy, mdz = (p[0] for p in planes)
    sky = sample_sky_packed_pair(sky_pack, SKY_H, SKY_W,
                                 torch.stack([mdx, mdy, mdz], dim=-1),
                                 true_div(day_time[0], 24.0), sky_vars[0])
    want = quantize(torch.stack([r, g, b], dim=-1) + mw[..., None] * sky)
    got = sky_quantize(planes, sky_pack, SKY_H, SKY_W, day_time, sky_vars)
    assert got.shape == (1, H, W, 3) and got.dtype == torch.uint8
    assert torch.equal(got[0], want)


def test_three_frames_equal_the_batch_lookup_and_quantize(sky_pack):
    """K = 3, a clock and weights a frame: the composition
    bases_from_packs ran before the kernel, bit for bit, and each frame
    equals the K = 1 call on it."""
    planes = sky_planes(3, seed=3)
    day_time, sky_vars = sky_clocks([4.0, 9.0, 21.5])
    r, g, b, mw, mdx, mdy, mdz = planes
    sky = sample_sky_packed_pair_batch(
        sky_pack, SKY_H, SKY_W, torch.stack([mdx, mdy, mdz], dim=-1),
        [true_div(t, 24.0) for t in day_time], list(sky_vars))
    want = quantize(torch.stack([r, g, b], dim=-1) + mw[..., None] * sky)
    got = sky_quantize(planes, sky_pack, SKY_H, SKY_W, day_time, sky_vars)
    assert torch.equal(got, want)
    for k in range(3):
        one = sky_quantize(tuple(p[k:k + 1] for p in planes), sky_pack,
                           SKY_H, SKY_W, day_time[k:k + 1], sky_vars[k:k + 1])
        assert torch.equal(one[0], got[k]), k


def test_cpu_tensors_run_the_twin_and_count_nothing(sky_pack, monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    planes = sky_planes(2, seed=5)
    day_time, sky_vars = sky_clocks([7.0, 18.5])
    before = (sky_quantize.launches, sky_quantize.frames)
    got = sky_quantize(planes, sky_pack, SKY_H, SKY_W, day_time, sky_vars)
    assert (sky_quantize.launches, sky_quantize.frames) == before
    assert torch.equal(got, sky_quantize_torch(planes, sky_pack, SKY_H, SKY_W,
                                               day_time, sky_vars))


def _swap(planes, i, t):
    return tuple(planes[:i]) + (t,) + tuple(planes[i + 1:])


def _strided(t):
    """t's values in a tensor of its shape that is not contiguous."""
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


# each input the wrapper refuses: its arguments from good ones
BAD = {
    "six planes": lambda p, s, t, v: (p[:6], s, t, v),
    "a float64 plane": lambda p, s, t, v: (_swap(p, 4, p[4].double()), s,
                                           t, v),
    "an int32 miss weight": lambda p, s, t, v: (_swap(p, 3, p[3].int()), s,
                                                t, v),
    "a plane of another shape": lambda p, s, t, v: (
        _swap(p, 1, p[1][:, :-1]), s, t, v),
    "two-axis planes": lambda p, s, t, v: (tuple(x[0] for x in p), s, t, v),
    "an empty frame": lambda p, s, t, v: (tuple(x[:, :0] for x in p), s, t,
                                          v),
    "a strided plane": lambda p, s, t, v: (_swap(p, 5, _strided(p[5])), s,
                                           t, v),
    "a float32 stack": lambda p, s, t, v: (p, s.float(), t, v),
    "a strided stack": lambda p, s, t, v: (p, _strided(s), t, v),
    "a stack of another size": lambda p, s, t, v: (
        p, s[:, :-1].contiguous(), t, v),
    "a clock missing": lambda p, s, t, v: (p, s, t[:1], v),
    "a float64 clock": lambda p, s, t, v: (p, s, t.double(), v),
    "three weights": lambda p, s, t, v: (p, s, t, v[:, :3].contiguous()),
    "strided weights": lambda p, s, t, v: (p, s, t, _strided(v)),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_refuses_what_the_kernel_would_not_take(sky_pack, bad):
    planes = sky_planes(2, seed=9, h=8, w=12)
    day_time, sky_vars = sky_clocks([6.0, 12.0])
    p, s, t, v = BAD[bad](planes, sky_pack, day_time, sky_vars)
    with pytest.raises(ValueError):
        sky_quantize(p, s, SKY_H, SKY_W, t, v)


def test_launch_counters_list_the_sky_kernel_and_every_earlier_counter():
    """The Engine's capture and rtbench's launch counts read this list: the
    counters it held before the sky kernel, in order, then the sky's."""
    assert loop._launch_counters() == [
        (pack_frame, "launches"), (raytrace_planes, "launches"),
        (raytrace_planes_batch, "launches"),
        (raytrace_planes_batch, "frames"), (fxaa, "launches"),
        (fxaa_batch, "launches"), (fxaa_batch, "frames"),
        (fxaa_ext, "launches"), (fxaa_ext, "frames"),
        (sky_quantize, "launches"), (sky_quantize, "frames")]
