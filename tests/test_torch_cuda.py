"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped where torch.cuda.is_available() is false (the
decision is made inside the fixture, never at import). Imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:
    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: both kernels perform the plain versions' float32 operations in
the same order with the same rounding (the kernels are built with
-fmad=false; the plain versions divide truly on the device), so kernel and
plain version must agree bit for bit on the card. Against the CPU plain
versions (other exp2/log2 implementations), frames must meet the golden
contract: RMSE < 2e-3 and < 0.3 % of pixels off by more than 2 levels.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (CASES, GOLDEN_OFF_FRAC, GOLDEN_RMSE, golden_stats,
                        make_state)
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa
from raytracing_cuda_tpu_torch.render.pipeline import host_packs
from raytracing_cuda_tpu_torch.scene import builders as tb
from raytracing_cuda_tpu_torch.utils.config import RenderConfig

pytestmark = pytest.mark.cuda

H, W = 96, 160
SKY = (64, 128)


def small_engine(device="cpu", **kw) -> Engine:
    return Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY,
                               **kw), device=device)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _packs(name, dev):
    if name == "classic":
        eng = small_engine(scene="classic")
        scene, st, tc, sc = eng.scene, eng.state, None, None
    else:
        scene, st = tb.build_scene(), make_state(**CASES[name])
        tc, sc = tb.ISLAND_TRI_CLUSTERS, tb.ISLAND_SPH_CLUSTERS
    coef, params, nt, ns = host_packs(scene, st, H, W, None, tc, sc)
    return coef.to(dev), params.to(dev), nt, ns


@pytest.mark.parametrize("name", sorted(CASES) + ["classic"])
def test_raytrace_kernel_matches_plain(dev, name):
    coef, params, nt, ns = _packs(name, dev)
    before = cuda_rt.raytrace_planes.launches
    kern = torch.stack(cuda_rt.raytrace_planes(coef, params, H, W, nt, ns))
    torch.cuda.synchronize()
    assert cuda_rt.raytrace_planes.launches == before + 1
    plain = torch.stack(cuda_rt.raytrace_planes_torch(coef, params, H, W, nt,
                                                      ns))
    assert torch.equal(kern, plain)


def test_raytrace_kernel_row_band(dev):
    coef, params, nt, ns = _packs("mountains_day", dev)
    full = torch.stack(cuda_rt.raytrace_planes(coef, params, H, W, nt, ns))
    band = torch.stack(cuda_rt.raytrace_planes(coef, params, 32, W, nt, ns,
                                               row0=40, total_h=H))
    assert torch.equal(band, full[:, 40:72])


@pytest.mark.parametrize("shape", [(96, 160), (720, 1280), (37, 53)])
def test_fxaa_kernel_matches_plain(dev, shape):
    img = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, shape + (3,)).astype(np.uint8)).to(dev)
    before = fxaa.fxaa.launches
    out = fxaa.fxaa(img)
    torch.cuda.synchronize()
    assert fxaa.fxaa.launches == before + 1
    assert torch.equal(out, fxaa.fxaa_torch(img))


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_cuda_matches_cpu(dev, name):
    frames = []
    for device in ("cpu", "cuda"):
        eng = small_engine(device)
        eng.set_state(make_state(**CASES[name]))
        frames.append(eng.frame_np())
    rmse, off = golden_stats(frames[1], frames[0])
    assert rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC, (rmse, off)


def test_wrappers_reject_bad_inputs(dev):
    coef, params, nt, ns = _packs("island_morning", dev)
    with pytest.raises(ValueError):
        cuda_rt.raytrace_planes(coef.double(), params, H, W, nt, ns)
    with pytest.raises(ValueError):
        fxaa.fxaa(torch.zeros((4, 4, 3), dtype=torch.float32, device=dev))
