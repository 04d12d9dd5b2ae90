"""The port's FXAA (plain PyTorch version) against the JAX package.

Inputs are the four golden states' pre-FXAA frames (rendered by the port at
96x160) and a noise image. The port rounds luminance as XLA compiles the
JAX stencil (fused multiply-adds, times 1/255), the arithmetic that wrote
the golden frames; the rest of the stencil is rounded op by op. Tolerances:
  - luminance against the jitted JAX luminance: bit for bit;
  - frames against the jitted JAX stencil: at most 1 level on any channel
    (the final blend is rounded once more there before truncation);
  - against the stencil run eagerly and the Pallas kernel in interpret mode,
    which resolve a few luminance-comparison ties the other way: the gate
    of tests/test_fxaa.py:89-112, RMSE < 2.5e-3 and < 1 % of pixels
    differing, on rendered frames.
Plus the behavioural contract of tests/test_fxaa.py on synthetic tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.render import fxaa as jfx
from raytracing_cuda_tpu_torch.render import fxaa as tfx
from tests.test_golden import CASES
from tests.test_torch_slice import make_state, small_engine

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    eng = small_engine(antialiasing=False)
    out = {}
    for name, kw in CASES.items():
        eng.set_state(make_state(**dict(kw, aa=False)))
        out[name] = eng.frame_np()
    out["noise"] = np.random.default_rng(7).integers(
        0, 256, (64, 160, 3)).astype(np.uint8)
    return out


def _port(img: np.ndarray) -> np.ndarray:
    return tfx.fxaa_torch(torch.from_numpy(img)).numpy()


@pytest.mark.parametrize("name", sorted(CASES) + ["noise"])
def test_plain_within_one_level_of_jitted_jax(frames, name):
    img = frames[name]
    got = _port(img)
    ref = np.asarray(jax.jit(jfx.fxaa)(jnp.asarray(img)))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert (got != img).any()                 # FXAA did change pixels


@pytest.mark.parametrize("variant", ["eager", "pallas_interpret"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_other_jax_variants_within_gate(frames, name, variant):
    img = jnp.asarray(frames[name])
    ref = (jfx.fxaa(img) if variant == "eager"
           else jfx.fxaa_pallas(img, interpret=True))
    d = np.abs(_port(frames[name]).astype(int) - np.asarray(ref).astype(int))
    assert np.sqrt(np.mean((d / 255.0) ** 2)) < 2.5e-3
    assert np.mean(d.max(-1) > 0) < 0.01


def test_luminance_matches_jitted_jax():
    img = np.random.default_rng(3).integers(0, 256, (64, 64, 3)).astype(
        np.float32)
    assert np.array_equal(tfx.luminance(torch.from_numpy(img)).numpy(),
                          np.asarray(jax.jit(jfx.luminance)(
                              jnp.asarray(img))))
    assert tfx.LUMA_WEIGHTS == jfx.LUMA_WEIGHTS
    assert (tfx.CONTRAST_THRESHOLD, tfx.RELATIVE_THRESHOLD) == (
        jfx.CONTRAST_THRESHOLD, jfx.RELATIVE_THRESHOLD)


def test_flat_and_low_contrast_pass_through():
    img = np.full((16, 24, 3), 100, np.uint8)
    assert np.array_equal(_port(img), img)
    img[:, 12:] = 103                         # step below the 0.0312 floor
    assert np.array_equal(_port(img), img)


def test_borders_pass_through_and_edges_blend():
    img = np.random.default_rng(7).integers(0, 256, (20, 32, 3)).astype(
        np.uint8)
    out = _port(img)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        assert np.array_equal(out[sl], img[sl])
    edge = np.zeros((16, 16, 3), np.uint8)
    edge[8:] = 200                            # horizontal edge: row 7 moves
    assert (_port(edge)[7, 1:-1].astype(int) > 0).all()
    edge = np.zeros((16, 16, 3), np.uint8)
    edge[:, 8:] = 200                         # vertical edge: column 7 moves
    assert (_port(edge)[1:-1, 7].astype(int) > 0).all()


def test_wrapper_and_toggle_on_cpu():
    img = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (16, 16, 3)).astype(np.uint8))
    before = tfx.fxaa.launches
    assert torch.equal(tfx.fxaa(img), tfx.fxaa_torch(img))
    assert tfx.apply_fxaa(img, False) is img
    assert torch.equal(tfx.apply_fxaa(img, True), tfx.fxaa_torch(img))
    assert tfx.fxaa.launches == before
