"""The port's sky path (procedural panoramas, static pack, flat pair lookup)
against the JAX package.

Tolerances: the panoramas, the packed stack and every fetched texel match
bit for bit. The texel *index* comes from asin/atan2, whose float32 results
may differ by an ulp between the two libraries; where that moves a
direction across a texel edge the index flips to the neighbour. Such flips
are counted and must stay under MAX_FLIP_FRAC of the directions, and every
flip is to an adjacent texel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.scene import textures as jtx
from raytracing_cuda_tpu.sim import state as jsim
from raytracing_cuda_tpu_torch.scene import textures as ttx
from raytracing_cuda_tpu_torch.sim import state as tsim

torch.set_num_threads(2)

SKY_H, SKY_W = 64, 128
MAX_FLIP_FRAC = 1e-3


@pytest.fixture(scope="module")
def skies():
    texels = ttx.procedural_skies(SKY_H, SKY_W)
    jpack = np.array(jtx.sky_static_init(jnp.asarray(texels), grouped=False))
    return texels, jpack


def directions(seed: int, n: int = 20000) -> np.ndarray:
    """Random unit directions plus the poles and axis-aligned edge cases."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    special = np.array([[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0],
                        [0, 0, 1], [0, 0, -1]], np.float32)
    return np.concatenate([special, d]).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 128), (96, 192)])
def test_procedural_skies_match(shape):
    assert np.array_equal(ttx.procedural_skies(*shape),
                          jtx.procedural_skies(*shape))


def test_pack_sky_all_matches(skies):
    texels, jpack = skies
    tpack = ttx.pack_sky_all(torch.from_numpy(texels)).numpy()
    assert tpack.dtype == np.int32 and np.array_equal(tpack, jpack)


@pytest.mark.parametrize("day", [1.0, 6.0, 9.0, 14.0, 17.25, 21.0])
def test_sky_blend_bands_match(day):
    sv = jsim.calc_sky_vars(jnp.float32(day))
    ref = [np.asarray(v) for v in jtx.sky_blend_bands(sv)]
    got = ttx.sky_blend_bands(tsim.calc_sky_vars(torch.tensor(day)))
    assert [int(ref[0]), int(ref[1])] == list(got[:2])
    assert np.float32(ref[2]) == got[2] and np.float32(ref[3]) == got[3]


@pytest.mark.parametrize("seed,day", [(0, 6.0), (1, 9.0), (2, 14.0),
                                      (3, 17.25), (4, 1.0)])
def test_flat_pair_lookup_matches(skies, seed, day):
    texels, jpack = skies
    d = directions(seed)
    day_frac = np.float32(day) / np.float32(24.0)
    sv = jsim.calc_sky_vars(jnp.float32(day))
    jiy, jix = (np.asarray(v) for v in jtx._equirect_indices(
        SKY_H, SKY_W, jnp.asarray(d), jnp.float32(day_frac)))
    tiy, tix = (v.numpy() for v in ttx._equirect_indices(
        SKY_H, SKY_W, torch.from_numpy(d), float(day_frac)))
    flips = (jiy != tiy) | (jix != tix)
    assert flips.mean() < MAX_FLIP_FRAC, int(flips.sum())
    assert np.all(np.abs(jiy - tiy) <= 1)
    dx = np.abs(jix - tix)
    assert np.all((dx <= 1) | (dx == SKY_W - 1))     # wraps at the seam

    ref = np.asarray(jtx.sample_sky_packed_pair(
        jnp.asarray(jpack), SKY_H, SKY_W, jnp.asarray(d),
        jnp.float32(day_frac), sv))
    got = ttx.sample_sky_packed_pair(
        torch.from_numpy(jpack), SKY_H, SKY_W, torch.from_numpy(d),
        torch.tensor(day_frac), torch.from_numpy(np.array(sv))).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got[~flips], ref[~flips])


def test_load_skies_procedural_only(tmp_path):
    """Where no reference panoramas exist, 'procedural' and 'auto' give the
    procedural family, and 'reference' names the missing file."""
    for source in ("procedural", "auto"):
        sky = ttx.load_skies(source, procedural_shape=(16, 32),
                             path=str(tmp_path / "absent"))
        assert sky.texels.shape == (4, 16, 32, 3)
    with pytest.raises(FileNotFoundError, match="morning.png"):
        ttx.load_skies("reference", path=str(tmp_path / "absent"))
    with pytest.raises(ValueError):
        ttx.load_skies("cubemap")
