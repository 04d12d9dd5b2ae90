"""The port's PIL-free PNG reader and RMSE against PIL and the JAX package.

Every golden frame in tests/golden/ (96x160, 1280x720 and 1920x1080, PIL-
written with adaptive scanline filters) must decode to exactly PIL's
pixels (tolerance: none).
"""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from raytracing_cuda_tpu.utils import images as jimages
from raytracing_cuda_tpu_torch.utils import images as timages

GOLDEN = Path(__file__).parent / "golden"
PNGS = sorted(str(p.relative_to(GOLDEN)) for p in GOLDEN.rglob("*.png"))


def test_every_golden_is_listed():
    assert len(PNGS) >= 17


@pytest.mark.parametrize("rel", PNGS)
def test_load_png_matches_pil(rel):
    ref = np.asarray(Image.open(GOLDEN / rel).convert("RGB"))
    got = timages.load_png(str(GOLDEN / rel))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_load_png_all_filter_types(tmp_path, mode):
    """A noise image with smooth ramps makes PIL's encoder pick every
    filter type; RGBA drops its alpha channel."""
    rng = np.random.default_rng(0)
    h, w = 37, 53
    ramp = (np.arange(w)[None, :, None] * 3 + np.arange(h)[:, None, None])
    img = np.where(rng.random((h, w, 1)) < 0.5, ramp % 256,
                   rng.integers(0, 256, (h, w, 1))).astype(np.uint8)
    img = np.repeat(img, len(mode), axis=2)
    img[..., 0] = rng.integers(0, 256, (h, w))
    path = tmp_path / "t.png"
    Image.fromarray(img, mode=mode).save(path)
    assert np.array_equal(timages.load_png(str(path)), img[..., :3])


def test_load_png_rejects_other_formats(tmp_path):
    path = tmp_path / "g.png"
    Image.fromarray(np.zeros((4, 4), np.uint8), mode="L").save(path)
    with pytest.raises(ValueError):
        timages.load_png(str(path))


def test_rmse_matches_jax_package():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (9, 7, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (9, 7, 3)).astype(np.uint8)
    assert timages.rmse(a, b) == jimages.rmse(a, b)
