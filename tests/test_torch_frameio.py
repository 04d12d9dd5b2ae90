"""The port's frame output: the PIL-free PNG writer and reader
(utils/images.py) and the ctypes bindings to native/frameio/frameio.cpp
(utils/frameio.py), built with g++ into a temporary directory here.

Each test starts from an unloaded library (monkeypatch restores the
module's state afterwards), so the tests do not depend on their order.
"""

import shutil

import numpy as np
import pytest

from raytracing_cuda_tpu_torch.utils import frameio
from raytracing_cuda_tpu_torch.utils.images import load_png, save_png


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setattr(frameio, "_lib", None)
    monkeypatch.setattr(frameio, "_fallback_level", 0)
    monkeypatch.setattr(frameio, "_warned", False)


@pytest.fixture
def native(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build libframeio")
    assert frameio.build(tmp_path / "build")
    assert frameio.available()
    yield frameio
    frameio.set_png_level(0)


def rand_img(seed, h=37, w=61):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(
        np.uint8)


def gradient_img():
    x = np.linspace(0, 255, 96, dtype=np.uint8)
    img = np.stack([np.tile(x, (48, 1))] * 3, axis=-1)
    img[20:30, 40:60] = (200, 30, 30)
    return img


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_save_png_roundtrip(tmp_path, level):
    img = rand_img(level)
    p = str(tmp_path / "x.png")
    save_png(img, p, level)
    assert np.array_equal(load_png(p), img)


def test_save_png_readable_by_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img = rand_img(5)
    save_png(img, str(tmp_path / "x.png"))
    back = np.asarray(Image.open(str(tmp_path / "x.png")).convert("RGB"))
    assert np.array_equal(back, img)


def test_save_png_rejects_bad_frames(tmp_path):
    with pytest.raises(ValueError):
        save_png(np.zeros((4, 4), np.uint8), str(tmp_path / "x.png"))
    with pytest.raises(ValueError):
        save_png(np.zeros((4, 4, 3), np.float32), str(tmp_path / "x.png"))


@pytest.mark.parametrize("level", [0, 6])
def test_native_write_png_roundtrip(native, tmp_path, level):
    """Level 0 (stored deflate, filter 0) and 6 (zlib, Sub filter) decode
    to the same pixels; compression shrinks a gradient frame."""
    img = gradient_img()
    assert native.set_png_level(level) == level
    p = str(tmp_path / f"l{level}.png")
    native.write_png(img, p)
    assert np.array_equal(load_png(p), img)
    odd = rand_img(level)
    native.write_png(odd, p)
    assert np.array_equal(load_png(p), odd)


def test_native_compression_shrinks(native, tmp_path):
    img = gradient_img()
    sizes = []
    for level in (0, 6):
        native.set_png_level(level)
        native.write_png(img, str(tmp_path / f"{level}.png"))
        sizes.append((tmp_path / f"{level}.png").stat().st_size)
    assert sizes[1] < sizes[0] / 3


@pytest.mark.parametrize("threads,level", [(1, 0), (4, 1)])
def test_async_writer_written(native, tmp_path, threads, level):
    frames = [rand_img(i, 16, 24) for i in range(9)]
    native.set_png_level(level)
    with native.AsyncFrameWriter(ring=3, threads=threads) as w:
        for i, f in enumerate(frames):
            w.submit(f, str(tmp_path / f"{i}.png"))
        w.drain()
        assert w.written == 9 and w.failed == 0
    for i, f in enumerate(frames):
        assert np.array_equal(load_png(str(tmp_path / f"{i}.png")), f), i
    with pytest.raises(RuntimeError):
        w.submit(frames[0], str(tmp_path / "late.png"))


def test_async_writer_counts_failures(native, tmp_path):
    with native.AsyncFrameWriter(ring=2) as w:
        w.submit(rand_img(0, 8, 8), str(tmp_path / "missing" / "a.png"))
        w.drain()
        assert w.written == 0 and w.failed == 1


@pytest.mark.parametrize("asked,got", [(-3, 0), (0, 0), (5, 5), (12, 9)])
def test_png_level_clamp(native, asked, got):
    assert native.set_png_level(asked) == got


def test_native_lib_reused_from_build_dir(native, tmp_path):
    """build() twice into one directory compiles once (hash-named file)."""
    built = sorted((tmp_path / "build").glob("libframeio-*.so"))
    assert len(built) == 1
    assert frameio.build(tmp_path / "build")
    assert sorted((tmp_path / "build").glob("libframeio-*.so")) == built


def test_now_ns_monotonic(native):
    a = native.now_ns()
    b = native.now_ns()
    assert b >= a > 0


def test_fallback_without_library(tmp_path, monkeypatch, capsys):
    """No source (or no g++): build() fails soft, write_png goes through
    images.save_png at the requested level and says so once; the level
    clamp still applies; AsyncFrameWriter refuses."""
    monkeypatch.setattr(frameio, "SOURCE", tmp_path / "absent.cpp")
    assert not frameio.build(tmp_path / "build")
    assert not frameio.available()
    assert frameio.set_png_level(12) == 9
    img = rand_img(3)
    for name in ("a.png", "b.png"):
        frameio.write_png(img, str(tmp_path / name))
        assert np.array_equal(load_png(str(tmp_path / name)), img)
    assert capsys.readouterr().err.count("unavailable") == 1
    with pytest.raises(RuntimeError):
        frameio.AsyncFrameWriter()
    assert frameio.now_ns() > 0
