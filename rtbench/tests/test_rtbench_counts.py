"""The roofline counts at the cells' sizes, worked out by hand."""

import pytest

from rtbench.counts import PEAKS, Count, fxaa, frame, raytrace, scene_bytes

ISLAND = {"planes": 1, "triangles": 106, "spheres": 26}
SCENE = 4 * (15 * 106 + 10 * 26 + 12 * 1 + 32)


def test_scene_bytes():
    assert scene_bytes(ISLAND) == SCENE == 7576


@pytest.mark.parametrize("w,h", [(1280, 720), (1920, 1080)])
def test_kernel_a_is_bytes_bound(w, h):
    c = raytrace.count(w, h, ISLAND)
    assert c == Count(SCENE + 28 * w * h, 224 * w * h)
    assert c.bound_by() == "bytes"
    assert c.seconds() == pytest.approx(c.nbytes / 3.35e12)


def test_kernel_a_at_720p():
    assert raytrace.count(1280, 720, ISLAND).seconds() * 1e6 == \
        pytest.approx(7.7052, abs=1e-4)
    assert raytrace.count(1920, 1080, ISLAND).seconds() * 1e6 == \
        pytest.approx(17.3338, abs=1e-4)


@pytest.mark.parametrize("w,h,us", [(1280, 720, 1.6529), (1920, 1080, 3.7173)])
def test_kernel_b(w, h, us):
    c = fxaa.count(w, h)
    assert c.nbytes == 3 * w * (h + 2) + 3 * w * h
    assert c.ops == 19 * (w - 2) * (h - 2)
    assert c.bound_by() == "bytes"
    assert c.seconds() * 1e6 == pytest.approx(us, abs=1e-4)


@pytest.mark.parametrize("w,h", [(1280, 720), (1920, 1080)])
def test_the_frame_is_bounded_by_its_operations(w, h):
    c = frame.count(w, h, ISLAND)
    assert c.nbytes == frame.STATE_BYTES + SCENE + 3 * w * h
    assert c.ops == 224 * w * h + fxaa.count(w, h).ops
    assert c.bound_by() == "operations"
    assert c.seconds() == pytest.approx(c.ops / PEAKS["f32_ops_per_s"])


def test_merged_stages_are_charged_the_sum():
    a, b = raytrace.count(1280, 720, ISLAND), fxaa.count(1280, 720)
    assert (a + b) == Count(a.nbytes + b.nbytes, a.ops + b.ops)
