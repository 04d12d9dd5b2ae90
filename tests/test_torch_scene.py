"""The port's scene builders and megakernel packs against the JAX package.

Same scene, same derived frame state, through both packages: the scene
arrays, the packed coefficient table, the params vector and the cluster
bounds must be equal bit for bit (tolerance: none).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.render import pallas_rt as jrt
from raytracing_cuda_tpu.scene import builders as jb
from raytracing_cuda_tpu.sim import state as jsim
from raytracing_cuda_tpu_torch import interop
from raytracing_cuda_tpu_torch.render import cuda_rt as trt
from raytracing_cuda_tpu_torch.scene import builders as tb

torch.set_num_threads(2)

SCENES = {"island": (jb.build_scene, tb.build_scene),
          "classic": (jb.build_classic_scene, tb.build_classic_scene)}
CLUSTERS = {"island": (jb.ISLAND_TRI_CLUSTERS, jb.ISLAND_SPH_CLUSTERS,
                       jb.ISLAND_TRI_SUBS),
            "island_flat": (None, None, None),
            "classic": (None, None, None)}


def _np_fields(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _derived(kind: str, day: float):
    """JAX derive_frame at a settled state → (jax scene_f, lights, ambient)."""
    scene = SCENES["classic" if kind == "classic" else "island"][0]()
    st = jsim.settle(jsim.init_state()._replace(day_time=jnp.float32(day)))
    return jsim.derive_frame(scene, st), st


@pytest.mark.parametrize("kind", sorted(SCENES))
def test_scene_arrays_match(kind):
    jax_scene, torch_scene = (f() for f in SCENES[kind])
    for name, ref in _np_fields(jax_scene).items():
        got = getattr(torch_scene, name).numpy()
        assert got.dtype == ref.dtype, name
        assert np.array_equal(got, ref), name


def test_island_partitions_match():
    assert tb.ISLAND_TRI_CLUSTERS == jb.ISLAND_TRI_CLUSTERS
    assert tb.ISLAND_SPH_CLUSTERS == jb.ISLAND_SPH_CLUSTERS
    assert tb.ISLAND_TRI_SUBS == jb.ISLAND_TRI_SUBS
    assert tb.CLASSIC_CAMERA == jb.CLASSIC_CAMERA


@pytest.mark.parametrize("day", [6.0, 17.6])
@pytest.mark.parametrize("kind", sorted(CLUSTERS))
def test_pack_scene_matches(kind, day):
    (scene_f, _, _), _ = _derived(kind, day)
    tc, sc, _ = CLUSTERS[kind]
    ref = np.asarray(jrt.pack_scene(scene_f, tc, sc))[:, 0, :]
    got = trt.pack_scene(interop.scene_from_numpy(_np_fields(scene_f)), tc,
                         sc).numpy()
    assert got.shape == ref.shape
    assert np.array_equal(got, ref), np.argwhere(got != ref)[:10]


@pytest.mark.parametrize("kind", sorted(CLUSTERS))
def test_cluster_bounds_match(kind):
    (scene_f, _, _), _ = _derived(kind, 9.0)
    tc, sc, subs = CLUSTERS[kind]
    ref = np.asarray(jrt.cluster_bounds(scene_f, tc, sc, subs))
    got = trt.cluster_bounds(interop.scene_from_numpy(_np_fields(scene_f)),
                             tc, sc, subs).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("day", [1.0, 9.0, 14.0])
def test_pack_params_match(day):
    (scene_f, lights, ambient), st = _derived("island", day)
    rays = jsim.camera_rays(st.cam, 160 / 96)
    ref = np.asarray(jrt.pack_params(rays, lights, ambient,
                                     scene_f.plane_pos[1], row0=48))
    t = lambda v: torch.from_numpy(np.array(v))
    got = trt.pack_params(
        trt.CameraRays(*(t(v) for v in rays)),
        trt.Lights(*(t(v) for v in lights)), t(ambient),
        t(scene_f.plane_pos[1]), row0=48).numpy()
    assert np.array_equal(got, ref)


def test_pack_layout_and_pad_rows():
    """Island: 152 rows = plane + 112 triangle rows + 32 sphere rows + tail;
    every pad row has gidx 1e9, r² = −1 and zero triangle coefficients."""
    scene = tb.build_scene()
    coef = trt.pack_scene(scene, tb.ISLAND_TRI_CLUSTERS,
                          tb.ISLAND_SPH_CLUSTERS)
    assert tuple(coef.shape) == (152, trt.N_CHANNELS)
    assert sum(trt.tri_cluster_pads(48 + 48 + 10, tb.ISLAND_TRI_CLUSTERS)) \
        == 112
    pad = coef[:, trt.C_GIDX] > 1e8
    assert int(pad.sum()) == 152 - 133
    assert bool((coef[pad, trt.C_R2] == -1).all())
    assert not coef[pad][:, trt.C_CDET:trt.C_V0N + 1].any()


def test_cuda_source_constants_match():
    """The channel and slot constants of kernel A's body
    (csrc/raytrace_body.cuh, which csrc/raytrace.cu and
    csrc/raytrace_arms.cu compile) equal cuda_rt's."""
    src = (Path(trt.__file__).parents[1] / "csrc"
           / "raytrace_body.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert len(consts) > 30
    for name, value in consts.items():
        if name.startswith(("C_", "P_", "N_", "MAX_")):
            assert getattr(trt, name) == int(value), name
