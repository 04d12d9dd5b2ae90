"""The megakernel's plain PyTorch version against the JAX Pallas kernel.

Both packages render the same scene and state into the 7 planes at 96x160:
the JAX side runs `render_base_planes_pallas(..., interpret=True)` with the
island cluster partitions (the way tests/test_render_fast.py runs it), the
port runs `raytrace_planes_torch` on packs built from the same state.

Tolerances (float32 ulps in the hit tests, shadow tests and reflections can
flip a single pixel's outcome, and mirror chains amplify ulps):
  - hit/miss class (miss weight > 0) differs on < 0.3 % of pixels;
  - on class-agreeing pixels, the RGB planes differ by more than 1/255 on
    < 0.3 % of pixels and by at most 0.5 anywhere; the miss weight within
    1e-6; the miss direction by more than 1e-4 on < 1 % of pixels and by at
    most 0.01 anywhere.
"""

import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.render.pallas_rt import render_base_planes_pallas
from raytracing_cuda_tpu.scene import builders as jb
from raytracing_cuda_tpu.sim import state as jsim
from raytracing_cuda_tpu_torch import interop
from raytracing_cuda_tpu_torch.render import cuda_rt as trt
from raytracing_cuda_tpu_torch.render.pipeline import host_packs
from raytracing_cuda_tpu_torch.scene import builders as tb
from tests.test_golden import CASES, classic_env, make_state
from tests.test_torch_sim import jax_fields

torch.set_num_threads(2)

H, W = 96, 160


def _env(name):
    if name == "classic":
        js, st = classic_env()
        return js, st, tb.build_classic_scene(), (None, None)
    return (jb.build_scene(), make_state(**CASES[name]), tb.build_scene(),
            (jb.ISLAND_TRI_CLUSTERS, jb.ISLAND_SPH_CLUSTERS))


def _port_planes(tscene, jstate, tc, sc, h=H, row0=0, total_h=None,
                 chunk=65536):
    st = interop.state_from_numpy(jax_fields(jstate))
    coef, params, nt, ns = host_packs(tscene, st, total_h or h, W, None, tc,
                                      sc)
    return torch.stack(trt.raytrace_planes_torch(
        coef, params, h, W, nt, ns, row0, total_h, chunk)).numpy()


@pytest.mark.parametrize("name", sorted(CASES) + ["classic"])
def test_plain_matches_pallas_interpret(name):
    js, st, ts, (tc, sc) = _env(name)
    scene_f, lights, ambient = jsim.derive_frame(js, st)
    rays = jsim.camera_rays(st.cam, W / H)
    ref = np.stack([np.asarray(p) for p in render_base_planes_pallas(
        scene_f, lights, ambient, rays, H, W, interpret=True,
        tri_clusters=tc, sph_clusters=sc)])
    got = _port_planes(ts, st, tc, sc)
    assert got.shape == ref.shape == (7, H, W)
    assert np.isfinite(got).all()

    cls = (ref[3] > 0) != (got[3] > 0)
    assert cls.mean() < 0.003, f"{cls.sum()} hit/miss mismatches"
    d = np.abs(ref - got)[:, ~cls]
    rgb, mw, mdir = d[:3], d[3], d[4:]
    assert (rgb > 1 / 255).any(0).mean() < 0.003
    assert rgb.max() <= 0.5
    assert mw.max() <= 1e-6
    assert (mdir > 1e-4).any(0).mean() < 0.01
    assert mdir.max() <= 0.01


def test_plain_is_chunk_invariant():
    js, st, ts, (tc, sc) = _env("island_morning")
    a = _port_planes(ts, st, tc, sc)
    b = _port_planes(ts, st, tc, sc, chunk=1000)
    assert np.array_equal(a, b)


def test_row_band_matches_full_frame():
    """row0/total_h render a band of the full frame with its exact rays."""
    js, st, ts, (tc, sc) = _env("mountains_day")
    full = _port_planes(ts, st, tc, sc)
    band = _port_planes(ts, st, tc, sc, h=32, row0=40, total_h=H)
    assert np.array_equal(band, full[:, 40:72])


def test_wrapper_runs_plain_version_on_cpu():
    js, st, ts, (tc, sc) = _env("island_night")
    tst = interop.state_from_numpy(jax_fields(st))
    coef, params, nt, ns = host_packs(ts, tst, H, W, None, tc, sc)
    before = trt.raytrace_planes.launches
    a = torch.stack(trt.raytrace_planes(coef, params, H, W, nt, ns))
    b = torch.stack(trt.raytrace_planes_torch(coef, params, H, W, nt, ns))
    assert torch.equal(a, b)
    assert trt.raytrace_planes.launches == before
