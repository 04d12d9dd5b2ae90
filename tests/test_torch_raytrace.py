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
from raytracing_cuda_tpu_torch.sim.state import derive_frame
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


ISLAND_CULL = (tb.ISLAND_TRI_CLUSTERS, tb.ISLAND_SPH_CLUSTERS,
               tb.ISLAND_TRI_SUBS)


def _island_packs(name):
    """(the frame's derived scene, its packs)."""
    st = interop.state_from_numpy(jax_fields(make_state(**CASES[name])))
    scene = tb.build_scene()
    coef, params, nt, ns = host_packs(scene, st, H, W, None, *ISLAND_CULL)
    return derive_frame(scene, st)[0], coef, params, nt, ns


def test_cull_groups_follow_the_bounds():
    """Group g holds real rows whose geometry lies inside bound g; the real
    triangle (sphere) rows, in table order, are the scene's triangles
    (spheres) in order."""
    scene, coef, params, nt, ns = _island_packs("island_morning")
    groups = trt.cull_groups(scene.n_triangles, scene.n_spheres,
                             *ISLAND_CULL)
    bounds = params[trt.P_CLUSTERS:].reshape(-1, 4)[:len(groups)]
    assert len(groups) == len(trt.cluster_bounds(scene, *ISLAND_CULL))
    real = (coef[:, trt.C_GIDX] < 1e9).nonzero().squeeze(1).tolist()
    order = {row: i for i, row in enumerate(r for r in real
                                                if 0 < r < 1 + nt)}
    order.update({row: i for i, row in enumerate(r for r in real
                                                 if r >= 1 + nt)})
    v0 = scene.tri_v0
    verts = torch.stack([v0, v0 + scene.tri_e1, v0 + scene.tri_e2], 1)
    seen = []
    for (first, cnt), bound in zip(groups, bounds):
        c, r = bound[:3], bound[3]
        for row in range(first, first + cnt):
            i = order[row]
            if row < 1 + nt:
                assert ((verts[i] - c).norm(dim=1) <= r).all(), (row, i)
            else:
                assert ((scene.sph_pos[i] - c).norm() + scene.sph_r[i]
                        <= r), (row, i)
            seen.append(row)
    assert sorted(seen) == real[1:]


def test_reach_is_sound():
    """No ray meets a row, before its distance bound, under a bound that
    reach says it cannot meet."""
    scene, coef, params, nt, ns = _island_packs("mountains_day")
    groups = trt.cull_groups(scene.n_triangles, scene.n_spheres,
                             *ISLAND_CULL)
    bounds = params[trt.P_CLUSTERS:].reshape(-1, 4)[:len(groups)]
    rng = np.random.default_rng(3)
    d = torch.from_numpy(rng.normal(size=(4000, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    o = torch.from_numpy(rng.uniform(-60, 60, (4000, 3)).astype(np.float32))
    o[:2000] = params[trt.P_CAMPOS:trt.P_CAMPOS + 3]     # the camera's rays
    t_hi = torch.from_numpy(rng.uniform(1, 400, 4000).astype(np.float32))
    t_hi[:1000] = trt.BIG
    reached = trt.reach(bounds, *o.unbind(1), *d.unbind(1), t_hi)
    m = torch.cross(o, d, dim=1)
    col = lambda v: v[:, None]
    hits = 0
    for g, (first, cnt) in enumerate(groups):
        rows = coef[first:first + cnt]
        if first < 1 + nt:
            t = trt._tri_t(rows, *map(col, (*o.unbind(1), *d.unbind(1),
                                            *m.unbind(1))))
        else:
            t = trt._sph_t(rows, *map(col, (*o.unbind(1), *d.unbind(1))))
        met = (t < col(t_hi)) & (t < trt.BIG * 0.5)
        hits += int(met.sum())
        assert not (met & ~col(reached[:, g])).any(), g
    assert hits > 100 and not reached.all()


def test_work_counts_rows_under_reached_bounds():
    """The rows a ray can reach are fewer than all rows, and counting
    leaves the planes as they are."""
    scene, coef, params, nt, ns = _island_packs("island_morning")
    cull = trt.cull_groups(scene.n_triangles, scene.n_spheres, *ISLAND_CULL)
    work = dict.fromkeys(trt.WORK_KEYS, 0)
    a = trt.raytrace_planes_torch(coef, params, H, W, nt, ns)
    b = trt.raytrace_planes_torch(coef, params, H, W, nt, ns, work=work,
                                  cull=cull)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert H * W <= work["rays"] and 0 < work["occluded"] < work["shadow"]
    clear = work["shadow"] - work["occluded"]
    for key, most in (("tri_tests", work["rays"] * scene.n_triangles),
                      ("sph_tests", work["rays"] * scene.n_spheres),
                      ("shadow_tri_tests", clear * scene.n_triangles),
                      ("shadow_sph_tests", clear * scene.n_spheres)):
        assert 0 < work[key] < most / 3, key
    with pytest.raises(ValueError, match="cull groups"):
        trt.raytrace_planes_torch(coef, params, H, W, nt, ns, work=work)
