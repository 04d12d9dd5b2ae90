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
from raytracing_cuda_tpu_torch.render.pipeline import frame_packs
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
    coef, params, nt, ns, _ = frame_packs(tscene, st, total_h or h, W, None,
                                         tc, sc)
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
    assert_planes_agree(ref, got)


def assert_planes_agree(ref, got):
    """The tolerances of the module docstring: 7 planes of the JAX kernel
    (ref) against the port's (got), numpy (7, H, W) float32."""
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
    coef, params, nt, ns, _ = frame_packs(ts, tst, H, W, None, tc, sc)
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
    coef, params, nt, ns, _ = frame_packs(scene, st, H, W, None,
                                         *ISLAND_CULL)
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


def _cull_packs(name):
    """(scene, coef, params, n_tri_rows, n_sph_rows, cull groups, cull
    table) of a pose (chip_smoke.POSES) or the classic scene at H x W."""
    from chip_smoke import POSES, make_state as port_state

    if name == "classic":
        scene, st = tb.build_classic_scene(), interop.state_from_numpy(
            jax_fields(classic_env()[1]))
        clusters = (None, None, None)
    else:
        scene, st, clusters = (tb.build_scene(), port_state(**POSES[name]),
                               ISLAND_CULL)
    coef, params, nt, ns, table = frame_packs(scene, st, H, W, None,
                                             *clusters)
    groups = trt.cull_groups(scene.n_triangles, scene.n_spheres, *clusters)
    return scene, coef, params, nt, ns, groups, table


class _Rays(trt._Work):
    """_Work that also keeps every cast ray (origin, direction, the sea
    plane's t) and every shadow ray (origin, direction, light distance,
    occluded) it is shown."""

    cast_rays: list = []
    shadow_rays: list = []

    def cast(self, o, d, t_plane):
        super().cast(o, d, t_plane)
        self.cast_rays.append((o, d, t_plane))

    def shadow(self, o, d, dist, occ):
        super().shadow(o, d, dist, occ)
        self.shadow_rays.append((o, d, dist, occ))


def check_cull_sound(coef, params, nt, ns, groups, table, h, w, monkeypatch):
    """The kernel's culls on every ray of the h x w frame of these packs,
    at every level → (cast rays, rays whose winner is a row, occluded
    shadow rays whose occluder is a row).

    A cast ray's winning row lies under a bound that `reach` passes with
    t_hi = the winning t (the kernel's t_hi, the plane's hit shrunk to the
    best hit so far, is never smaller); an occluded shadow ray that the sea
    plane does not occlude has an occluder under a blocking group's bound
    that `reach` passes with t_hi = its light distance. Every t_hi the
    kernel starts from (the plane's t, the light's distance) is a number
    and not negative, so no comparison against it is lost to a NaN."""
    _Rays.cast_rays, _Rays.shadow_rays = [], []
    monkeypatch.setattr(trt, "_Work", _Rays)
    trt.raytrace_planes_torch(coef, params, h, w, nt, ns,
                              work=dict.fromkeys(trt.WORK_KEYS, 0),
                              cull=groups)
    bounds = params[trt.P_CLUSTERS:].reshape(-1, 4)[:len(groups)]
    n_rows = 1 + nt + ns
    group_of = torch.full((n_rows,), -1, dtype=torch.long)
    for g, (first, cnt) in enumerate(groups):
        group_of[first:first + cnt] = g
    Ct, Cs = coef[1:1 + nt], coef[1 + nt:n_rows]
    gidx = coef[:n_rows, trt.C_GIDX]
    sea_y = params[trt.P_SEAY]
    blocks_row = coef[:n_rows, trt.C_BLOCKS] > 0
    col = lambda v: v[:, None]                       # noqa: E731

    def row_t(o, d):
        """(n, n_rows) t of every row (the plane in column 0)."""
        m = torch.cross(torch.stack(o, 1), torch.stack(d, 1), dim=1)
        return torch.cat([
            col(trt._plane_t(o[1], d[1], sea_y)),
            trt._tri_t(Ct, *map(col, (*o, *d, *m.unbind(1)))),
            trt._sph_t(Cs, *map(col, (*o, *d)))], dim=1)

    n_cast = n_hit = 0
    for o, d, t_plane in _Rays.cast_rays:
        assert not torch.isnan(t_plane).any() and (t_plane >= 0).all()
        t = row_t(o, d)
        t_min = t.amin(1)
        key = torch.where(t == col(t_min), gidx[None, :],
                          torch.full_like(t, 2e9))
        win = key.argmin(1)
        hit = (t_min < trt.BIG * 0.5) & (win > 0)
        reached = trt.reach(bounds, *o, *d, t_min)
        g = group_of[win[hit]]
        assert (g >= 0).all()
        assert reached[hit.nonzero().squeeze(1), g].all()
        n_cast += t.shape[0]
        n_hit += int(hit.sum())
    n_occ = 0
    for o, d, dist, occ in _Rays.shadow_rays:
        assert not torch.isnan(dist).any() and (dist >= 0).all()
        rows = occ & ~(trt._plane_t(o[1], d[1], sea_y) < dist)
        if not rows.any():
            continue
        o, d, dist = [v[rows] for v in o], [v[rows] for v in d], dist[rows]
        t = row_t(o, d)[:, 1:]
        occluder = (t < col(dist)) & blocks_row[None, 1:]
        reached = trt.reach(bounds, *o, *d, dist) & (table[:, 2] > 0)[None]
        under = group_of[1:]
        seen = occluder & (under >= 0)[None] & reached[:, under.clamp(min=0)]
        assert seen.any(1).all()
        n_occ += int(rows.sum())
    return n_cast, n_hit, n_occ


@pytest.mark.parametrize("name", sorted(CASES) + ["worst_pose"])
def test_cull_is_sound_on_the_rays_frames_cast(name, monkeypatch):
    """check_cull_sound on the golden states and the worst pose: frames
    full of row hits and row-occluded shadow rays."""
    scene, coef, params, nt, ns, groups, table = _cull_packs(name)
    n_cast, n_hit, n_occ = check_cull_sound(coef, params, nt, ns, groups,
                                            table, H, W, monkeypatch)
    assert n_cast > H * W and n_hit > H * W // 4 and n_occ > 50


@pytest.mark.parametrize("name", ["island_morning", "classic"])
def test_cull_table_is_cull_groups_with_blocking_flags(name):
    """The table frame_packs builds and the Engine hands the kernel:
    cull_groups' rows, one group per bound written into params, flagged
    exactly where the group holds a row that blocks shadow rays."""
    from raytracing_cuda_tpu_torch.app.loop import Engine
    from raytracing_cuda_tpu_torch.utils.config import RenderConfig

    scene, coef, params, nt, ns, groups, table = _cull_packs(name)
    assert table.dtype == torch.int32 and table.shape == (len(groups), 3)
    assert [tuple(r) for r in table[:, :2].tolist()] == list(groups)
    bounds = params[trt.P_CLUSTERS:].reshape(-1, 4)
    assert (bounds[:len(groups), 3] > 0).all()
    assert not bounds[len(groups):].any()
    blocking = [int((coef[f:f + c, trt.C_BLOCKS] > 0).any())
                for f, c in groups]
    assert table[:, 2].tolist() == blocking
    if name == "island_morning":            # the sun and moon's cluster
        assert blocking == [1] * (len(groups) - 1) + [0]
    eng = Engine(RenderConfig(width=W, height=H, procedural_sky_shape=(32, 64),
                              scene="classic" if name == "classic"
                              else "island"), device="cpu")
    assert torch.equal(eng._packs()[4], table)


def test_engine_copies_the_cull_table_once():
    """The Engine builds the scene's table once, on its device: every
    frame's packs hand the kernel that same tensor, equal to the table
    built from the frame's packs."""
    from raytracing_cuda_tpu_torch.app.loop import Engine
    from raytracing_cuda_tpu_torch.utils.config import RenderConfig

    eng = Engine(RenderConfig(width=W, height=H, procedural_sky_shape=(32, 64)),
                 device="cpu")
    first = eng.cull
    assert first.device == eng.device
    for _ in range(2):
        eng.step_and_frame()
        coef, _, _, _, table = eng._packs()
        assert table is first
    groups = trt.cull_groups(eng.scene.n_triangles, eng.scene.n_spheres,
                             eng.tri_clusters, eng.sph_clusters,
                             eng.tri_subs)
    assert torch.equal(trt.cull_table(coef, groups), first)


def test_wrappers_ignore_cull_on_cpu():
    """CPU tensors run the brute-force plain version with or without the
    cull table; counting work from the table equals counting it from
    cull_groups."""
    scene, coef, params, nt, ns, groups, table = _cull_packs("mountains_day")
    a = trt.raytrace_planes(coef, params, H, W, nt, ns)
    b = trt.raytrace_planes(coef, params, H, W, nt, ns, cull=table)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = trt.raytrace_planes_batch(coef[None], params[None], 32, W, nt, ns,
                                  row0=40, total_h=H, cull=table)
    assert all(torch.equal(x[0], y[40:72]) for x, y in zip(c, a))
    counts = []
    for cull in (groups, table):
        work = dict.fromkeys(trt.WORK_KEYS, 0)
        trt.raytrace_planes_torch(coef, params, 32, W, nt, ns, row0=40,
                                  total_h=H, work=work, cull=cull)
        counts.append(work)
    assert counts[0] == counts[1]


@pytest.mark.parametrize("h,w,row0,total_h", [(4, 1, 0, None), (1, 4, 0, None),
                                             (1, 1, 0, None), (0, 4, 0, 4),
                                             (2, 4, -1, 4)])
def test_wrappers_reject_frames_without_ray_coordinates(h, w, row0, total_h):
    """A pixel's frustum coordinates are col / (W - 1) and row /
    (total_h - 1): at W = 1 or total_h = 1 the JAX megakernel raises
    ZeroDivisionError while tracing (pallas_rt.py:643-644); the port's
    wrappers and plain versions raise ValueError, before any device is
    asked."""
    scene, coef, params, nt, ns, groups, table = _cull_packs("island_morning")
    for fn, c, p in ((trt.raytrace_planes, coef, params),
                     (trt.raytrace_planes_torch, coef, params),
                     (trt.raytrace_planes_batch, coef[None], params[None]),
                     (trt.raytrace_planes_batch_torch, coef[None],
                      params[None])):
        with pytest.raises(ValueError, match="needs at least"):
            fn(c, p, h, w, nt, ns, row0=row0, total_h=total_h)
    with pytest.raises(ValueError, match="needs at least"):
        trt._launch(coef[None], params[None], h, w, nt, ns, row0,
                    h if total_h is None else total_h, table)


def test_one_row_band_and_two_by_two_frame():
    """The smallest shapes that do have ray coordinates: a one-row band of
    a taller frame equals that row, and a 2 x 2 frame's rays are the
    frustum's corners."""
    scene, coef, params, nt, ns, groups, table = _cull_packs("mountains_day")
    full = torch.stack(trt.raytrace_planes(coef, params, H, W, nt, ns))
    band = torch.stack(trt.raytrace_planes(coef, params, 1, W, nt, ns,
                                           row0=41, total_h=H))
    assert torch.equal(band, full[:, 41:42])
    dx, dy, dz = trt.primary_rays(params, 2, 2)
    corners = torch.stack([params[b:b + 3] for b in (
        trt.P_LU, trt.P_RU, trt.P_LD, trt.P_RD)])
    want = corners / corners.norm(dim=1, keepdim=True)
    assert torch.allclose(torch.stack([dx, dy, dz], 1), want, atol=1e-6)
