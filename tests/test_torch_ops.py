"""The port's intersection routines and sky blend (ops/intersect.py,
ops/linear_forms.py, scene/textures.py blend_sky / sample_sky) against the
JAX package, on the CPU.

The same seeded rays go through the JAX functions (run eagerly, op by op)
and their PyTorch counterparts over the derived island scene. Tolerances:

  - hit masks must be equal wherever every deciding quantity of the test
    (tca, d2 - r2, d2 + 0.01; denom² - 1e-5, t; det - 0.001, u, v,
    1 - u - v, t), divided by its natural scale, is farther than 1e-5 from
    its threshold; a lane nearer than that may round either way;
  - t within rtol 1e-5 / atol 1e-5 where both hit;
  - winners equal where the two best t differ by more than 1e-5 (relative
    to t); occlusion equal where no t is that near the light's distance;
  - the det-scaled linear forms within rtol 1e-5 of their largest term
    (jnp.cross compiles to fused multiply-adds, the port rounds each
    product, so the coefficient rows differ by a few ulp);
  - blend_sky bit for bit; sample_sky bit for bit wherever asin/atan2 put
    the direction in the same texel (flips to the neighbouring texel under
    MAX_FLIP_FRAC of the directions, as tests/test_torch_sky.py).

Then the hand cases of tests/test_intersect.py on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.ops import intersect as jix
from raytracing_cuda_tpu.ops import linear_forms as jlf
from raytracing_cuda_tpu.scene import builders as jb
from raytracing_cuda_tpu.scene import textures as jtx
from raytracing_cuda_tpu.sim import state as jsim
from raytracing_cuda_tpu_torch import interop
from raytracing_cuda_tpu_torch.ops import intersect as tix
from raytracing_cuda_tpu_torch.ops import linear_forms as tlf
from raytracing_cuda_tpu_torch.scene import builders as tb
from raytracing_cuda_tpu_torch.scene import textures as ttx
from raytracing_cuda_tpu_torch.sim import state as tsim

torch.set_num_threads(2)

N_RAYS = 2048
TOL = 1e-5
MAX_FLIP_FRAC = 1e-3


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _numpy_fields(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


class Env:
    """The derived island scene at a state in both packages, and the same
    seeded rays as jnp and torch arrays: half from the camera looking
    down-range, half from points around the island in every direction, so
    every object type is hit, missed and grazed."""

    def __init__(self, day: float, seed: int):
        jst = jsim.settle(jsim.init_state()._replace(
            day_time=jnp.float32(day)))
        self.jscene, self.jlights, _ = jsim.derive_frame(jb.build_scene(),
                                                         jst)
        self.tscene = interop.scene_from_numpy(_numpy_fields(self.jscene))
        rng = np.random.default_rng(seed)
        half = N_RAYS // 2
        o = np.concatenate([
            np.tile(np.array([[-56, 2.2, 72]], np.float32), (half, 1)),
            rng.uniform((-60, -4, -60), (60, 40, 60), (half, 3))]).astype(
                np.float32)
        d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
        d[:half, 1] = -np.abs(d[:half, 1]) * 0.3
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        self.o, self.d = o, d.astype(np.float32)
        self.max_dist = rng.uniform(1, 600, N_RAYS).astype(np.float32)
        self.jo, self.jd = jnp.asarray(self.o), jnp.asarray(self.d)
        self.to, self.td = torch.from_numpy(self.o), torch.from_numpy(self.d)
        self.sph_blocks = ~np.asarray(self.jscene.is_light)[
            np.asarray(self.jscene.sph_gidx)]


@pytest.fixture(scope="module", params=[(6.0, 0), (14.0, 1), (1.0, 2)],
                ids=["morning", "day", "night"])
def env(request):
    return Env(*request.param)


def near(*margins):
    """Lanes where some deciding quantity, already divided by its scale,
    lies within TOL of its threshold 0."""
    out = np.zeros(np.shape(margins[0]), bool)
    for m in margins:
        out |= ~(np.abs(m) > TOL)          # NaN margins count as near
    return out


def sphere_margins(e):
    """Deciding quantities of the sphere test per (ray, sphere), float64."""
    pos = np.asarray(e.jscene.sph_pos, np.float64)
    r2 = np.asarray(e.jscene.sph_r, np.float64) ** 2
    L = pos[None] - e.o.astype(np.float64)[:, None]
    tca = np.sum(L * e.d.astype(np.float64)[:, None], -1)
    ll = np.sum(L * L, -1)
    d2 = ll - tca * tca
    return near(tca / np.sqrt(ll), (d2 - r2) / ll, (d2 + 0.01) / ll)


def plane_margins(e):
    pn = np.asarray(e.jscene.plane_normal, np.float64)
    denom = e.d.astype(np.float64) @ pn
    with np.errstate(divide="ignore", invalid="ignore"):
        t = ((np.asarray(e.jscene.plane_pos, np.float64)
              - e.o.astype(np.float64)) @ pn) / denom
    return near((denom * denom - 0.00001) / 0.00001, t / (1 + np.abs(t)))


def triangle_margins(e):
    v0, e1, e2 = (np.asarray(v, np.float64)[None] for v in (
        e.jscene.tri_v0, e.jscene.tri_e1, e.jscene.tri_e2))
    o, d = e.o.astype(np.float64)[:, None], e.d.astype(np.float64)[:, None]
    pvec = np.cross(d, e2)
    det = np.sum(e1 * pvec, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        tvec = o - v0
        u = np.sum(tvec * pvec, -1) / det
        qvec = np.cross(tvec, e1)
        v = np.sum(d * qvec, -1) / det
        t = np.sum(e2 * qvec, -1) / det
    scale = np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1)
    return near((det - 0.001) / scale, u, 1 - u, v, 1 - u - v,
                t / (1 + np.abs(t)))


def masks_agree(jmask, tmask, unsure):
    jmask, tmask = _np(jmask), _np(tmask)
    assert jmask.shape == tmask.shape and tmask.dtype == bool
    bad = (jmask != tmask) & ~unsure
    assert not bad.any(), f"{int(bad.sum())} hit-mask mismatches"
    assert unsure.mean() < 0.02, unsure.mean()    # the margin excuses little


def t_agree(jt, tt, both, tol=TOL):
    jt, tt = _np(jt), _np(tt)
    assert tt.dtype == np.float32
    np.testing.assert_allclose(tt[both], jt[both], rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def unsure(env):
    """Per-ray: some object's accept test is within the margin."""
    return (sphere_margins(env).any(-1) | triangle_margins(env).any(-1)
            | plane_margins(env))


def test_intersect_spheres(env):
    jh, jt = jix.intersect_spheres(env.jo, env.jd, env.jscene.sph_pos,
                                   env.jscene.sph_r)
    th, tt = tix.intersect_spheres(env.to, env.td, env.tscene.sph_pos,
                                   env.tscene.sph_r)
    masks_agree(jh, th, sphere_margins(env))
    both = _np(jh) & _np(th)
    assert both.sum() > 20
    t_agree(jt, tt, both)


def test_intersect_plane(env):
    jh, jt = jix.intersect_plane(env.jo, env.jd, env.jscene.plane_pos,
                                 env.jscene.plane_normal)
    th, tt = tix.intersect_plane(env.to, env.td, env.tscene.plane_pos,
                                 env.tscene.plane_normal)
    masks_agree(jh, th, plane_margins(env))
    both = _np(jh) & _np(th)
    assert both.sum() > 500
    t_agree(jt, tt, both)


def test_intersect_triangles(env):
    jh, jt = jix.intersect_triangles(env.jo, env.jd, env.jscene.tri_v0,
                                     env.jscene.tri_e1, env.jscene.tri_e2)
    th, tt = tix.intersect_triangles(env.to, env.td, env.tscene.tri_v0,
                                     env.tscene.tri_e1, env.tscene.tri_e2)
    masks_agree(jh, th, triangle_margins(env))
    both = _np(jh) & _np(th)
    assert both.sum() > 200
    t_agree(jt, tt, both)


def _two_best_apart(env, tol):
    """Rays whose two nearest hits differ by more than tol (relative)."""
    t = np.sort(tix.all_hits(env.tscene, env.to, env.td)[0].numpy(), -1)
    with np.errstate(invalid="ignore"):
        return ~(t[:, 1] - t[:, 0] <= tol * (1 + np.abs(t[:, 0])))


def nearest_agree(env, unsure, jres, tres, tol=TOL):
    jhit, jt, jg = (_np(v) for v in jres)
    thit, tt, tg = (_np(v) for v in tres)
    assert tg.dtype == np.int32 and thit.dtype == bool
    sure = ~unsure
    assert np.array_equal(jhit[sure], thit[sure])
    both = jhit & thit
    assert both.sum() > 1000 and (~thit).sum() > 50
    t_agree(jt, tt, both, tol)
    clear = sure & _two_best_apart(env, tol)
    assert clear.mean() > 0.9
    assert np.array_equal(jg[clear], tg[clear])
    assert np.all(tg[~thit] == -1) and np.all(np.isinf(tt[~thit]))


def test_nearest_hit(env, unsure):
    nearest_agree(env, unsure, jix.nearest_hit(env.jscene, env.jo, env.jd),
                  tix.nearest_hit(env.tscene, env.to, env.td))


def occlusion_agree(env, unsure, jocc, tocc):
    t = tix.all_hits(env.tscene, env.to, env.td)[0].numpy()
    md = env.max_dist[:, None]
    at_light = (np.abs(t - md) <= TOL * (1 + md)).any(-1)
    sure = ~(unsure | at_light)
    jocc, tocc = _np(jocc), _np(tocc)
    assert tocc.dtype == bool and 0.1 < tocc.mean() < 0.95
    assert np.array_equal(jocc[sure], tocc[sure])


def test_occluded(env, unsure):
    occlusion_agree(
        env, unsure,
        jix.occluded(env.jscene, env.jo, env.jd, jnp.asarray(env.max_dist)),
        tix.occluded(env.tscene, env.to, env.td,
                     torch.from_numpy(env.max_dist)))


@pytest.fixture(scope="module")
def packs(env):
    return (jlf.tri_pack(env.jscene), jlf.sphere_pack(env.jscene),
            jlf.ray_features(env.jo, env.jd), tlf.tri_pack(env.tscene),
            tlf.sphere_pack(env.tscene), tlf.ray_features(env.to, env.td))


def forms_agree(jvals, tvals):
    for jv, tv in zip(jvals, tvals):
        jv, tv = _np(jv), _np(tv)
        assert tv.dtype == np.float32 and tv.shape == jv.shape
        np.testing.assert_allclose(tv, jv, rtol=0,
                                   atol=1e-5 * np.abs(jv).max())


def test_tri_dets(packs):
    jtp, _, jF, ttp, _, tF = packs
    forms_agree(jtp, ttp)
    forms_agree(jlf.tri_dets(jtp, jF), tlf.tri_dets(ttp, tF))


def test_sphere_terms(packs):
    _, jsp, jF, _, tsp, tF = packs
    for jv, tv in zip(jsp, tsp):
        assert np.array_equal(_np(jv), _np(tv))
    forms_agree(jlf.sphere_terms(jsp, jF), tlf.sphere_terms(tsp, tF))


def test_nearest_hit_fast(env, unsure, packs):
    jtp, jsp, jF, ttp, tsp, tF = packs
    nearest_agree(env, unsure,
                  jlf.nearest_hit_fast(env.jscene, jtp, jsp, jF),
                  tlf.nearest_hit_fast(env.tscene, ttp, tsp, tF))


def test_occluded_fast(env, unsure, packs):
    jtp, jsp, jF, ttp, tsp, tF = packs
    occlusion_agree(
        env, unsure,
        jlf.occluded_fast(env.jscene, jtp, jsp, jnp.asarray(env.sph_blocks),
                          jF, jnp.asarray(env.max_dist)),
        tlf.occluded_fast(env.tscene, ttp, tsp,
                          torch.from_numpy(env.sph_blocks), tF,
                          torch.from_numpy(env.max_dist)))


def test_fast_and_plain_queries_agree(env, unsure, packs):
    """The port's own two formulations on the same rays, ten times
    looser: the linear forms cancel large terms (t·det = o·n - v0·n)."""
    _, _, _, ttp, tsp, tF = packs
    nearest_agree(env, unsure, tix.nearest_hit(env.tscene, env.to, env.td),
                  tlf.nearest_hit_fast(env.tscene, ttp, tsp, tF),
                  tol=10 * TOL)


# --- sky blend and lookup ---


@pytest.fixture(scope="module")
def texels():
    return np.random.default_rng(7).integers(
        0, 256, (4, 32, 64, 3)).astype(np.uint8)


@pytest.mark.parametrize("day", [1.0, 6.0, 9.0, 14.0, 17.25, 21.0, 4.5])
def test_blend_sky_matches(texels, day):
    jsv = jsim.calc_sky_vars(jnp.float32(day))
    tsv = tsim.calc_sky_vars(torch.tensor(day))
    assert np.array_equal(np.asarray(jsv), tsv.numpy())
    got = ttx.blend_sky(torch.from_numpy(texels), tsv)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(),
                          np.asarray(jtx.blend_sky(jnp.asarray(texels), jsv)))


def test_blend_sky_seeded_weights(texels):
    """Weights no state produces (four nonzero, summing to 1)."""
    sv = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    assert np.array_equal(
        ttx.blend_sky(torch.from_numpy(texels), torch.from_numpy(sv)).numpy(),
        np.asarray(jtx.blend_sky(jnp.asarray(texels), jnp.asarray(sv))))


@pytest.mark.parametrize("seed,day", [(0, 6.0), (1, 9.0), (2, 17.25)])
def test_sample_sky_matches(texels, seed, day):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((20000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.concatenate([np.eye(3, dtype=np.float32),
                        -np.eye(3, dtype=np.float32), d]).astype(np.float32)
    day_frac = np.float32(day) / np.float32(24.0)
    jsv = jsim.calc_sky_vars(jnp.float32(day))
    jblend = jtx.blend_sky(jnp.asarray(texels), jsv)
    tblend = torch.from_numpy(np.array(jblend))
    h, w = texels.shape[1:3]
    jiy, jix_ = (np.asarray(v) for v in jtx._equirect_indices(
        h, w, jnp.asarray(d), jnp.float32(day_frac)))
    tiy, tix_ = (v.numpy() for v in ttx._equirect_indices(
        h, w, torch.from_numpy(d), float(day_frac)))
    flips = (jiy != tiy) | (jix_ != tix_)
    assert flips.mean() < MAX_FLIP_FRAC
    ref = np.asarray(jtx.sample_sky(jblend, jnp.asarray(d),
                                    jnp.float32(day_frac)))
    got = ttx.sample_sky(tblend, torch.from_numpy(d), day_frac).numpy()
    assert got.dtype == np.float32 and got.shape == (len(d), 3)
    assert np.array_equal(got[~flips], ref[~flips])
    packed = ttx.sample_sky_packed(ttx.pack_sky(tblend), h, w,
                                   torch.from_numpy(d), day_frac).numpy()
    assert np.array_equal(packed, got)
    jpacked = np.asarray(jtx.sample_sky_packed(
        jtx.pack_sky(jblend), h, w, jnp.asarray(d), jnp.float32(day_frac)))
    assert np.array_equal(packed[~flips], jpacked[~flips])


# --- the hand cases of tests/test_intersect.py on the port ---


def v(*xs):
    return torch.tensor(xs, dtype=torch.float32)


def sphere_hit(o, d):
    h, t = tix.intersect_spheres(v(*o)[None], v(*d)[None],
                                 v([0.0, 0.0, 0.0]), v(1.0))
    return bool(h[0, 0]), float(t[0, 0])


@pytest.mark.parametrize("o,d,hit,t", [
    ((0, 0, -5), (0, 0, 1), True, 4.0),          # head on
    ((0, 0, -5), (0, 0, -1), False, None),       # tca <= 0 (kernel.cu:55)
    ((0, 2, -5), (0, 0, 1), False, None),        # offset miss
    ((0, 0.999, -5), (0, 0, 1), True, None),     # d2 strictly < r²
    ((0, 0, 0.5), (0, 0, 1), False, None),       # inside, center behind
], ids=["head_on", "behind", "miss_offset", "grazing", "inside_behind"])
def test_sphere_cases(o, d, hit, t):
    h, got = sphere_hit(o, d)
    assert h == hit
    if t is not None:
        assert np.isclose(got, t)


def test_sphere_inside_keeps_negative_root():
    """Origin inside, center ahead: a hit with the reference's negative
    near root t = tca - thc."""
    h, t = sphere_hit((0, 0, -0.5), (0, 0, 1))
    assert h and t < 0


def test_sphere_window_is_float32():
    """d2 is compared with float32(-0.01), not the double literal."""
    below = np.nextafter(np.float32(-0.01), np.float32(-1))
    d2 = torch.tensor([np.float32(-0.01), below])
    assert (d2 > -0.01).tolist() == [False, False]
    assert (torch.tensor([np.nextafter(np.float32(-0.01), np.float32(0))])
            > -0.01).item()


def plane_hit(o, d):
    h, t = tix.intersect_plane(v(*o), v(*d), v(0, -4.5, 0), v(0, 1, 0))
    return bool(h), float(t)


@pytest.mark.parametrize("o,d,hit,t", [
    ((0, 0, 0), (0, -1, 0), True, 4.5),          # from above
    ((0, -10, 0), (0, 1, 0), True, 5.5),         # normal never flipped
    ((0, 0, 0), (1, 0, 0), False, None),         # denom² must exceed 1e-5
    ((0, 0, 0), (0, 1, 0), False, None),         # pointing away
], ids=["above", "below", "parallel", "away"])
def test_plane_cases(o, d, hit, t):
    h, got = plane_hit(o, d)
    assert h == hit
    if t is not None:
        assert np.isclose(got, t)


def tri_hit(o, d):
    h, t = tix.intersect_triangles(
        v(*o)[None], v(*d)[None], v([0.0, 0.0, 0.0]), v([1.0, 0.0, 0.0]),
        v([0.0, 1.0, 0.0]))
    return bool(h[0, 0]), float(t[0, 0])


@pytest.mark.parametrize("o,d,hit", [
    ((0.25, 0.25, 3), (0, 0, -1), True),         # front face, det >= 0.001
    ((0.25, 0.25, -3), (0, 0, 1), False),        # backface cull
    ((0.9, 0.9, 3), (0, 0, -1), False),          # u + v > 1
    ((-0.1, 0.5, 3), (0, 0, -1), False),         # u < 0
    ((0.0, 0.5, 3), (0, 0, -1), True),           # edges inclusive
    ((0.25, 0.25, -3), (0, 0, -1), False),       # behind the origin
], ids=["front", "backface", "uv_over_1", "u_negative", "edge", "behind"])
def test_triangle_cases(o, d, hit):
    h, t = tri_hit(o, d)
    assert h == hit
    if o == (0.25, 0.25, 3):
        assert np.isclose(t, 3.0)


@pytest.fixture(scope="module")
def island():
    return tb.build_scene()


def test_nearest_picks_closest(island):
    """Straight down over open island ground: the island top face y = -4
    wins over the sea plane y = -4.5."""
    hit, t, gidx = tix.nearest_hit(island, v(-20, 100, 0)[None],
                                   v(0, -1, 0)[None])
    assert bool(hit[0]) and np.isclose(float(t[0]), 104.0, atol=1e-3)
    assert 1 <= int(gidx[0]) <= 10


def test_nearest_tiebreak_lowest_index(island):
    """Every sphere at one place: the lowest sphere index wins."""
    s = island._replace(
        sph_pos=torch.tensor([[0.0, 0.0, 10.0]]).repeat(island.n_spheres, 1),
        sph_r=torch.ones(island.n_spheres))
    for query in (
            lambda o, d: tix.nearest_hit(s, o, d),
            lambda o, d: tlf.nearest_hit_fast(
                s, tlf.tri_pack(s), tlf.sphere_pack(s),
                tlf.ray_features(o, d))):
        hit, _, gidx = query(v(0, 0, 0)[None], v(0, 0, 1)[None])
        assert bool(hit[0]) and int(gidx[0]) == int(s.sph_gidx.min())


def test_sky_miss_has_no_winner(island):
    hit, t, gidx = tix.nearest_hit(island, v(0, 100, 0)[None],
                                   v(0, 1, 0)[None])
    assert not bool(hit[0]) and int(gidx[0]) == -1 and np.isinf(float(t[0]))


@pytest.mark.parametrize("o,dist,want", [
    ((-20, -5.9, 0), 1000.0, True),      # under the island top
    ((-20, -5.9, 0), 0.5, False),        # the light is nearer than the top
    ((0, -5.9, 0), 0.5, True),           # inside the igloo dome: negative t
], ids=["basic", "distance", "inside_sphere"])
def test_occlusion_cases(island, o, dist, want):
    args = (v(*o)[None], v(0, 1, 0)[None], v(dist)[None])
    assert bool(tix.occluded(island, *args)[0]) == want
    fast = tlf.occluded_fast(
        island, tlf.tri_pack(island), tlf.sphere_pack(island),
        ~island.is_light[island.sph_gidx.long()],
        tlf.ray_features(args[0], args[1]), args[2])
    assert bool(fast[0]) == want


def test_light_spheres_never_occlude(island):
    o = (island.sph_pos[-2] + v(0, 0, -200))[None]
    assert not bool(tix.occluded(island, o, v(0, 0, 1)[None],
                                 v(150.0)[None])[0])
