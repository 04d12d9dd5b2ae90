"""The port at the degenerate states of tests/test_properties.py.

Seven states where the sea plane's t, which seeds the megakernel's per-ray
cull bound, is extreme or always missing: the camera inside the island, 50
below the sea and 5000 away, the clock at 0 and 24, the sea at +500 and
-500. Built by the port's state machine the way `_extreme_state` builds
them, rendered at 48x96 with the 32x64 procedural sky:

  - the port's `auto` (the megakernel's plain version on the CPU) and
    `fast` frames are (48, 96, 3) uint8;
  - the `auto` frame against the JAX `pallas_interpret` frame with the
    island's cluster partitions, under the golden contract of
    tests/test_golden.py:82-86: RMSE < 2e-3 and < 0.3 % of pixels off by
    more than 2 levels; on the whole frame for five states, and for the two
    sea states outside the 3x3 of the 1 and 5 rays that end elsewhere, and
    on their whole frames once the plain version fuses the two
    multiply-adds that XLA's CPU code fuses (see those tests);
  - `reach`, the cull the CUDA kernel evaluates per ray, is sound on every
    ray those frames cast (tests/test_torch_raytrace.py check_cull_sound):
    no row that wins a cast ray or occludes a shadow ray lies under a group
    it drops, and every distance bound it is given is a number;
  - `auto` against `fast` with the sea at 500: RMSE < 2e-3
    (tests/test_properties.py:80-87).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.render.pipeline import render_frame as jrender_frame
from raytracing_cuda_tpu.scene import builders as jb
from raytracing_cuda_tpu.scene.textures import (
    procedural_skies as jprocedural_skies)
from chip_smoke import (EXTREME, GOLDEN_OFF_FRAC, GOLDEN_RMSE, golden_stats,
                        make_state)
from raytracing_cuda_tpu_torch.render import cuda_rt as trt
from raytracing_cuda_tpu_torch.render.pipeline import host_packs, render_frame
from raytracing_cuda_tpu_torch.scene import builders as tb
from raytracing_cuda_tpu_torch.scene.textures import procedural_skies
from tests.test_properties import EXTREME_STATES, _extreme_state
from tests.test_torch_raytrace import ISLAND_CULL, check_cull_sound
from tests.test_torch_sim import assert_state_match

torch.set_num_threads(2)

H, W = 48, 96
SKY = (32, 64)
NAMES = sorted(EXTREME)


@pytest.fixture(scope="module")
def env():
    return tb.build_scene(), torch.from_numpy(procedural_skies(*SKY))


@pytest.fixture(scope="module")
def jax_frames():
    """Each state's JAX megakernel frame (interpret mode, clustered),
    rendered once."""
    scene, sky = jb.build_scene(), jnp.asarray(jprocedural_skies(*SKY))
    return {name: np.asarray(jrender_frame(
        scene, _extreme_state(EXTREME_STATES[name]), sky, H, W,
        path="pallas_interpret", tri_clusters=jb.ISLAND_TRI_CLUSTERS,
        sph_clusters=jb.ISLAND_SPH_CLUSTERS)) for name in NAMES}


def _frame(env, st, path):
    scene, sky = env
    img = render_frame(scene, st, sky, H, W, chunk=2048, path=path,
                       tri_clusters=ISLAND_CULL[0],
                       sph_clusters=ISLAND_CULL[1],
                       t_subs=ISLAND_CULL[2]).numpy()
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    return img


def test_the_states_are_the_reference_states():
    assert EXTREME == EXTREME_STATES


@pytest.mark.parametrize("name", NAMES)
def test_extreme_state_equals_the_jax_state(name):
    """Fields made of adds and multiplies exactly, those through sin/cos
    within a few ulp (tests/test_torch_sim.py's contract)."""
    assert_state_match(_extreme_state(EXTREME_STATES[name]),
                       make_state(**EXTREME[name]))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("path", ["fast", "auto"])
def test_extreme_states_render(env, name, path):
    _frame(env, make_state(**EXTREME[name]), path)


def _planes(env, name):
    """(JAX megakernel's 7 planes in interpret mode, the port's plain
    version's), each (7, H, W)."""
    from raytracing_cuda_tpu.render.pallas_rt import render_base_planes_pallas
    from raytracing_cuda_tpu.sim import state as jsim

    jst = _extreme_state(EXTREME_STATES[name])
    scene_f, lights, ambient = jsim.derive_frame(jb.build_scene(), jst)
    ref = np.stack([np.asarray(p) for p in render_base_planes_pallas(
        scene_f, lights, ambient, jsim.camera_rays(jst.cam, W / H), H, W,
        interpret=True, tri_clusters=jb.ISLAND_TRI_CLUSTERS,
        sph_clusters=jb.ISLAND_SPH_CLUSTERS)])
    coef, params, nt, ns, _ = host_packs(env[0], make_state(**EXTREME[name]),
                                         H, W, None, *ISLAND_CULL)
    got = torch.stack(trt.raytrace_planes_torch(coef, params, H, W, nt,
                                                ns)).numpy()
    return ref, got


def _ray_tree_flips(env, name):
    """(H, W) bool: pixels whose ray ends elsewhere in the two packages,
    from both packages' 7 planes: the miss weight (a product of mirror
    coefficients) or the hit colour differs by far more than rounding."""
    ref, got = _planes(env, name)
    d = np.abs(ref - got)
    return (d[3] > 1e-3) | (d[:3] > 0.1).any(0)


# rays of the 4,608 that end elsewhere in the two packages; none at the
# five other states
FLIPPED_RAYS = {"sea_above_everything": 1, "sea_far_below": 5}


def _fused(a, b, c):
    """fma(a, b, c) in float32: the product of two float32 is exact in
    float64, so the sum is rounded once."""
    return (a.double() * b.double() + c.double()).float()


@pytest.mark.parametrize("name", NAMES)
def test_extreme_states_match_the_jax_megakernel(env, jax_frames, name):
    """The golden contract, on the whole frame for five states. The two sea
    states hold a few rays whose hit turns on a last bit:
      - sea at +500: the camera sees the sea's mirror from below, 500 away,
        where an ulp of height is 3e-5; a reflected ray starts 0.001 along
        its direction, one ulp of height for a near-level ray, so whether
        it meets the mirror again at t = 0 turns on the hit point's
        rounding (one ray bounces once more in the port);
      - sea at -500: the mountains' base edge, under water in every other
        state, shows against the far sea and runs along a pixel row, so
        the rays on it (5) hit or miss by the edge test's last bit.
    The port rounds the product before the sum in the frustum lerp and the
    hit point, as its CUDA kernel does; XLA's CPU code fuses both (the next
    test swaps fused ones in, and every ray ends where JAX's does). FXAA
    spreads such a pixel over the 3x3 around it. So here: the count of rays
    that end elsewhere is pinned, and the golden contract holds outside
    their 3x3."""
    img = _frame(env, make_state(**EXTREME[name]), "auto")
    rmse, off = golden_stats(img, jax_frames[name])
    flips = _ray_tree_flips(env, name)
    print(f"{name}: port auto vs JAX pallas_interpret rmse {rmse:.6f} "
          f"off>2 {off:.4%}, {int(flips.sum())} rays end elsewhere")
    assert int(flips.sum()) == FLIPPED_RAYS.get(name, 0)
    if flips.any():
        near = torch.nn.functional.max_pool2d(
            torch.from_numpy(flips)[None, None].float(), 3, 1, 1)[0, 0] > 0
        keep = ~near.numpy()
        rmse, off = golden_stats(img[keep], jax_frames[name][keep])
        print(f"{name}: outside their 3x3 rmse {rmse:.6f} off>2 {off:.4%}")
    assert rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC, (rmse, off)


@pytest.mark.parametrize("name", sorted(FLIPPED_RAYS))
def test_fused_multiply_adds_send_every_sea_ray_where_jax_does(
        env, jax_frames, name, monkeypatch):
    """The cause of the rays above: with the plain version's frustum lerp
    and hit point each rounded once (fma), as XLA's CPU code computes them,
    no ray ends elsewhere and the planes agree to 1e-2 (under 3 levels).
    With the sea at +500 the whole frame then meets the golden contract.
    With it at -500 one pixel is left whose planes agree and whose sky
    texel differs (the sky stage, not the megakernel): the frame meets the
    contract outside its 3x3."""
    monkeypatch.setattr(trt, "_mul_add", _fused)
    ref, got = _planes(env, name)
    d = np.abs(ref - got)
    assert not ((d[3] > 1e-3) | (d[:3] > 0.1).any(0)).any()
    assert d.max() < 1e-2, d.max()
    img = _frame(env, make_state(**EXTREME[name]), "auto")
    lvl = np.abs(img.astype(np.int32) - jax_frames[name].astype(np.int32))
    keep = np.ones((H, W), bool)
    if name == "sea_far_below":
        worst = np.unravel_index(lvl.max(-1).argmax(), (H, W))
        assert d[:, worst[0], worst[1]].max() < 1e-6
        keep[max(worst[0] - 1, 0):worst[0] + 2,
             max(worst[1] - 1, 0):worst[1] + 2] = False
    rmse, off = golden_stats(img[keep], jax_frames[name][keep])
    print(f"{name}, fused lerp and hit point: planes max|diff| "
          f"{d.max():.6f}, frame rmse {rmse:.6f} off>2 {off:.4%} on "
          f"{int(keep.sum())} of {H * W} pixels")
    assert rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC, (rmse, off)


@pytest.mark.parametrize("name", NAMES)
def test_cull_is_sound_at_the_extreme_states(env, name, monkeypatch):
    """Every ray of the frame is checked; how many of them end on a row
    depends on the state (a camera under the sea sees none), so the counts
    are held only where the state shows the island."""
    scene = env[0]
    st = make_state(**EXTREME[name])
    coef, params, nt, ns, table = host_packs(scene, st, H, W, None,
                                             *ISLAND_CULL)
    assert torch.isfinite(params).all() and torch.isfinite(coef).all()
    groups = trt.cull_groups(scene.n_triangles, scene.n_spheres,
                             *ISLAND_CULL)
    n_cast, n_hit, n_occ = check_cull_sound(coef, params, nt, ns, groups,
                                            table, H, W, monkeypatch)
    print(f"{name}: {n_cast} cast rays, {n_hit} won by a row, {n_occ} "
          f"shadow rays occluded by a row")
    assert n_cast >= H * W
    if name in ("day_wraparound", "day_zero", "sea_far_below"):
        assert n_hit > H * W // 4


def test_plane_t_is_never_nan_or_negative():
    """The sea plane's t, the cast rays' first t_hi: BIG where the ray is
    level with the plane, points away from it or starts on it with no
    direction, a number >= 0 elsewhere, whatever the sea height."""
    oy = torch.tensor([0.0, 5.0, -50.0, 500.0, -500.0, 1e30, 0.0])
    dy = torch.tensor([0.0, -0.0, 1.0, -1.0, 1e-3, -1.0, float("inf")])
    for sea in (-500.0, -4.5, 0.0, 500.0, 1e30):
        t = trt._plane_t(oy[:, None], dy[None, :], torch.tensor(sea))
        assert not torch.isnan(t).any() and (t >= 0).all(), sea
        assert (t[:, :2] == trt.BIG).all()        # dy = +-0 never hits


def test_nan_rays_win_no_row_so_no_cull_can_lose_one(env):
    """`reach` is false wherever a NaN enters its comparisons, so it drops
    groups for a ray with a NaN in it (all but those that hold a sound
    origin). The brute force loses nothing by that: no row test accepts a
    NaN either. A NaN distance bound would drop groups of a sound ray, and
    the kernel never makes one (the test above; the shadow rays' light
    distances are checked ray by ray in check_cull_sound)."""
    scene = env[0]
    coef, params, nt, ns, _ = host_packs(scene, make_state(), H, W, None,
                                         *ISLAND_CULL)
    n_groups = len(trt.cull_groups(scene.n_triangles, scene.n_spheres,
                                   *ISLAND_CULL))
    bounds = params[trt.P_CLUSTERS:].reshape(-1, 4)[:n_groups]
    nan = float("nan")
    good = torch.tensor([0.0, 2.0, 30.0]).expand(3, 3)
    bad = torch.tensor([[nan, 0.0, -1.0], [0.0, nan, -1.0], [0.0, 0.0, nan]])
    big = torch.full((3,), trt.BIG)
    col = lambda v: v[:, None]                       # noqa: E731
    holds = ((bounds[None, :, :3] - good[:, None]) ** 2).sum(-1) <= (
        bounds[None, :, 3] ** 2)
    assert torch.equal(trt.reach(bounds, *good.unbind(1), *bad.unbind(1),
                                 big), holds)
    assert not trt.reach(bounds, *bad.unbind(1), *good.unbind(1), big).any()
    for o, d in ((good, bad), (bad, good)):
        m = torch.cross(o, d, dim=1)
        t_tri = trt._tri_t(coef[1:1 + nt], *map(col, (
            *o.unbind(1), *d.unbind(1), *m.unbind(1))))
        t_sph = trt._sph_t(coef[1 + nt:1 + nt + ns], *map(col, (
            *o.unbind(1), *d.unbind(1))))
        assert (t_tri == trt.BIG).all() and (t_sph == trt.BIG).all()
    ok = torch.tensor([[0.0, 0.0, -1.0]])
    assert torch.equal(
        trt.reach(bounds, *good[:1].unbind(1), *ok.unbind(1),
                  torch.tensor([nan])), holds[:1])


def test_paths_agree_at_sea_500(env):
    st = make_state(sea=500.0)
    a = _frame(env, st, "fast").astype(np.float32)
    b = _frame(env, st, "auto").astype(np.float32)
    assert np.sqrt(np.mean(((a - b) / 255.0) ** 2)) < 2e-3
