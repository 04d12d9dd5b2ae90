"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped where torch.cuda.is_available() is false (the
decision is made inside the fixture, never at import). Imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:
    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: both kernels perform the plain versions' float32 operations in
the same order with the same rounding (the kernels are built with
-fmad=false; the plain versions divide truly on the device), so kernel and
plain version must agree bit for bit on the card. Against the CPU plain
versions (other exp2/log2 implementations), frames must meet the golden
contract: RMSE < 2e-3 and < 0.3 % of pixels off by more than 2 levels.
Kernel A culls per ray from the scene's cull table, which the brute-force
plain version does not read: the culls must leave every plane bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (CASES, EXTREME, GOLDEN_OFF_FRAC, GOLDEN_RMSE, POSES,
                        golden_stats, halo_bands, make_state, states_equal,
                        varied_actions)
from raytracing_cuda_tpu_torch import __main__ as cli
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.parallel.mesh import (render_frame_sharded,
                                                     replicate)
from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa
from raytracing_cuda_tpu_torch.render.pipeline import host_packs
from raytracing_cuda_tpu_torch.scene import builders as tb
from raytracing_cuda_tpu_torch.sim import state as tsim
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.images import load_png

pytestmark = pytest.mark.cuda

H, W = 96, 160
SKY = (64, 128)


def small_engine(device="cpu", sharded=False, **kw) -> Engine:
    return Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY,
                               **kw), device=device, sharded=sharded)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


ISLAND = (tb.ISLAND_TRI_CLUSTERS, tb.ISLAND_SPH_CLUSTERS, tb.ISLAND_TRI_SUBS)


def _scene_state(name):
    """(scene, state, cluster partitions) of a pose or the classic scene."""
    if name == "classic":
        eng = small_engine(scene="classic")
        return eng.scene, eng.state, (None, None, None)
    return tb.build_scene(), make_state(**POSES[name]), ISLAND


def _packs(name, dev, h=H, w=W):
    """(coef, params, n_tri_rows, n_sph_rows, cull table) on dev, for a
    frame of h x w."""
    scene, st, clusters = _scene_state(name)
    coef, params, nt, ns, cull = host_packs(scene, st, h, w, None,
                                            *clusters)
    return coef.to(dev), params.to(dev), nt, ns, cull.to(dev)


@pytest.mark.parametrize("name", sorted(CASES) + ["worst_pose", "classic"]
                         + sorted(EXTREME))
def test_raytrace_kernel_matches_plain(dev, name):
    """The four golden states, the worst pose, the classic scene, and the
    seven degenerate states where the sea plane's t that seeds the per-ray
    cull bound is extreme or always missing."""
    coef, params, nt, ns, cull = _packs(name, dev)
    before = cuda_rt.raytrace_planes.launches
    kern = torch.stack(cuda_rt.raytrace_planes(coef, params, H, W, nt, ns,
                                               cull=cull))
    torch.cuda.synchronize()
    assert cuda_rt.raytrace_planes.launches == before + 1
    plain = torch.stack(cuda_rt.raytrace_planes_torch(coef, params, H, W, nt,
                                                      ns))
    assert torch.equal(kern, plain)


def test_raytrace_kernel_row_band(dev):
    coef, params, nt, ns, cull = _packs("mountains_day", dev)
    full = torch.stack(cuda_rt.raytrace_planes(coef, params, H, W, nt, ns,
                                               cull=cull))
    band = torch.stack(cuda_rt.raytrace_planes(coef, params, 32, W, nt, ns,
                                               row0=40, total_h=H, cull=cull))
    assert torch.equal(band, full[:, 40:72])


# frames and a band whose last 8 x 4 warp tiles hang over the right and
# bottom edges: (rows, width, row0, rows of the whole frame)
PARTIAL_TILES = [(37, 53, 0, 37), (2, 2, 0, 2), (5, 9, 0, 5),
                 (30, 160, 7, 96)]


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("h,w,row0,total_h", PARTIAL_TILES)
def test_raytrace_kernel_partial_tiles(dev, h, w, row0, total_h, K):
    """Kernel A masks the lanes of a warp tile that fall outside the frame:
    every plane of every frame equals the plain version's bit for bit, one
    frame per launch (K = 1 through raytrace_planes) and K frames per
    launch."""
    names = ["island_morning", "mountains_day", "sea_above_everything"][:K]
    packs = [_packs(name, dev, total_h, w) for name in names]
    nt, ns, cull = packs[0][2:]
    coefs = torch.stack([p[0] for p in packs])
    params = torch.stack([p[1] for p in packs])
    if K == 1:
        kern = [p[None] for p in cuda_rt.raytrace_planes(
            coefs[0], params[0], h, w, nt, ns, row0=row0, total_h=total_h,
            cull=cull)]
    else:
        kern = cuda_rt.raytrace_planes_batch(coefs, params, h, w, nt, ns,
                                             row0=row0, total_h=total_h,
                                             cull=cull)
    torch.cuda.synchronize()
    plain = cuda_rt.raytrace_planes_batch_torch(coefs, params, h, w, nt, ns,
                                                row0=row0, total_h=total_h)
    assert all(k.shape == (K, h, w) for k in kern)
    assert all(torch.equal(a, b) for a, b in zip(kern, plain))


def test_raytrace_wrappers_reject_one_pixel_frames_on_the_card(dev):
    coef, params, nt, ns, cull = _packs("island_morning", dev)
    for h, w in ((4, 1), (1, 4)):
        with pytest.raises(ValueError, match="needs at least"):
            cuda_rt.raytrace_planes(coef, params, h, w, nt, ns, cull=cull)


@pytest.mark.parametrize("name", ["island_morning", "mountains_day",
                                  "worst_pose", "classic"])
def test_raytrace_counting_launch_between_plain_and_brute_force(dev, name):
    """The counting launch renders the same planes. Its lanes need no more
    cast-ray row tests than the plain version's per-ray count (their t-bound
    only shrinks below the plane's hit), and exactly its unoccluded shadow
    rays' tests plus at most every blocking row per occluded shadow ray;
    each row test a warp executes serves 1 to 32 lanes."""
    coef, params, nt, ns, cull = _packs(name, dev)
    scene = _scene_state(name)[0]
    before = (cuda_rt.raytrace_planes.launches,
              cuda_rt.raytrace_planes_batch.launches)
    planes, c = cuda_rt.raytrace_planes_count(coef[None], params[None], H, W,
                                              nt, ns, cull=cull)
    assert (cuda_rt.raytrace_planes.launches,
            cuda_rt.raytrace_planes_batch.launches) == before
    work = dict.fromkeys(cuda_rt.WORK_KEYS, 0)
    plain = cuda_rt.raytrace_planes_torch(coef, params, H, W, nt, ns,
                                          work=work, cull=cull)
    assert all(torch.equal(a[0], b) for a, b in zip(planes, plain))
    rows = scene.n_triangles + scene.n_spheres
    blocking = scene.n_triangles + int((~scene.is_light[
        scene.sph_gidx.long()]).sum())
    cast = work["tri_tests"] + work["sph_tests"]
    shadow = work["shadow_tri_tests"] + work["shadow_sph_tests"]
    assert 0 < c["cast_lane_rows"] <= cast <= work["rays"] * rows
    assert (shadow <= c["shadow_lane_rows"]
            <= shadow + work["occluded"] * blocking
            <= work["shadow"] * blocking)
    for kind in ("cast", "shadow"):
        lanes, warps = c[f"{kind}_lane_rows"], c[f"{kind}_warp_rows"]
        assert lanes <= 32 * warps and warps <= lanes, (kind, c)


@pytest.mark.parametrize("shape", [(96, 160), (720, 1280), (37, 53)])
def test_fxaa_kernel_matches_plain(dev, shape):
    img = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, shape + (3,)).astype(np.uint8)).to(dev)
    before = fxaa.fxaa.launches
    out = fxaa.fxaa(img)
    torch.cuda.synchronize()
    assert fxaa.fxaa.launches == before + 1
    assert torch.equal(out, fxaa.fxaa_torch(img))


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_cuda_matches_cpu(dev, name):
    frames = []
    for device in ("cpu", "cuda"):
        eng = small_engine(device)
        eng.set_state(make_state(**CASES[name]))
        frames.append(eng.frame_np())
    rmse, off = golden_stats(frames[1], frames[0])
    assert rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC, (rmse, off)


def test_wrappers_reject_bad_inputs(dev):
    coef, params, nt, ns, cull = _packs("island_morning", dev)
    with pytest.raises(ValueError):
        cuda_rt.raytrace_planes(coef.double(), params, H, W, nt, ns,
                                cull=cull)
    with pytest.raises(ValueError, match="cull table"):
        cuda_rt.raytrace_planes(coef, params, H, W, nt, ns)
    for bad in (cull.long(), cull.cpu(), cull[:, :2].contiguous()):
        with pytest.raises(ValueError, match="cull"):
            cuda_rt.raytrace_planes(coef, params, H, W, nt, ns, cull=bad)
    with pytest.raises(ValueError):
        fxaa.fxaa(torch.zeros((4, 4, 3), dtype=torch.float32, device=dev))


def _batch_packs(dev, n=3):
    scene = tb.build_scene()
    st = make_state(6.0)
    states = [make_state(**CASES[c]) for c in sorted(CASES)][:n - 1] + [
        tsim.animate(st, varied_actions(2)[0], 0.5)]
    packs = [host_packs(scene, s, H, W, None, *ISLAND) for s in states]
    return (torch.stack([p[0] for p in packs]).to(dev),
            torch.stack([p[1] for p in packs]).to(dev), packs[0][2],
            packs[0][3], packs[0][4].to(dev))


def test_raytrace_batch_kernel_matches_plain_and_singles(dev):
    coefs, params, nt, ns, cull = _batch_packs(dev)
    before = (cuda_rt.raytrace_planes_batch.launches,
              cuda_rt.raytrace_planes_batch.frames)
    kern = cuda_rt.raytrace_planes_batch(coefs, params, H, W, nt, ns,
                                         cull=cull)
    torch.cuda.synchronize()
    assert (cuda_rt.raytrace_planes_batch.launches,
            cuda_rt.raytrace_planes_batch.frames) == (before[0] + 1,
                                                      before[1] + 3)
    plain = cuda_rt.raytrace_planes_batch_torch(coefs, params, H, W, nt, ns)
    assert all(torch.equal(a, b) for a, b in zip(kern, plain))
    for k in range(3):
        single = cuda_rt.raytrace_planes(coefs[k], params[k], H, W, nt, ns,
                                         cull=cull)
        assert all(torch.equal(p[k], q) for p, q in zip(kern, single)), k
    band = cuda_rt.raytrace_planes_batch(coefs, params, 32, W, nt, ns,
                                         row0=40, total_h=H, cull=cull)
    assert all(torch.equal(b, p[:, 40:72]) for b, p in zip(band, kern))


def test_batch_wrappers_reject_bad_frame_counts(dev):
    coefs, params, nt, ns, cull = _batch_packs(dev)
    with pytest.raises(ValueError):
        cuda_rt.raytrace_planes_batch(coefs[:0], params[:0], H, W, nt, ns,
                                      cull=cull)
    with pytest.raises(ValueError):
        cuda_rt.raytrace_planes_batch(coefs, params[:2], H, W, nt, ns,
                                      cull=cull)
    with pytest.raises(ValueError):
        fxaa.fxaa_batch(torch.zeros((0, 4, 4, 3), dtype=torch.uint8,
                                    device=dev))


@pytest.mark.parametrize("shape", [(1, 96, 160), (5, 96, 160), (3, 37, 53),
                                   (8, 720, 1280)])
def test_fxaa_batch_kernel_matches_plain(dev, shape):
    imgs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, shape + (3,)).astype(np.uint8)).to(dev)
    before = (fxaa.fxaa_batch.launches, fxaa.fxaa_batch.frames)
    out = fxaa.fxaa_batch(imgs)
    torch.cuda.synchronize()
    assert (fxaa.fxaa_batch.launches, fxaa.fxaa_batch.frames) == (
        before[0] + 1, before[1] + shape[0])
    assert torch.equal(out, fxaa.fxaa_batch_torch(imgs))
    for k in range(shape[0]):
        assert torch.equal(out[k], fxaa.fxaa(imgs[k])), k


def test_step_and_frame_batch_matches_sequential(dev):
    acts = varied_actions(8)
    dts = [0.02 * (i + 1) for i in range(8)]
    a, b = small_engine("cuda"), small_engine("cuda")
    st0 = make_state(9.5)
    a.set_state(st0)
    b.set_state(st0)
    seq = [a.step_and_frame(x, dt) for x, dt in zip(acts, dts)]
    imgs = b.step_and_frame_batch(acts, dts)
    assert all(torch.equal(imgs[k], seq[k]) for k in range(8))
    assert states_equal(a.state, b.state)
    stats = b.run(10, batch=4)
    assert stats.frames == 10 and len(stats.frame_ms) == 4


def test_record_720p_matches_engine(dev, tmp_path):
    """10 frames: one batch of cli.RECORD_BATCH = 8, then 2 single steps."""
    out = str(tmp_path / "rec")
    assert cli.main(["record", out, "--frames", "10", "--size", "1280x720",
                     "--sky-shape", "512x256", "--path", "cuda"]) == 0
    eng = Engine(RenderConfig(width=1280, height=720, sky_source="auto",
                              procedural_sky_shape=(256, 512)), "cuda")
    for i in range(10):
        img = eng.step_and_frame(cli.scripted_action(i), cli.RECORD_DT)
        assert np.array_equal(load_png(os.path.join(out, f"{i:04d}.png")),
                              img.cpu().numpy()), i


def _noise(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape + (3,)).astype(np.uint8))


@pytest.mark.parametrize("shape,n", [((96, 160), 4), ((96, 160), 8),
                                     ((720, 1280), 4), ((720, 1280), 8)])
def test_fxaa_band_kernel_matches_plain(dev, shape, n):
    """Bands with row0 != 0 and halo rows: each equals its plain version,
    and the bands assembled equal the full-frame kernel."""
    img = _noise(shape, 2).to(dev)
    before = (fxaa.fxaa_ext.launches, fxaa.fxaa_ext.frames)
    parts = []
    for row0, ext in halo_bands(img, n):
        out = fxaa.fxaa_ext(ext, row0, shape[0])
        assert torch.equal(out, fxaa.fxaa_ext_torch(ext, row0, shape[0]))
        parts.append(out)
    torch.cuda.synchronize()
    assert (fxaa.fxaa_ext.launches, fxaa.fxaa_ext.frames) == (
        before[0] + n, before[1] + n)
    assert torch.equal(torch.cat(parts), fxaa.fxaa(img))
    # K frames' bands in one launch
    row0, _ = list(halo_bands(img, n))[1]
    stack = torch.stack([list(halo_bands(_noise(shape, s).to(dev), n))[1][1]
                         for s in range(3)])
    assert torch.equal(fxaa.fxaa_ext(stack, row0, shape[0]),
                       fxaa.fxaa_ext_torch(stack, row0, shape[0]))


@pytest.mark.parametrize("shape,n", [((36, 53), 4), ((40, 37), 2),
                                     ((96, 150), 3), ((18, 131), 3)])
def test_fxaa_odd_width_band_and_batch_forms_exact(dev, shape, n):
    """Widths whose rows are not 16-byte aligned take the byte path of the
    tile loads and stores: every band (one launch each and K frames' bands
    in one launch) and the K-frame form equal their plain versions."""
    frames = torch.stack([_noise(shape, s) for s in range(3)]).to(dev)
    assert torch.equal(fxaa.fxaa_batch(frames),
                       fxaa.fxaa_batch_torch(frames))
    for c, (row0, ext) in enumerate(halo_bands(frames[0], n)):
        assert torch.equal(fxaa.fxaa_ext(ext, row0, shape[0]),
                           fxaa.fxaa_ext_torch(ext, row0, shape[0])), c
        stack = torch.stack([list(halo_bands(f, n))[c][1] for f in frames])
        assert torch.equal(fxaa.fxaa_ext(stack, row0, shape[0]),
                           fxaa.fxaa_ext_torch(stack, row0, shape[0])), c


@pytest.mark.parametrize("name", ["island_morning", "evening_flood_noaa"])
def test_sharded_frame_matches_engine(dev, name):
    eng = small_engine("cuda")
    st = make_state(**CASES[name])
    eng.set_state(st)
    ref = eng.frame()
    for n, il in ((4, 1), (4, 2), (8, 1)):
        img = render_frame_sharded(
            eng.scene, st, replicate(eng.sky_pack, ["cuda:0"]), eng.sky_h,
            eng.sky_w, mesh=["cuda:0"] * n, height=H, width=W, interleave=il,
            tri_clusters=eng.tri_clusters, sph_clusters=eng.sph_clusters,
            t_subs=eng.tri_subs)
        assert torch.equal(img, ref), (n, il)
    sharded = small_engine("cuda", sharded=["cuda:0"] * 4)
    sharded.set_state(st)
    assert torch.equal(sharded.frame(), ref)


def test_render_script_dp_and_hybrid_match_sequence(dev):
    acts = varied_actions(8)
    eng = small_engine("cuda", shard_interleave=2)
    st0 = make_state(9.5)
    eng.set_state(st0)
    seq = torch.stack([eng.step_and_frame(a, 0.05) for a in acts])
    end = eng.state
    for kw in (dict(mesh=["cuda:0"] * 2),
               dict(n_rows=2, mesh=[["cuda:0"] * 2] * 2)):
        eng.set_state(st0)
        imgs = eng.render_script_dp(acts, dt=0.05, **kw)
        assert torch.equal(imgs, seq), kw
        assert states_equal(eng.state, end)


# --- the `fast` and `oracle` paths, the preview and the readback ---


@pytest.mark.parametrize("path", ["fast", "oracle"])
@pytest.mark.parametrize("name", ["island_morning", "evening_flood_noaa"])
def test_plain_paths_on_the_card_match_cpu(dev, name, path):
    """Plain PyTorch ops on the card against the same ops on the CPU: the
    golden contract (other asin/atan2/pow implementations)."""
    st = make_state(**CASES[name])
    frames = []
    for device in ("cuda", "cpu"):
        eng = small_engine(device, path=path, chunk=4096)
        eng.set_state(st)
        frames.append(eng.frame_np())
    rmse, off = golden_stats(*frames)
    assert rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC, (rmse, off)


def test_fast_chunks_and_bands_exact_on_the_card(dev):
    eng = small_engine("cuda", path="fast", chunk=4096)
    st = make_state(**CASES["mountains_day"])
    eng.set_state(st)
    ref = eng.frame()
    for chunk in (1024, H * W):
        other = small_engine("cuda", path="fast", chunk=chunk)
        other.set_state(st)
        assert torch.equal(other.frame(), ref), chunk
    sharded = small_engine("cuda", sharded=["cuda:0"] * 4, path="fast",
                           chunk=4096)
    sharded.set_state(st)
    before = fxaa.fxaa_ext.launches
    assert torch.equal(sharded.frame(), ref)
    assert fxaa.fxaa_ext.launches == before + 4


@pytest.mark.parametrize("name", sorted(CASES))
def test_sky_cache_off_equals_static_stack_on_the_card(dev, name):
    eng, one_shot = small_engine("cuda"), small_engine("cuda",
                                                       sky_cache=False)
    st = make_state(**CASES[name])
    eng.set_state(st)
    one_shot.set_state(st)
    assert torch.equal(one_shot.frame(), eng.frame())


@pytest.mark.parametrize("preview", [2, 4, 8])
def test_preview_launches_each_kernel_once(dev, preview):
    from raytracing_cuda_tpu_torch.utils.images import box_downsample

    eng = small_engine("cuda", preview=preview)
    full = small_engine("cuda")
    st = make_state(**CASES["island_night"])
    eng.set_state(st)
    full.set_state(st)
    before = (cuda_rt.raytrace_planes.launches, fxaa.fxaa.launches)
    small = eng.step_and_frame_preview()
    torch.cuda.synchronize()
    assert (cuda_rt.raytrace_planes.launches, fxaa.fxaa.launches) == (
        before[0] + 1, before[1] + 1)
    assert small.is_cuda and small.shape == (H // preview, W // preview, 3)
    assert np.array_equal(small.cpu().numpy(),
                          box_downsample(full.step_and_frame(), preview))


def test_readback_returns_each_frame_one_late(dev):
    from raytracing_cuda_tpu_torch.app.window import Readback

    eng = small_engine("cuda")
    ring, want, got = Readback(), [], []
    for i in range(6):
        frame = eng.step_and_frame()
        want.append(frame.clone())
        host = ring.submit(frame)
        if host is not None:
            assert host.device.type == "cpu" and host.is_pinned()
            got.append(host.clone())
    got.append(ring.flush().clone())
    assert len(got) == 6
    assert all(torch.equal(g, w.cpu()) for g, w in zip(got, want))
    big = eng.resized(2 * W, 2 * H)       # a resize: buffers allocated anew
    ring.flush()
    assert ring.submit(big.frame()) is None
    assert ring.flush().shape == (2 * H, 2 * W, 3)
