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

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import (CASES, EXTREME, GOLDEN_OFF_FRAC, GOLDEN_RMSE,
                        PACK_TRIG_ULP, POSES, golden_stats, halo_bands,
                        make_state, pack_differences, random_actions,
                        rays_apart, states_equal, toggling_actions,
                        varied_actions)
from raytracing_cuda_tpu_torch import __main__ as cli
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.core.types import to_device
from raytracing_cuda_tpu_torch.parallel.mesh import (render_frame_sharded,
                                                     replicate)
from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa
from raytracing_cuda_tpu_torch.render.packs import (base_to, pack_base,
                                                    pack_frame)
from raytracing_cuda_tpu_torch.render.pipeline import (_base, batch_packs,
                                                       bases_from_packs,
                                                       frame_packs,
                                                       frame_packs_torch,
                                                       pack_actions,
                                                       stack_packs)
from raytracing_cuda_tpu_torch.render.sky import (sky_quantize,
                                                  sky_quantize_torch)
from raytracing_cuda_tpu_torch.scene import builders as tb
from raytracing_cuda_tpu_torch.scene.textures import (pack_sky_all,
                                                      procedural_skies)
from raytracing_cuda_tpu_torch.sim import state as tsim
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils import profiling
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.images import load_png
from raytracing_cuda_tpu_torch.utils.timing import graph_nodes
from test_torch_sky_quantize import sky_clocks, sky_planes

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
    coef, params, nt, ns, cull = frame_packs(scene, st, h, w, None,
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


# kernel A's diagnostic arms (csrc/raytrace_arms.cu), and those of them
# that compute the shipped function
ARMS = {"noshadow": ("noshadow",), "noshade": ("noshade",),
        "sweep_only": ("noshade", "noshadow"), "depth0": ("depth0",),
        "depth1": ("depth1",), "depth2": ("depth2",), "nocull": ("nocull",),
        "no_tbound": ("no_tbound",), "nohcull": ("nohcull",),
        "depth4": ("depth4",)}
IDENTITY_ARMS = ("nocull", "no_tbound", "nohcull", "depth4")


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_raytrace_arm_matches_plain(dev, arm):
    """Each arm equals the same arm of the plain version bit for bit on the
    four golden states: one frame per launch (counted on arm_launches, not
    on launches), three frames per launch, and a 30-row band at row0 7 of
    those three; an arm that computes the shipped function also equals the
    shipped kernel."""
    ablate = ARMS[arm]
    packs = [_packs(name, dev) for name in sorted(CASES)]
    nt, ns, cull = packs[0][2:]
    before = (cuda_rt.raytrace_planes.launches,
              cuda_rt.raytrace_planes.arm_launches)
    for coef, params, *_ in packs:
        kern = torch.stack(cuda_rt.raytrace_planes(
            coef, params, H, W, nt, ns, cull=cull, ablate=ablate))
        plain = torch.stack(cuda_rt.raytrace_planes_torch(
            coef, params, H, W, nt, ns, ablate=ablate))
        assert torch.equal(kern, plain)
        if arm in IDENTITY_ARMS:
            assert torch.equal(kern, torch.stack(cuda_rt.raytrace_planes(
                coef, params, H, W, nt, ns, cull=cull)))
    launched = 4 if arm in IDENTITY_ARMS else 0
    assert (cuda_rt.raytrace_planes.launches,
            cuda_rt.raytrace_planes.arm_launches) == (before[0] + launched,
                                                      before[1] + 4)
    coefs = torch.stack([p[0] for p in packs[:3]])
    params = torch.stack([p[1] for p in packs[:3]])
    for h, row0 in ((H, 0), (30, 7)):
        kern = cuda_rt.raytrace_planes_batch(coefs, params, h, W, nt, ns,
                                             row0=row0, total_h=H, cull=cull,
                                             ablate=ablate)
        torch.cuda.synchronize()
        plain = cuda_rt.raytrace_planes_batch_torch(
            coefs, params, h, W, nt, ns, row0=row0, total_h=H, ablate=ablate)
        assert all(k.shape == (3, h, W) for k in kern)
        assert all(torch.equal(a, b) for a, b in zip(kern, plain))


def test_raytrace_arm_failures_raise(dev, monkeypatch):
    """No arm falls back to the plain version: a pair the arms library does
    not instantiate, a missing cull table, a failed build and a launch the
    launcher refuses all raise."""
    from raytracing_cuda_tpu_torch import _build

    coef, params, nt, ns, cull = _packs("island_morning", dev)
    with pytest.raises(ValueError, match="no instantiation"):
        cuda_rt.raytrace_planes(coef, params, H, W, nt, ns, cull=cull,
                                ablate=("noshadow", "depth1"))
    with pytest.raises(ValueError, match="cull"):
        cuda_rt.raytrace_planes(coef, params, H, W, nt, ns,
                                ablate=("noshadow",))
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_rt._launch(coef[None], params[None], H, W, nt, ns, 0, H, cull,
                        arms=(cuda_rt.ARM_NOSHADOW, 1))

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(RuntimeError, match="raytrace_arms"):
        cuda_rt.raytrace_planes(coef, params, H, W, nt, ns, cull=cull,
                                ablate=("depth1",))


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
    # the packs kernel: a base of another device, layout or dtype
    scene = to_device(tb.build_scene(), dev)
    st = tsim.state_to(make_state(6.0), dev)
    base = pack_base(scene, *ISLAND)
    bad_bases = [base_to(base, "cpu"),
                 base._replace(coef=base.coef.double()),
                 base._replace(row_class=base.row_class.long()),
                 base._replace(moving=base.moving.cpu()),
                 base._replace(sph_r=base.sph_r[:-1].contiguous()),
                 base._replace(lights=(0, base.coef.shape[0]))]
    before = pack_frame.launches
    for bad in bad_bases:
        with pytest.raises(ValueError):
            frame_packs(scene, st, H, W, None, *ISLAND, base=bad)
    with pytest.raises(ValueError, match="layout"):
        frame_packs(scene, st, H, W, None, *ISLAND,
                    base=pack_base(to_device(tb.build_classic_scene(), dev)))
    with pytest.raises(ValueError):
        pack_frame(base, st._replace(day_time=st.day_time.double()), W / H)
    with pytest.raises(ValueError):
        pack_frame(base, tsim.state_to(st, "cpu"), W / H)
    assert pack_frame.launches == before


def _batch_packs(dev, n=3):
    scene = tb.build_scene()
    st = make_state(6.0)
    states = [make_state(**CASES[c]) for c in sorted(CASES)][:n - 1] + [
        tsim.animate(st, varied_actions(2)[0], 0.5)]
    packs = [frame_packs(scene, s, H, W, None, *ISLAND) for s in states]
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
    """Frame DP on ["cuda:0"] * 2 and the 2 x 2 hybrid: three calls of 16
    frames from one state (eager, the capture, a replay of one CUDA graph
    per entry) each equal 16 step_and_frame calls of the single-device
    graph Engine, frames and end state, and every replica ends at that
    state."""
    acts = toggling_actions(16, seed=12)
    eng = small_engine("cuda", shard_interleave=2)
    st0 = make_state(9.5)
    eng.set_state(st0)
    seq = torch.stack([eng.step_and_frame(a, 0.05) for a in acts])
    end = eng.state
    for n, kw in ((2, dict(mesh=["cuda:0"] * 2)),
                  (4, dict(n_rows=2, mesh=[["cuda:0"] * 2] * 2))):
        for call in range(3):
            eng.set_state(st0)
            imgs = eng.render_script_dp(acts, dt=0.05, **kw)
            assert torch.equal(imgs, seq), (kw, call)
            assert states_equal(eng.state, end), (kw, call)
            reps = eng._replicas[(torch.device("cuda", 0),) * n]
            assert all(states_equal(live, end) for live in reps.live)
        assert len(reps.graphs) == 1


@pytest.mark.parametrize("interleave", [1, 2])
@pytest.mark.parametrize("kind", ["frame", "preview", "batch"])
def test_sharded_graph_replay_equals_eager_and_single(dev, kind, interleave):
    """A sharded Engine on ["cuda:0"] * 4 over 60 frames (64 in batches of
    8) with a preset change and an FXAA toggle: the first call runs each
    entry eagerly, every call after it replays one CUDA graph per entry;
    each equals the single-device graph Engine's call from the same state,
    frames and states bit for bit, and every replica equals that state
    after every call."""
    k = 8 if kind == "batch" else 1
    kw = dict(preview=2 if kind == "preview" else 1,
              shard_interleave=interleave)
    eng = small_engine("cuda", sharded=["cuda:0"] * 4, **kw)
    one = small_engine("cuda", **kw)
    n = 64 if k > 1 else 60
    acts = toggling_actions(n, seed=11)
    dts = [0.02 + 0.01 * (i % 5) for i in range(n)]
    call = {"frame": lambda e, a, d: e.step_and_frame(a[0], d[0]),
            "preview": lambda e, a, d: e.step_and_frame_preview(a[0], d[0]),
            "batch": lambda e, a, d: e.step_and_frame_batch(a, d)}[kind]
    kept = []
    for i in range(0, n, k):
        a, d = acts[i:i + k], dts[i:i + k]
        got = call(eng, a, d)
        want = call(one, a, d)
        assert torch.equal(got, want), i
        assert states_equal(eng.state, one.state), i
        for live in eng._replicas[tuple(eng.mesh)].live:
            assert states_equal(live, one.state), i
        kept.append((got, want.clone()))
    graphs = eng._replicas[tuple(eng.mesh)].graphs
    assert set(graphs) == {("bands", k)} and len(graphs["bands", k]) == 4
    assert len({g.out.data_ptr() for g in graphs["bands", k]}) == 4
    assert all(torch.equal(g, w) for g, w in kept)


def test_sharded_replay_counts_band_launches_only(dev):
    eng = small_engine("cuda", sharded=["cuda:0"] * 4)
    for _ in range(2):                   # eager, then the capture
        eng.step_and_frame()
    torch.cuda.synchronize()
    names = ("launches", "frames")
    before = {(f.__name__, a): getattr(f, a, 0) for f in
              (cuda_rt.raytrace_planes, cuda_rt.raytrace_planes_batch,
               fxaa.fxaa, fxaa.fxaa_batch, fxaa.fxaa_ext) for a in names}
    for _ in range(3):
        eng.step_and_frame()
    after = {(f.__name__, a): getattr(f, a, 0) for f in
             (cuda_rt.raytrace_planes, cuda_rt.raytrace_planes_batch,
              fxaa.fxaa, fxaa.fxaa_batch, fxaa.fxaa_ext) for a in names}
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {("raytrace_planes_batch", "launches"): 12,
                     ("raytrace_planes_batch", "frames"): 12,
                     ("fxaa_ext", "launches"): 12,
                     ("fxaa_ext", "frames"): 12}, moved


def test_sharded_replay_never_syncs(dev):
    """The sharded graph path (uploads, replays, the gather's 2-D copies)
    and render_script_dp's replay run under
    torch.cuda.set_sync_debug_mode("error")."""
    eng = small_engine("cuda", sharded=["cuda:0"] * 4, shard_interleave=2,
                       preview=2)
    dp = small_engine("cuda")
    acts = random_actions(8, seed=13)
    for _ in range(2):                   # eager, then the capture
        eng.step_and_frame(acts[0], 0.05)
        eng.step_and_frame_batch(acts)
        dp.render_script_dp(acts, dt=0.05, n_rows=2,
                            mesh=[["cuda:0"] * 2] * 2)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step_and_frame(acts[1], 0.05)
        eng.step_and_frame_preview(acts[2], 0.05)
        eng.step_and_frame_batch(acts)
        dp.render_script_dp(acts, dt=0.05, n_rows=2,
                            mesh=[["cuda:0"] * 2] * 2)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()


def test_copy_rows_equals_strided_copy(dev):
    """The gather's 2-D memcpy against Tensor.copy_ into the same strided
    rows, and its refusals."""
    from raytracing_cuda_tpu_torch.parallel.mesh import copy_rows

    src = _noise((6, 7, 11), 14).to(dev)
    frames = torch.zeros((6, 3, 7, 11, 3), dtype=torch.uint8, device=dev)
    want = frames.clone()
    want[:, 1].copy_(src)
    copy_rows(frames[:, 1], src)
    assert torch.equal(frames, want)
    with pytest.raises(ValueError):
        copy_rows(frames[:, 1, :6], src)


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


# --- the frame step on the card: device packs, the CUDA graph ---


def test_engine_keeps_scene_state_and_cull_table_on_the_card(dev):
    eng = small_engine("cuda")
    assert all(t.is_cuda for t in eng.scene) and eng.cull.is_cuda
    eng.set_state(make_state(6.0))
    for _ in range(3):                   # eager, capture, replay
        eng.step_and_frame()
    assert all(t.is_cuda for t in tsim.state_tensors(eng.state))


@pytest.mark.parametrize("name", sorted(CASES) + ["worst_pose", "classic"]
                         + sorted(EXTREME))
def test_device_packs_equal_cpu_packs_but_trig(dev, name):
    """Packs built on the card equal the CPU's but for the entries that
    pass through sin/cos/tan, within PACK_TRIG_ULP; kernel A on the card's
    packs equals its plain version bit for bit, and the rays the trig
    ulps move are reported."""
    scene, st, clusters = _scene_state(name)
    cpu = frame_packs(scene, st, H, W, None, *clusters)
    packs = frame_packs(to_device(scene, dev), tsim.state_to(st, dev), H, W,
                        None, *clusters)
    assert all(t.is_cuda for t in (packs[0], packs[1], packs[4]))
    bad, worst = pack_differences(cpu, packs)
    assert bad == 0 and worst <= PACK_TRIG_ULP, (bad, worst)
    coef, params, nt, ns, cull = packs
    kern = cuda_rt.raytrace_planes(coef, params, H, W, nt, ns, cull=cull)
    plain = cuda_rt.raytrace_planes_torch(coef, params, H, W, nt, ns)
    assert all(torch.equal(a, b) for a, b in zip(kern, plain))
    on_cpu_packs = cuda_rt.raytrace_planes(
        cpu[0].to(dev), cpu[1].to(dev), H, W, nt, ns, cull=cull)
    print(f"{name}: trig entries within {worst:.2f} ulp; rays apart from "
          f"the CPU packs' {rays_apart(kern, on_cpu_packs)} of {H * W}")


def _packs_equal(got, want) -> bool:
    """Two frame_packs results equal bit for bit, the row counts too."""
    return (all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
            and tuple(got[2:4]) == tuple(want[2:4])
            and torch.equal(got[4], want[4]))


@pytest.mark.parametrize("name", sorted(POSES) + ["classic"])
def test_packs_kernel_equals_torch_packs(dev, name):
    """frame_packs on the card (one launch of csrc/packs.cu) equals the
    torch packs on the card bit for bit, with the base built for the call
    and with the scene's base given."""
    scene, st, clusters = _scene_state(name)
    scene, st = to_device(scene, dev), tsim.state_to(st, dev)
    want = frame_packs_torch(scene, st, H, W, None, *clusters)
    before = pack_frame.launches
    got = frame_packs(scene, st, H, W, None, *clusters)
    assert pack_frame.launches == before + 1
    assert _packs_equal(got, want)
    base = pack_base(scene, *clusters)
    assert _packs_equal(
        frame_packs(scene, st, H, W, None, *clusters, want[4], base), want)


def _flight(n, seed, device, scene="island"):
    eng = small_engine(device, scene=scene)
    st = eng.state
    out = []
    for i, a in enumerate(random_actions(n, seed)):
        st = tsim.animate(st, a, 0.02 + 0.03 * (i % 4))
        out.append(st)
    return eng, out


@pytest.mark.parametrize("scene", ["island", "classic"])
def test_packs_kernel_equals_torch_packs_over_a_flight(dev, scene):
    """300 frames of seeded random actions from the Engine's start, stepped
    on the card: the kernel's packs of every state equal the torch packs
    bit for bit."""
    eng, states = _flight(300, 17, dev, scene)
    cl = (eng.tri_clusters, eng.sph_clusters, eng.tri_subs)
    for i, st in enumerate(states):
        got = frame_packs(eng.scene, st, H, W, None, *cl, eng.cull,
                          eng.pack_base)
        want = frame_packs_torch(eng.scene, st, H, W, None, *cl, eng.cull)
        assert _packs_equal(got, want), i


def test_packs_kernel_equals_torch_packs_on_random_states(dev):
    """2,000 states drawn at random over the clock, yaw, pitch, field of
    view, recolour weights, sea height and position: the kernel's packs
    equal the torch packs bit for bit (every trig input of the frame)."""
    eng = small_engine(dev)
    cl = (eng.tri_clusters, eng.sph_clusters, eng.tri_subs)
    rng = np.random.default_rng(23)
    t = lambda v: torch.tensor(np.float32(v), device=dev)  # noqa: E731
    for i in range(2000):
        st = eng.state
        w = rng.dirichlet(np.ones(4)).astype(np.float32)
        st = st._replace(
            cam=st.cam._replace(
                pos=t(rng.uniform(-600, 600, 3)),
                hor_angle=t(rng.uniform(0, 360)),
                ver_angle=t(rng.uniform(-44, 44)),
                fov=t(rng.choice([40.0, rng.uniform(10, 120)]))),
            day_time=t(rng.uniform(0, 24)), sea_y=t(rng.uniform(-50, 50)),
            recolor_vars=t(w))
        got = frame_packs(eng.scene, st, H, W, None, *cl, eng.cull,
                          eng.pack_base)
        want = frame_packs_torch(eng.scene, st, H, W, None, *cl, eng.cull)
        assert _packs_equal(got, want), i


def test_batch_and_sharded_packs_equal_the_singles(dev):
    """The K = 8 batch's packs (8 launches, stacked) equal each state's
    single packs, and so do the packs of every entry of a sharded Engine
    (its device's copy of the scene, cull table and base)."""
    eng = small_engine(dev)
    cl = (eng.tri_clusters, eng.sph_clusters, eng.tri_subs)
    vecs = np.stack([a.pack(0.05) for a in random_actions(8, seed=8)])
    before = pack_frame.launches
    coefs, params, nt, ns, cull, states = batch_packs(
        eng.scene, eng.state, vecs, H, W, None, *cl, eng.cull,
        eng.pack_base)
    assert pack_frame.launches == before + 8
    for k, st in enumerate(states):
        want = frame_packs_torch(eng.scene, st, H, W, None, *cl, eng.cull)
        assert _packs_equal((coefs[k], params[k], nt, ns, cull), want), k
    sharded = small_engine("cuda", sharded=["cuda:0"] * 4)
    for d in dict.fromkeys(sharded.mesh):
        entry = stack_packs(sharded._scenes[d], states, H, W, None, *cl,
                            sharded._culls[d], sharded._pack_bases[d])
        assert torch.equal(entry[0], coefs) and torch.equal(entry[1], params)
        assert torch.equal(entry[4], cull)


@pytest.mark.parametrize("kind", ["frame", "batch", "preview"])
def test_graph_replay_equals_eager_device_step(dev, kind):
    """Over 60 frames (64 in batches of 8) of seeded actions, every call
    after the first replays the Engine's CUDA graph; each equals the same
    device step run eagerly from the same state (Engine._step_render),
    frames and states bit for bit. A state read before a call is unchanged
    after it, and no frame returned is overwritten by a later call."""
    k = 8 if kind == "batch" else 1
    eng = small_engine("cuda", preview=2 if kind == "preview" else 1)
    acts = random_actions(64 if k > 1 else 60, seed=5)
    dts = [0.02 + 0.01 * (i % 5) for i in range(len(acts))]
    call = {"frame": lambda a, d: eng.step_and_frame(a[0], d[0]),
            "preview": lambda a, d: eng.step_and_frame_preview(a[0], d[0]),
            "batch": eng.step_and_frame_batch}[kind]
    st = tsim.clone_state(eng.state)
    kept = []
    for i in range(0, len(acts), k):
        a, d = acts[i:i + k], dts[i:i + k]
        before = eng.state
        before_copy = tsim.clone_state(before)
        got = call(a, d)
        st, want = eng._step_render(kind, st,
                                    eng._upload(pack_actions(a, d)))
        assert torch.equal(got, want), i
        assert states_equal(eng.state, st), i
        assert states_equal(before, before_copy), i
        kept.append((got, want.clone()))
    assert set(eng._graphs) == {(kind, k)}
    assert all(torch.equal(g, w) for g, w in kept)


def test_graph_replay_counts_the_kernels_it_launches(dev):
    eng = small_engine("cuda")
    for _ in range(2):                   # eager, then the capture
        eng.step_and_frame()
    four = random_actions(4, seed=4)
    eng.step_and_frame_batch(four)
    eng.step_and_frame_batch(four)
    torch.cuda.synchronize()
    before = (cuda_rt.raytrace_planes.launches, fxaa.fxaa.launches,
              cuda_rt.raytrace_planes_batch.launches,
              cuda_rt.raytrace_planes_batch.frames, fxaa.fxaa_batch.launches,
              pack_frame.launches, sky_quantize.launches,
              sky_quantize.frames)
    for _ in range(3):
        eng.step_and_frame()
    assert pack_frame.launches == before[5] + 3      # one a frame replay
    assert sky_quantize.launches == before[6] + 3
    eng.step_and_frame_batch(four)
    assert (cuda_rt.raytrace_planes.launches, fxaa.fxaa.launches,
            cuda_rt.raytrace_planes_batch.launches,
            cuda_rt.raytrace_planes_batch.frames,
            fxaa.fxaa_batch.launches, pack_frame.launches,
            sky_quantize.launches, sky_quantize.frames) == (
        before[0] + 3, before[1] + 3, before[2] + 1, before[3] + 4,
        before[4] + 1, before[5] + 3 + 4, before[6] + 3 + 1,
        before[7] + 3 + 4)


def test_eager_device_step_never_syncs(dev):
    """The eager step (state step, packs, kernels, sky, FXAA select), the
    eager frame, and the replays of step_and_frame, step(), fast_forward's
    single steps and frame() run under
    torch.cuda.set_sync_debug_mode("error"): nothing reads the device back
    or copies from pageable memory."""
    eng = small_engine("cuda", preview=2)
    for _ in range(2):                   # builds, then the capture
        eng.step_and_frame()
    torch.cuda.synchronize()
    for _ in range(2):                   # step() and frame(): the same
        eng.step(random_actions(1, seed=7)[0], 0.05)
        eng.frame()
    vecs = eng._upload(pack_actions(random_actions(8, seed=6), [0.05] * 8))
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = eng.state
        for kind in ("frame", "preview", "batch"):
            st, out = eng._step_render(kind, st,
                                       vecs if kind == "batch" else vecs[:1])
        eng._frame_eager()
        eng.step(random_actions(1, seed=7)[0], 0.05)
        eng.fast_forward(random_actions(4, seed=8), 0.05)
        eng.frame()
        eng.step_and_frame(random_actions(1, seed=9)[0], 0.05)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()


def test_capture_failure_raises(dev):
    """A step that cannot be captured (here it reads a value back) raises
    from the call that captures, and renders nothing in its place. Run in
    a process of its own: a failed capture may leave the context unusable."""
    code = (
        "import torch\n"
        "from raytracing_cuda_tpu_torch.app.loop import Engine\n"
        "from raytracing_cuda_tpu_torch.utils.config import RenderConfig\n"
        "eng = Engine(RenderConfig(width=160, height=96,"
        " procedural_sky_shape=(64, 128)), 'cuda')\n"
        "step = eng._step_render\n"
        "def syncing(kind, state, avs):\n"
        "    new, out = step(kind, state, avs)\n"
        "    float(out.float().mean())\n"
        "    return new, out\n"
        "eng._step_render = syncing\n"
        "eng.step_and_frame()\n"
        "try:\n"
        "    eng.step_and_frame()\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__)\n"
        "else:\n"
        "    print('no error')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert "raised" in res.stdout, (res.stdout, res.stderr[-2000:])


# --- the other entry points as CUDA graphs: frame(), step(),
# fast_forward, sky_cache=False ---


@pytest.mark.parametrize("aa", [True, False])
def test_frame_graph_equals_eager_frame(dev, aa):
    """frame() at the four golden states and the worst pose (FXAA on, or
    off everywhere): the first call eager, then one CUDA graph replay per
    call (kernel A and kernel B once each), each equal to _frame_eager()
    bit for bit; the state snapshot survives and no frame is
    overwritten."""
    eng = small_engine("cuda")
    kept = []
    for name, kw in [*CASES.items(), ("worst_pose", POSES["worst_pose"])]:
        eng.set_state(make_state(**dict(kw, aa=aa)))
        st = eng.state
        for _ in range(2):
            before = (cuda_rt.raytrace_planes.launches, fxaa.fxaa.launches)
            img = eng.frame()
            torch.cuda.synchronize()
            if ("render", 1) in eng._graphs:
                assert (cuda_rt.raytrace_planes.launches - before[0],
                        fxaa.fxaa.launches - before[1]) == (1, 1), name
            assert torch.equal(img, eng._frame_eager()), name
            kept.append((img, img.clone()))
        assert eng.state is st
    assert set(eng._graphs) == {("render", 1)}
    assert all(torch.equal(a, b) for a, b in kept)


@pytest.mark.parametrize("interleave", [1, 2])
def test_sharded_frame_graphs_equal_single_device_frame(dev, interleave):
    """A sharded Engine's frame() on ["cuda:0"] * 4: one CUDA graph per
    entry (its rows of its replica, unstepped) against the single-device
    Engine's frame, bit for bit, before and after sharded step calls."""
    eng = small_engine("cuda", sharded=["cuda:0"] * 4,
                       shard_interleave=interleave)
    one = small_engine("cuda")
    acts = toggling_actions(6, seed=15)
    for i, name in enumerate(sorted(CASES)):
        for e in (eng, one):
            e.set_state(make_state(**CASES[name]))
        for _ in range(2):
            img = eng.frame()
            assert torch.equal(img, one.frame()), name
        eng.step_and_frame(acts[i], 0.05)
        one.step_and_frame(acts[i], 0.05)
        assert torch.equal(eng.frame(), one.frame()), name
    graphs = eng._replicas[tuple(eng.mesh)].graphs
    assert len(graphs["render", 1]) == 4


@pytest.fixture(scope="module")
def ff_engines(dev):
    """An Engine whose step graph fast_forward replays is captured once,
    and one to step eagerly."""
    return small_engine("cuda"), small_engine("cuda")


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 600])
def test_fast_forward_graphs_equal_eager_stepping(ff_engines, n):
    """fast_forward over n varied vectors (one step() graph replay per
    vector once warm) against the device step run eagerly once per
    vector, bit for bit."""
    eng, ref = ff_engines
    acts = random_actions(n, seed=16 + n)
    st = make_state(7.9)
    eng.set_state(st)
    got = eng.fast_forward(acts, 1 / 30)
    want = tsim.state_to(st, ref.device)
    for av in ref._upload(pack_actions(acts, [1 / 30] * n)):
        want = tsim.animate_packed(want, av)
    assert states_equal(got, want)
    if n >= 2:
        assert set(eng._graphs) == {("step", 1)}


def test_step_graph_equals_eager_step(dev):
    eng = small_engine("cuda")
    acts = random_actions(8, seed=17)
    st = tsim.clone_state(eng.state)
    for a in acts:
        got = eng.step(a, 0.05)
        st = tsim.animate_packed(st, eng._upload(a.pack(0.05)[None])[0])
        assert states_equal(got, st)
    assert ("step", 1) in eng._graphs


@pytest.mark.parametrize("kind,k,preview", [("frame", 1, 1),
                                            ("preview", 1, 2),
                                            ("batch", 3, 1)])
def test_sky_cache_off_graphs_equal_eager_step(dev, kind, k, preview):
    """sky_cache=False (the one-shot render_frame: blend + pack per frame)
    through its CUDA graph against Engine._step_render from the same
    state, frames and states bit for bit, over 6 calls."""
    eng = small_engine("cuda", sky_cache=False, preview=preview)
    acts = random_actions(6 * k, seed=18)
    call = {"frame": lambda a: eng.step_and_frame(a[0], 0.05),
            "preview": lambda a: eng.step_and_frame_preview(a[0], 0.05),
            "batch": lambda a: eng.step_and_frame_batch(a, [0.05] * k)}[kind]
    eng.set_state(make_state(9.5))
    st = tsim.clone_state(eng.state)
    for i in range(0, 6 * k, k):
        a = acts[i:i + k]
        got = call(a)
        st, want = eng._step_render(kind, st,
                                    eng._upload(pack_actions(a, [0.05] * k)))
        assert torch.equal(got, want), i
        assert states_equal(eng.state, st), i
    assert (kind, k) in eng._graphs


# --- the `fast` and `oracle` paths as CUDA graphs ---


@pytest.mark.parametrize("path", ["fast", "oracle"])
def test_plain_frame_graphs_equal_eager_frame(dev, path):
    """frame() on the `fast` and `oracle` paths at the four golden states,
    the worst pose and the classic scene: the first call eager, then one
    CUDA graph replay per call (kernel B once, kernel A never), each equal
    bit for bit to _frame_eager(), whose `fast` early exits are decided on
    the host."""
    eng = small_engine("cuda", path=path, chunk=4096)
    classic = small_engine("cuda", path=path, chunk=4096, scene="classic")
    poses = [(eng, make_state(**POSES[name]), name)
             for name in sorted(CASES) + ["worst_pose"]]
    for e, st, name in poses + [(classic, classic.state, "classic")]:
        e.set_state(st)
        for _ in range(2):
            before = (cuda_rt.raytrace_planes.launches, fxaa.fxaa.launches)
            img = e.frame()
            torch.cuda.synchronize()
            if ("render", 1) in e._graphs:
                assert (cuda_rt.raytrace_planes.launches - before[0],
                        fxaa.fxaa.launches - before[1]) == (0, 1), name
            assert torch.equal(img, e._frame_eager()), name
    assert set(eng._graphs) == set(classic._graphs) == {("render", 1)}


@pytest.mark.parametrize("kind,k,preview", [("frame", 1, 1),
                                            ("preview", 1, 2),
                                            ("batch", 3, 1)])
@pytest.mark.parametrize("path", ["fast", "oracle"])
def test_plain_step_graphs_equal_eager_step(dev, path, kind, k, preview):
    """step_and_frame, its preview and a batch of 3 (three replays of the
    step_and_frame graph) on the plain paths against Engine._step_render
    from the same state, with the host's early exits, frames and states
    bit for bit, over 4 calls."""
    eng = small_engine("cuda", path=path, preview=preview, chunk=4096)
    acts = random_actions(4 * k, seed=71)
    call = {"frame": lambda a: eng.step_and_frame(a[0], 0.05),
            "preview": lambda a: eng.step_and_frame_preview(a[0], 0.05),
            "batch": lambda a: eng.step_and_frame_batch(a, [0.05] * k)}[kind]
    eng.set_state(make_state(17.6, yaw=315.0))
    st = tsim.clone_state(eng.state)
    kept = []
    for i in range(0, 4 * k, k):
        a = acts[i:i + k]
        got = call(a)
        st, want = eng._step_render(
            kind, st, eng._upload(pack_actions(a, [0.05] * k)),
            early_exit=True)
        assert torch.equal(got, want), i
        assert states_equal(eng.state, st), i
        kept.append((got, want.clone()))
    assert set(eng._graphs) == {("frame" if kind == "batch" else kind, 1)}
    assert all(torch.equal(g, w) for g, w in kept)


@pytest.mark.parametrize("interleave", [1, 2])
def test_sharded_fast_graphs_equal_single_device(dev, interleave):
    """A sharded `fast` Engine on ["cuda:0"] * 4: frame() and
    step_and_frame by one CUDA graph per entry (entry_bands_plain, early
    exits masked) against the single-device `fast` Engine, frames and
    states bit for bit; kernel B's band form once per chunk of a call."""
    eng = small_engine("cuda", sharded=["cuda:0"] * 4, path="fast",
                       chunk=4096, shard_interleave=interleave)
    one = small_engine("cuda", path="fast", chunk=4096)
    acts = toggling_actions(8, seed=72)
    for i, name in enumerate(sorted(CASES)):
        for e in (eng, one):
            e.set_state(make_state(**CASES[name]))
        img = eng.frame()
        assert torch.equal(img, one.frame()), name
        for a in acts[2 * i:2 * i + 2]:
            before = fxaa.fxaa_ext.launches
            got = eng.step_and_frame(a, 0.05)
            torch.cuda.synchronize()
            assert fxaa.fxaa_ext.launches == before + 4 * interleave
            assert torch.equal(got, one.step_and_frame(a, 0.05)), name
            assert states_equal(eng.state, one.state), name
    graphs = eng._replicas[tuple(eng.mesh)].graphs
    assert len(graphs["render", 1]) == len(graphs["bands", 1]) == 4


@pytest.mark.parametrize("path", ["fast", "oracle"])
def test_plain_graph_replays_never_sync(dev, path):
    """The replays of frame(), step_and_frame, its preview and a batch on
    the plain paths, and a sharded `fast` Engine's, run under
    torch.cuda.set_sync_debug_mode("error"): no early exit read back."""
    eng = small_engine("cuda", path=path, preview=2, chunk=4096)
    sharded = small_engine("cuda", sharded=["cuda:0"] * 4, path=path,
                           chunk=4096)
    calls = [eng.frame, eng.step_and_frame, eng.step_and_frame_preview,
             lambda: eng.step_and_frame_batch(random_actions(2, seed=73)),
             sharded.frame, sharded.step_and_frame]
    for call in calls:
        for _ in range(2):               # eager, then the capture
            call()
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()


# --- tracing: the marked variant of the frame graph, the spans ---


def fly_actions(n: int, seed: int) -> list:
    """n Actions of the benchmark's `fly` traffic from seed."""
    from rtbench import generator

    flight = generator.Flight(generator.load_traffic("fly"), seed)
    return [Action.unpack(v) for v in flight.take(n)]


def profiled_trace(fn, path: str):
    """fn() under a torch.profiler session of the card (shapes recorded,
    so the spans carry their call numbers), exported to path and parsed
    with the program's spans kept: (rtbench Trace, [engine.replay spans]).
    Traced again, up to 4 times, while the trace holds no kernel (now and
    then a trace comes back without its device events)."""
    from rtbench import trace as rtrace

    for _ in range(4):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA],
                record_shapes=True) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        tr = rtrace.parse(path)
        if tr.kernels("raytrace_kernel"):
            with open(path) as f:
                replays = sorted((e for e in json.load(f)["traceEvents"]
                                  if e.get("ph") == "X"
                                  and e.get("name") == "engine.replay"),
                                 key=lambda e: float(e["ts"]))
            return tr, replays
    pytest.fail("4 torch.profiler traces held no kernel")


def test_marked_variant_frames_equal_the_plain_graph(dev):
    """Ten calls of the fly's actions: an Engine under the profiler
    replays the marked variant (captured at its first traced call), one
    without it the plain graph; frames and states equal bit for bit."""
    plain, traced = small_engine("cuda"), small_engine("cuda")
    for eng in (plain, traced):
        eng.step_and_frame()             # eager
    acts = fly_actions(10, seed=2 ** 31 + 17)
    want = [plain.step_and_frame(a, 1 / 60).clone() for a in acts]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        got = [traced.step_and_frame(a, 1 / 60).clone() for a in acts]
        torch.cuda.synchronize()
    assert set(traced._single.traced) == {("frame", 1)}
    assert set(traced._single.graphs) == set()
    assert set(plain._single.traced) == set()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert states_equal(traced.state, plain.state)


def test_marked_step_has_four_more_nodes(dev):
    """The frame step captured inside marking() holds the plain step's
    graph nodes and the four marks."""
    eng = small_engine("cuda")
    eng.step_and_frame()                 # eager: kernels built and loaded
    live = eng._single.live[0]
    av = eng._upload(Action.idle().pack(1 / 60)[None])

    def fn():
        eng._step_render("frame", live, av)

    plain = graph_nodes(fn)
    with profiling.marking():
        marked = graph_nodes(fn)
    assert marked == plain + 4
    assert graph_nodes(fn) == plain


@pytest.fixture(scope="module")
def five_traced_calls(dev, tmp_path_factory):
    """A warm Engine's five step_and_frame calls of the fly under the
    profiler → (Trace, engine.replay spans)."""
    eng = small_engine("cuda")
    for _ in range(2):                   # eager, then the plain capture
        eng.step_and_frame()
    acts = fly_actions(5, seed=99)
    path = str(tmp_path_factory.mktemp("marks") / "trace.json")
    return profiled_trace(
        lambda: [eng.step_and_frame(a, 1 / 60) for a in acts], path)


def test_profiled_calls_hold_four_marks_each_in_order(five_traced_calls):
    from rtbench import stages

    tr, _ = five_traced_calls
    marks = [e for e in tr.device if e.cat == "kernel"
             and stages.stage_of(e.name) is not None]
    assert len(marks) == 20
    got = stages.frames(tr)
    assert len(got) == 5
    for f in got:
        order = [f.marks[s] for s in stages.STAGES]
        assert all(a.ts + a.dur <= b.ts for a, b in zip(order, order[1:]))
        assert f.marks["packs"].ts < f.a_end <= f.marks["sky"].ts
        assert f.step_kernels > 0 and f.packs_kernels > 0


def test_each_begin_mark_starts_after_its_replay_span(five_traced_calls):
    """On the trace's one clock: the k-th call's stage_mark_begin starts
    after the k-th engine.replay span has begun."""
    from rtbench import stages

    tr, replays = five_traced_calls
    begins = sorted((e for e in tr.device if e.cat == "kernel"
                     and stages.stage_of(e.name) == "begin"),
                    key=lambda e: e.ts)
    assert len(replays) == len(begins) == 5
    calls = [r["args"]["call"] for r in replays]
    assert calls == list(range(calls[0], calls[0] + 5))
    for r, b in zip(replays, begins):
        assert b.ts >= float(r["ts"])


def test_first_call_after_the_profiler_replays_the_plain_graph(dev):
    eng = small_engine("cuda")
    for _ in range(2):                   # eager, then the plain capture
        eng.step_and_frame()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        eng.step_and_frame()
        torch.cuda.synchronize()
    replayed = []

    class Spy:
        def __init__(self, graph, name):
            self.graph, self.name = graph, name

        def replay(self):
            replayed.append(self.name)
            self.graph.replay()

    key = ("frame", 1)
    for table, name in ((eng._single.graphs, "plain"),
                        (eng._single.traced, "marked")):
        table[key] = [g._replace(graph=Spy(g.graph, name))
                      for g in table[key]]
    eng.step_and_frame()
    assert replayed == ["plain"]


# --- the sky lookup and quantize (csrc/sky.cu) against its torch twin ---

BIG_SKY = (4096, 8192)               # the benchmark's panoramas


@pytest.fixture(scope="module")
def big_sky(dev):
    """The (4, 4096 * 8192) int32 stack of the procedural panoramas."""
    return pack_sky_all(torch.from_numpy(procedural_skies(*BIG_SKY)).to(dev))


def _sky_equal(planes, sky_pack, day_time, sky_vars, sky=BIG_SKY):
    """One sky_quantize launch on the card equals sky_quantize_torch on the
    card bit for bit, and counts one launch of K frames → the frames."""
    K = planes[0].shape[0]
    before = (sky_quantize.launches, sky_quantize.frames)
    got = sky_quantize(planes, sky_pack, *sky, day_time, sky_vars)
    torch.cuda.synchronize()
    assert (sky_quantize.launches, sky_quantize.frames) == (
        before[0] + 1, before[1] + K)
    want = sky_quantize_torch(planes, sky_pack, *sky, day_time, sky_vars)
    bad = (got != want).any(-1)
    assert not bad.any(), (int(bad.sum()), bad.nonzero()[:8].tolist())
    return got


def _on(dev, planes, hours):
    """planes and the clocks and sky weights of `hours`, one a frame, on
    dev."""
    day_time, sky_vars = sky_clocks(hours)
    return (tuple(p.to(dev) for p in planes), day_time.to(dev),
            sky_vars.to(dev))


def _sky_equal_at(dev, sky_pack, planes, hours):
    planes, day_time, sky_vars = _on(dev, planes, hours)
    return _sky_equal(planes, sky_pack, day_time, sky_vars)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("h,w", [(720, 1280), (1080, 1920)])
def test_sky_kernel_equals_twin_on_the_island(dev, big_sky, name, h, w):
    """Kernel A's planes of the golden states at 720p and 1080p, with the
    8192 x 4096 stack; and the one-frame pipeline (_base) on them."""
    coef, params, nt, ns, cull = _packs(name, dev, h, w)
    planes = [p[None] for p in cuda_rt.raytrace_planes(coef, params, h, w,
                                                       nt, ns, cull=cull)]
    st = tsim.state_to(make_state(**CASES[name]), dev)
    got = _sky_equal(planes, big_sky, st.day_time.reshape(1),
                     st.sky_vars.reshape(1, 4))
    assert torch.equal(_base(coef, params, nt, ns, big_sky, *BIG_SKY, st, h,
                             w, cull), got[0])


# each side of every change of the sky blend, in float32 steps, and the
# crossfades' midpoints (equal weights)
BLEND_CHANGES = (4.0, 6.0, 8.0, 10.0, 16.0, 18.0, 20.0, 22.0)
BLEND_HOURS = [float(np.nextafter(np.float32(c), np.float32(d)))
               for c in BLEND_CHANGES for d in (0.0, 24.0)] + [
    *BLEND_CHANGES, 5.0, 9.0, 17.0, 21.0]


@pytest.mark.parametrize("K", [1, 8])
def test_sky_kernel_across_every_blend_change(dev, big_sky, K):
    """A sky ray at every pixel of a 720p frame, at each hour of
    BLEND_HOURS (K frames a launch, a clock and weights a frame), and at
    weights set by hand: equal pairs, a pure panorama (wb = 0), ties with
    a third."""
    for i in range(0, len(BLEND_HOURS), K):
        hours = BLEND_HOURS[i:i + K]
        _sky_equal_at(dev, big_sky, sky_planes(len(hours), seed=i, h=720,
                                               w=1280, sky=True), hours)
    planes, day_time, _ = _on(dev, sky_planes(6, seed=99, h=720, w=1280,
                                              sky=True), [9.5] * 6)
    weights = torch.tensor([[0.5, 0.5, 0.0, 0.0], [0.0, 0.0, 0.5, 0.5],
                            [0.0, 0.0, 1.0, 0.0], [1.0, 0.0, 0.0, 0.0],
                            [0.25, 0.25, 0.25, 0.25], [0.0, 0.4, 0.2, 0.4]],
                           device=dev)
    _sky_equal(planes, big_sky, day_time, weights)


@pytest.mark.parametrize("hour", [0.0, 6.0, 12.5, 23.999998])
def test_sky_kernel_at_the_atan2_seam_and_the_poles(dev, big_sky, hour):
    """Directions at atan2's seam (x = ±0 and the smallest floats either
    side, z < 0: ±π) and at asin's ends (y = ±1 and past them, clamped),
    a sky ray at every pixel."""
    rng = np.random.default_rng(int(hour * 10))
    n = 720 * 1280
    tiny = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38, 1e-7, -1e-7],
                    np.float32)
    x = rng.choice(tiny, n)
    z = -rng.uniform(1e-6, 1.0, n).astype(np.float32)
    y = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    ends = np.array([1.0, -1.0, 1.0000001, -1.0000001, 0.99999994,
                     -0.99999994, 2.0, -2.0], np.float32)
    pole = rng.random(n) < 0.5
    y[pole] = rng.choice(ends, int(pole.sum()))
    planes = list(sky_planes(1, seed=7, h=720, w=1280, sky=True))
    planes[4:] = [torch.from_numpy(v.reshape(1, 720, 1280)) for v in (x, y, z)]
    _sky_equal_at(dev, big_sky, planes, [hour])


@pytest.mark.parametrize("mw", ["zero", "positive"])
def test_sky_kernel_miss_weight_zero_or_positive_everywhere(dev, big_sky,
                                                            mw):
    """Colours in and beyond [0, 1] and signed zeros, under a miss weight of
    0 at every pixel (no texel read), or above 0 at every pixel."""
    planes = list(sky_planes(2, seed=11, h=720, w=1280, sky=mw == "positive"))
    if mw == "zero":
        planes[3] = torch.zeros_like(planes[3])
        planes[0][0, :1] = -0.0
    _sky_equal_at(dev, big_sky, planes, [6.0, 19.0])


def test_sky_kernel_k8_equals_its_single_frames(dev, big_sky):
    """K = 8, a clock and weights a frame: the launch equals the twin and
    each frame's own K = 1 launch."""
    hours = [0.5, 4.2, 7.0, 9.3, 14.0, 17.6, 20.9, 23.0]
    planes, day_time, sky_vars = _on(dev, sky_planes(8, seed=8, h=720,
                                                     w=1280), hours)
    got = _sky_equal(planes, big_sky, day_time, sky_vars)
    for k in range(8):
        one = sky_quantize(tuple(p[k:k + 1] for p in planes), big_sky,
                           *BIG_SKY, day_time[k:k + 1], sky_vars[k:k + 1])
        assert torch.equal(one[0], got[k]), k


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("h,w", [(37, 53), (2, 2), (5, 9), (3, 1282)])
def test_sky_kernel_ragged_frames(dev, big_sky, h, w, K):
    """Frames whose pixel count is no multiple of 4 (byte loads and stores,
    a thread's last pixels past the frame) or whose frames K > 1 start off
    16-byte alignment."""
    _sky_equal_at(dev, big_sky, sky_planes(K, seed=h * w, h=h, w=w),
                  [8.5, 16.5, 2.0][:K])


def test_sky_kernel_band_at_row0_179(dev, big_sky):
    """The 182-row band at row0 179 of a 720p frame (a 4-way split's chunk
    with its halo rows), K = 2: bases_from_packs on the card equals the
    twin on the band's planes and the full frames' rows."""
    names = ["island_morning", "island_night"]
    packs = [_packs(name, dev, 720, 1280) for name in names]
    coefs = torch.stack([p[0] for p in packs])
    params = torch.stack([p[1] for p in packs])
    nt, ns, cull = packs[0][2:]
    states = [tsim.state_to(make_state(**CASES[n]), dev) for n in names]
    day_time = torch.stack([st.day_time for st in states])
    sky_vars = torch.stack([st.sky_vars for st in states])
    band = cuda_rt.raytrace_planes_batch(coefs, params, 182, 1280, nt, ns,
                                         row0=179, total_h=720, cull=cull)
    got = _sky_equal(band, big_sky, day_time, sky_vars)
    assert torch.equal(bases_from_packs(
        coefs, params, nt, ns, big_sky, *BIG_SKY, states, 182, 1280,
        row0=179, total_h=720, cull=cull), got)
    full = bases_from_packs(coefs, params, nt, ns, big_sky, *BIG_SKY, states,
                            720, 1280, cull=cull)
    assert torch.equal(full[:, 179:361], got)


def test_sky_kernel_in_the_720p_engine_graph(dev):
    """A 720p Engine with the benchmark's sky: each frame replay launches
    the sky kernel once and equals the eager step; its base frame equals
    the twin on the kernel A planes of its state."""
    eng = Engine(RenderConfig(width=1280, height=720,
                              procedural_sky_shape=BIG_SKY), device="cuda")
    acts = random_actions(6, seed=21)
    st = tsim.clone_state(eng.state)
    for i, a in enumerate(acts):
        before = sky_quantize.launches
        got = eng.step_and_frame(a, 0.02)
        torch.cuda.synchronize()
        assert sky_quantize.launches == before + 1, i
        st, want = eng._step_render("frame", st,
                                    eng._upload(pack_actions([a], [0.02])))
        assert torch.equal(got, want), i
    assert set(eng._graphs) == {("frame", 1)}
    coef, params, nt, ns, _ = eng._packs(eng.state)
    planes = [p[None] for p in cuda_rt.raytrace_planes(
        coef, params, 720, 1280, nt, ns, cull=eng.cull)]
    base = _base(coef, params, nt, ns, eng.sky_pack, eng.sky_h, eng.sky_w,
                 eng.state, 720, 1280, eng.cull)
    twin = sky_quantize_torch(planes, eng.sky_pack, eng.sky_h, eng.sky_w,
                              eng.state.day_time.reshape(1),
                              eng.state.sky_vars.reshape(1, 4))
    assert torch.equal(base, twin[0])
