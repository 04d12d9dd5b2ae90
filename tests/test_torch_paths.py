"""The port's `fast` and `oracle` render paths, the one-shot `render_frame`
and the Engine on those paths, on the CPU at 96x160.

Contracts:
  - port `oracle` and `fast` frames against the JAX package's frames of the
    same path for the five CASES of tests/test_render_fast.py:55-61 and the
    classic scene, and port `oracle` against the five goldens in
    tests/golden/: the golden contract of tests/test_golden.py:82-86, RMSE
    < 2e-3 and < 0.3 % of pixels off by more than 2 levels. Bit equality
    with jitted JAX is not to be had: XLA contracts multiply-adds inside
    its fused expressions. Run with `-s` to see each RMSE and pixel share;
  - port `fast` against port `oracle`: tests/test_render_fast.py:72-76,
    RMSE < 2e-3 and < 0.3 % of pixels with a channel off by more than 1;
  - bit for bit: the chunk size, sky_cache=False against the static sky
    stack, row sharding against the single device, a batch against single
    frames, render_frame against the Engine.

Widths and chunk sizes are multiples of 16 (ATen's vectorised CPU asin and
atan2 round differently in a scalar tail).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.core.types import Camera as JCamera
from raytracing_cuda_tpu.render.pipeline import render_frame as jax_render
from raytracing_cuda_tpu.scene import builders as jb
from raytracing_cuda_tpu.scene.textures import procedural_skies
from raytracing_cuda_tpu.sim import state as jsim
from chip_smoke import (GOLDEN_OFF_FRAC, GOLDEN_RMSE, classic_env,
                        golden_stats, make_state, varied_actions)
from raytracing_cuda_tpu_torch import _build, interop
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.core.types import SkyTextures
from raytracing_cuda_tpu_torch.parallel.mesh import render_frame_sharded
from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa
from raytracing_cuda_tpu_torch.render.pipeline import (
    render_frame, render_frame_np, render_frame_static_sky)
from raytracing_cuda_tpu_torch.scene import builders as tb
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.images import load_png
from test_torch_sim import jax_fields

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
H, W = 96, 160
SKY = (64, 128)
CHUNK = 4096

# tests/test_render_fast.py:55-61, in make_state's keywords
CASES = {
    "island_morning": dict(day=6.0),
    "mountains_day": dict(day=14.0, cp=1),
    "island_night": dict(day=1.0),
    "evening_flood": dict(day=18.0, sea=2.0),
    "crossfade_noaa": dict(day=9.0, aa=False),
}
# tests/test_golden.py:39-44: the 96x160 goldens the JAX oracle wrote
GOLDENS = {
    "island_morning": dict(day=6.0),
    "mountains_day": dict(day=14.0, cp=1),
    "island_night": dict(day=1.0),
    "evening_flood_noaa": dict(day=18.0, sea=2.0, aa=False),
}
PATHS = ("oracle", "fast")


def engine(device="cpu", sharded=False, **kw) -> Engine:
    return Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY,
                               chunk=CHUNK, **kw), device, sharded=sharded)


def golden_ok(img, ref, what=""):
    rmse, off = golden_stats(np.asarray(img), np.asarray(ref))
    print(f"{what}: rmse {rmse:.6f}, pixels off by more than 2 levels "
          f"{off:.4%}")
    assert rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC, (what, rmse, off)


def scene_state(name):
    """(port scene name, port state) of a case, a golden or 'classic'."""
    if name == "classic":
        return "classic", classic_env()[1]
    return "island", make_state(**{**CASES, **GOLDENS}[name])


@pytest.fixture(scope="module")
def engines():
    """One CPU Engine per (scene, path), built at first use."""
    cache = {}

    def get(scene, path):
        if (scene, path) not in cache:
            cache[scene, path] = engine(scene=scene, path=path)
        return cache[scene, path]

    return get


@pytest.fixture(scope="module")
def frames(engines):
    """Port frames by (case, path), rendered once."""
    cache = {}

    def get(name, path):
        if (name, path) not in cache:
            scene, st = scene_state(name)
            eng = engines(scene, path)
            eng.set_state(st)
            cache[name, path] = eng.frame_np()
        return cache[name, path]

    return get


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX package's frames of the same states (the port's state
    carried across as numpy), by (case, path), rendered once."""
    sky = jnp.asarray(procedural_skies(*SKY))
    scenes = {"island": jb.build_scene(), "classic": jb.build_classic_scene()}
    cache = {}

    def get(name, path):
        if (name, path) not in cache:
            scene, st = scene_state(name)
            f = interop.state_to_numpy(st)
            jst = jsim.FrameState(
                cam=JCamera(**{k: jnp.asarray(v)
                               for k, v in f["cam"].items()}),
                **{k: jnp.asarray(v) for k, v in f.items() if k != "cam"})
            cache[name, path] = np.asarray(jax_render(
                scenes[scene], jst, sky, H, W, chunk=CHUNK, path=path))
        return cache[name, path]

    return get


def test_states_cross_packages_exactly():
    """The carried state is the JAX state machine's own, bit for bit."""
    jst = jsim.settle(jsim.init_state()._replace(day_time=jnp.float32(9.0)))
    got = interop.state_to_numpy(make_state(day=9.0))
    want = jax_fields(jst)
    for k in ("day_time", "sky_vars", "recolor_vars", "sea_y"):
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", [*CASES, "classic"])
def test_path_matches_jax(frames, jax_frames, name, path):
    img = frames(name, path)
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    golden_ok(img, jax_frames(name, path), f"port {path} vs JAX {path}, "
                                           f"{name}")


@pytest.mark.parametrize("name", [*GOLDENS, "classic"])
def test_oracle_matches_golden(frames, name):
    file = "classic_demo" if name == "classic" else name
    golden_ok(frames(name, "oracle"),
              load_png(os.path.join(GOLDEN_DIR, f"{file}.png")),
              f"port oracle vs tests/golden/{file}.png")


@pytest.mark.parametrize("name", [*CASES, "classic"])
def test_fast_matches_oracle(frames, name):
    fast = frames(name, "fast").astype(np.float32)
    oracle = frames(name, "oracle").astype(np.float32)
    diff = np.abs(fast - oracle)
    rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
    mismatched = np.mean(np.any(diff > 1.0, axis=-1))
    print(f"port fast vs port oracle, {name}: rmse {rmse:.6f}, pixels off "
          f"by more than 1 level {mismatched:.4%}")
    assert rmse < 2e-3, f"rmse {rmse}"
    assert mismatched < 0.003, f"{mismatched:.4%} pixels differ by >1 level"


@pytest.mark.parametrize("name", ["island_morning", "mountains_day"])
def test_kernel_path_matches_oracle(frames, name):
    """The megakernel path's plain versions against the port's oracle."""
    golden_ok(frames(name, "auto"), frames(name, "oracle"),
              f"port auto vs port oracle, {name}")


@pytest.mark.parametrize("path", PATHS)
def test_chunk_invariance(engines, frames, path):
    """Chunk size (and with it the early-exit grouping and the padding
    rays) never changes a pixel."""
    eng = engines("island", path)
    eng.set_state(make_state(day=14.0))
    ref = eng.frame()
    for chunk in (1024, 4000, H * W):     # 4000: a padded last chunk
        other = Engine(dataclasses.replace(eng.config, chunk=chunk), "cpu",
                       share_assets_from=eng)
        assert torch.equal(other.frame(), ref), chunk


@pytest.mark.parametrize("name", [*CASES])
def test_sky_cache_off_equals_static_stack(engines, name):
    """The per-frame blend + pack + flat lookup against the static stack's
    pair lookup, a crossfade among the cases."""
    eng, one_shot = engines("island", "auto"), engine(sky_cache=False)
    assert one_shot.sky_pack is None and eng.sky_texels is None
    st = make_state(**CASES[name])
    eng.set_state(st)
    one_shot.set_state(st)
    assert torch.equal(one_shot.frame(), eng.frame())


@pytest.mark.parametrize("n,interleave", [(2, 1), (4, 1), (4, 2), (8, 1)])
def test_sharded_fast_equals_single_device(engines, n, interleave):
    eng = engines("island", "fast")
    for kw in (dict(day=6.0), dict(day=18.0, sea=2.0, aa=False)):
        st = make_state(**kw)
        eng.set_state(st)
        img = render_frame_sharded(
            eng.scene, st, None, eng.sky_h, eng.sky_w, mesh=["cpu"] * n,
            height=H, width=W, interleave=interleave, path="fast",
            sky_texels=eng.sky_texels, chunk=CHUNK)
        assert torch.equal(img, eng.frame()), kw


def test_sharded_engines_on_plain_paths(engines):
    """Engine(sharded=...) on `fast` equals the single device; on `oracle`
    its bands run the fast renderer, as the JAX package's do."""
    fast = engines("island", "fast")
    st = make_state(day=14.0, cp=1)
    fast.set_state(st)
    ref = fast.frame()
    for path in PATHS:
        eng = engine(sharded=["cpu"] * 4, path=path, shard_interleave=2)
        eng.set_state(st)
        assert torch.equal(eng.frame(), ref), path
        assert torch.equal(eng.step_and_frame_batch(varied_actions(2))[0],
                           fast.step_and_frame(varied_actions(1)[0])), path
        fast.set_state(st)


def test_sharded_kernel_engine_keeps_the_static_stack():
    """sky_cache=False is the one-shot single-device knob: a sharded
    megakernel Engine keeps the static stack."""
    eng = engine(sharded=["cpu"] * 2, sky_cache=False)
    assert eng.sky_pack is not None and eng.sky_texels is None
    ref = engine()
    assert torch.equal(eng.frame(), ref.frame())


@pytest.mark.parametrize("path", PATHS)
def test_render_frame_equals_engine(engines, path):
    eng = engines("island", path)
    st = make_state(day=1.0)
    eng.set_state(st)
    img = render_frame(eng.scene, st, eng.sky_texels, H, W, chunk=CHUNK,
                       path=path)
    assert img.dtype == torch.uint8 and torch.equal(img, eng.frame())
    off = render_frame(eng.scene, st, eng.sky_texels, H, W, chunk=CHUNK,
                       path=path, fxaa_static=False)
    eng.set_state(st._replace(aa=torch.tensor(False)))
    assert torch.equal(off, eng.frame()) and not torch.equal(off, img)


def test_render_frame_kernel_branch_equals_static_sky(engines):
    """render_frame(path='auto'): blend → pack → flat lookup, equal bit for
    bit to render_frame_static_sky (pipeline.py:89-93 of the JAX package)."""
    eng = engines("island", "auto")
    texels = torch.from_numpy(procedural_skies(*SKY))
    clusters = dict(tri_clusters=eng.tri_clusters,
                    sph_clusters=eng.sph_clusters, t_subs=eng.tri_subs)
    for kw in (dict(day=9.0), dict(day=17.25, cp=1)):
        st = make_state(**kw)
        assert torch.equal(
            render_frame(eng.scene, st, texels, H, W, path="auto",
                         **clusters),
            render_frame_static_sky(eng.scene, st, eng.sky_pack, eng.sky_h,
                                    eng.sky_w, H, W, **clusters))


def test_render_frame_np_and_bad_path(engines):
    eng = engines("island", "fast")
    st = make_state(day=6.0)
    eng.set_state(st)
    sky = SkyTextures(texels=procedural_skies(*SKY))
    img = render_frame_np(tb.build_scene(), st, sky, H, W, "cpu",
                          chunk=CHUNK)            # default path: fast
    assert isinstance(img, np.ndarray)
    assert np.array_equal(img, eng.frame_np())
    with pytest.raises(ValueError, match="path"):
        render_frame(eng.scene, st, eng.sky_texels, H, W, path="pallas")
    with pytest.raises(ValueError, match="path"):
        render_frame_sharded(eng.scene, st, None, *SKY, mesh=["cpu"] * 2,
                             height=H, width=W, path="pallas")


@pytest.mark.parametrize("kw", [dict(path="fast"), dict(path="oracle"),
                                dict(sky_cache=False)],
                         ids=["fast", "oracle", "sky_cache_off"])
def test_engine_entry_points_on_blended_sky(kw):
    """step_and_frame_batch (a loop of single frames here), run, resized
    and render_script_dp's refusal on the paths that blend the sky per
    frame."""
    eng = engine(**kw)
    assert eng.sky_pack is None and eng.sky_texels.dtype == torch.uint8
    st0 = make_state(day=9.5)
    acts, dts = varied_actions(3), [1 / 60, 0.05, 0.02]
    eng.set_state(st0)
    imgs = eng.step_and_frame_batch(acts, dts)
    end = eng.state
    eng.set_state(st0)
    seq = [eng.step_and_frame(a, dt) for a, dt in zip(acts, dts)]
    assert imgs.shape == (3, H, W, 3)
    assert all(torch.equal(imgs[k], seq[k]) for k in range(3))
    assert torch.equal(end.day_time, eng.state.day_time)

    stats = eng.run(3, warmup=1, batch=2)
    assert stats.frames == 3

    big = eng.resized(192, 112)
    assert big.sky_texels is eng.sky_texels and big.state is eng.state
    assert big.frame().shape == (112, 192, 3)

    with pytest.raises(ValueError, match="static-sky"):
        eng.render_script_dp(acts, mesh=["cpu"] * 3)


def test_plain_paths_never_build_or_count(monkeypatch):
    """On CPU tensors the new paths build no kernel and count no launch."""
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    before = (cuda_rt.raytrace_planes.launches, fxaa.fxaa.launches)
    for kw in (dict(path="fast"), dict(sky_cache=False)):
        engine(**kw).step_and_frame()
    assert (cuda_rt.raytrace_planes.launches, fxaa.fxaa.launches) == before


def test_share_assets_needs_the_same_sky_form(engines):
    with pytest.raises(ValueError, match="share_assets_from"):
        Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY,
                            path="fast"), "cpu",
               share_assets_from=engines("island", "auto"))


@pytest.mark.parametrize("bad", [dict(path="pallas"), dict(path="plain"),
                                 dict(chunk=0), dict(preview=0),
                                 dict(preview=7), dict(preview=64)])
def test_render_config_validation(bad):
    with pytest.raises(ValueError):
        RenderConfig(width=W, height=H, **bad)


def test_render_config_defaults():
    c = RenderConfig()
    assert (c.path, c.chunk, c.preview, c.sky_cache) == ("auto", 32768, 1,
                                                         True)
    assert RenderConfig(width=W, height=H, preview=16).preview == 16
