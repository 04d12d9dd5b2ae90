"""The port's render slice end to end on the CPU (plain kernel versions).

  - Engine(device="cpu") frames for the four golden states and the classic
    scene against tests/golden/*.png under the golden contract of
    tests/test_golden.py:82-86: RMSE < 2e-3 and < 0.3 % of pixels off by
    more than 2 levels;
  - step_and_frame against the JAX render_frame_static_sky on a flat sky
    pack (interpret mode), stepping both state machines with the same
    actions, under the same contract;
  - kernel wrappers on CPU tensors never build anything and never count a
    launch; the package never imports JAX or the JAX package.
"""

import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.render import pipeline as jpipe
from raytracing_cuda_tpu.scene import builders as jb
from raytracing_cuda_tpu.scene.textures import (procedural_skies,
                                                sky_static_init)
from raytracing_cuda_tpu.sim import state as jsim
from raytracing_cuda_tpu.sim.actions import Action as JAction
import raytracing_cuda_tpu_torch
from chip_smoke import (CASES, GOLDEN_OFF_FRAC, GOLDEN_RMSE, golden_stats,
                        make_state)
from raytracing_cuda_tpu_torch import _build
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa
from raytracing_cuda_tpu_torch.render.pipeline import render_frame_static_sky
from raytracing_cuda_tpu_torch.sim import state as tsim
from raytracing_cuda_tpu_torch.sim.actions import Action as TAction
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.images import load_png
from raytracing_cuda_tpu_torch.utils.timing import FrameTimer

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
H, W = 96, 160
SKY = (64, 128)


def small_engine(**kw) -> Engine:
    return Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY,
                               **kw), device="cpu")


def golden_ok(img, ref):
    rmse, off = golden_stats(np.asarray(img), np.asarray(ref))
    assert rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC, (rmse, off)


@pytest.fixture(scope="module")
def engine():
    return small_engine()


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_matches_golden(engine, name):
    engine.set_state(make_state(**CASES[name]))
    img = engine.frame_np()
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    golden_ok(img, load_png(os.path.join(GOLDEN_DIR, f"{name}.png")))


def test_classic_engine_matches_golden():
    eng = small_engine(scene="classic")
    eng.set_state(tsim.settle(eng.state._replace(
        day_time=torch.tensor(14.0))))
    golden_ok(eng.frame_np(),
              load_png(os.path.join(GOLDEN_DIR, "classic_demo.png")))


def test_step_and_frame_matches_jax_static_sky():
    """Four animated steps (idle, a mouse turn with a move, a time scrub,
    then FXAA off) through both packages' host state and render."""
    eng = small_engine()
    jscene = jb.build_scene()
    jpack = sky_static_init(jnp.asarray(procedural_skies(*SKY)),
                            grouped=False)
    jst = jsim.settle(jsim.init_state())
    animate = jax.jit(jsim.animate)
    actions = [{}, dict(mouse_dx=np.float32(30.0), move_forward=np.int32(1)),
               dict(time_control=np.int32(1)), dict(set_aa_off=np.bool_(True))]
    for a in actions:
        img = eng.step_and_frame(TAction.idle()._replace(**a), 0.25).numpy()
        jst = animate(jst, JAction.idle()._replace(**a), jnp.float32(0.25))
        ref = jpipe.render_frame_static_sky(
            jscene, jst, jpack, *SKY, H, W, tri_clusters=jb.ISLAND_TRI_CLUSTERS,
            sph_clusters=jb.ISLAND_SPH_CLUSTERS, interpret=True)
        golden_ok(img, np.asarray(ref))
    assert not bool(eng.state.aa)


def test_one_shot_render_matches_engine(engine):
    """render_frame_static_sky (host packs copied to the sky's device) gives
    the Engine's frame (packs uploaded into its persistent buffer)."""
    st = make_state(**CASES["island_night"])
    engine.set_state(st)
    img = render_frame_static_sky(
        engine.scene, st, engine.sky_pack, engine.sky_h, engine.sky_w, H, W,
        tri_clusters=engine.tri_clusters, sph_clusters=engine.sph_clusters,
        t_subs=engine.tri_subs)
    assert torch.equal(img, engine.frame())


def test_cpu_wrappers_never_build_or_count(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    before = (cuda_rt.raytrace_planes.launches, fxaa.fxaa.launches)
    eng = small_engine()
    eng.step_and_frame()
    eng.frame()
    assert (cuda_rt.raytrace_planes.launches, fxaa.fxaa.launches) == before
    assert not _build._LIBS


def test_port_never_imports_jax():
    """Static scan (the JAX package may already sit in sys.modules here)."""
    root = Path(raytracing_cuda_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py"))
    assert len(files) > 15
    bad = re.compile(r"import jax|from jax|raytracing_cuda_tpu\.")
    for f in files:
        text = f.read_text()
        assert not bad.search(text), f"{f}: {bad.search(text).group(0)}"


def test_engine_run_steps_from_start_state():
    eng = small_engine()
    start = eng.state
    stats = eng.run(3, warmup=1)
    assert stats.frames == 3 and len(stats.frame_ms) == 3
    assert stats.seconds > 0 and stats.fps > 0
    expect = start
    for _ in range(3):
        expect = tsim.animate(expect, TAction.idle(), 1 / 60)
    assert torch.equal(eng.state.day_time, expect.day_time)


def test_engine_device_is_explicit():
    with pytest.raises(ValueError):
        Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY),
               device="meta")
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the no-CUDA refusal cannot be checked")
    with pytest.raises(RuntimeError):
        Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY),
               device="cuda")


@pytest.mark.parametrize("bad", [dict(width=1), dict(scene="x"),
                                 dict(sky_source="reference",
                                      sky_downsample=0),
                                 dict(procedural_sky_shape=(4, 8)),
                                 dict(aspect=0.0)])
def test_render_config_validation(bad):
    with pytest.raises(ValueError):
        RenderConfig(**bad)


def test_frame_timer_host_clock():
    t = FrameTimer(4, 2).start()
    for _ in range(3):
        t.tick()
    s = t.stop()
    assert s.frames == 3 and len(s.frame_ms) == 3
    assert s.as_dict()["frames"] == 3
