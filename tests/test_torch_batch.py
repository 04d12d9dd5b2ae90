"""The port's offline batch path on the CPU (plain kernel versions).

  - render_frames_batch against the JAX package's (interpret mode) at K = 2,
    through a time scrub into the 8-10 h crossfade with FXAA switched off
    on frame 2, under the golden contract of tests/test_golden.py:82-86
    (RMSE < 2e-3, < 0.3 % of pixels off by more than 2 levels); the end
    states within ROADMAP's per-field tolerances against a jitted JAX
    program (adds/multiplies/fmod within 1 ulp, trig-derived fields within
    test_torch_sim.TRIG_ULP);
  - the port's batch against K step_and_frame calls, and each batch kernel
    form's plain version against per-frame calls: bit for bit (torch.equal),
    since a batch runs the same per-frame arithmetic;
  - the Engine's batch drivers (step_and_frame_batch, run(batch=K),
    fast_forward, resized, time_string).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.app.loop import Engine as JEngine
from raytracing_cuda_tpu.render import pipeline as jpipe
from raytracing_cuda_tpu.scene import builders as jb
from raytracing_cuda_tpu.scene.textures import (procedural_skies,
                                                sky_static_init)
from raytracing_cuda_tpu.sim import state as jsim
from raytracing_cuda_tpu.sim.actions import Action as JAction
from raytracing_cuda_tpu.utils.config import RenderConfig as JConfig
from chip_smoke import GOLDEN_OFF_FRAC, GOLDEN_RMSE, golden_stats
from raytracing_cuda_tpu_torch import _build, interop
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa
from raytracing_cuda_tpu_torch.render.pipeline import (frame_packs,
                                                       render_frames_batch)
from raytracing_cuda_tpu_torch.render.sky import sky_quantize
from raytracing_cuda_tpu_torch.scene import builders as tb
from raytracing_cuda_tpu_torch.sim import state as tsim
from raytracing_cuda_tpu_torch.sim.actions import Action as TAction
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from test_torch_sim import assert_state_match, jax_fields

torch.set_num_threads(2)

H, W = 96, 160
SKY = (64, 128)
DT = 0.1                    # a scrub step moves the clock 0.2 h
START_DAY = 7.9             # frame 1 crosses into the 8-10 h crossfade
BATCH_ACTIONS = [dict(time_control=np.int32(1), mouse_dx=np.float32(20.0)),
                 dict(time_control=np.int32(1), set_aa_off=np.bool_(True))]


def small_engine(**kw) -> Engine:
    return Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY,
                               **kw), device="cpu")


def vecs(action_fields, dt=DT, cls=TAction):
    return np.stack([cls.idle()._replace(**a).pack(dt) for a in action_fields])


def varied_actions(n):
    return [TAction.idle()._replace(
        mouse_dx=np.float32(5.0 * i), move_forward=np.int32(i % 2),
        time_control=np.int32(1), set_aa_off=np.bool_(i == 1),
        set_aa_on=np.bool_(i == 2)) for i in range(n)]


def start_states():
    jst = jsim.settle(jsim.init_state()._replace(
        day_time=jnp.float32(START_DAY)))
    return jst, interop.state_from_numpy(jax_fields(jst))


@pytest.fixture(scope="module")
def jax_batch():
    """JAX render_frames_batch in interpret mode on the flat sky pack."""
    jst, _ = start_states()
    pack = sky_static_init(jnp.asarray(procedural_skies(*SKY)),
                           grouped=False)
    imgs, last = jpipe.render_frames_batch(
        jb.build_scene(), jst, pack, *SKY,
        jnp.asarray(vecs(BATCH_ACTIONS, cls=JAction)), H, W,
        tri_clusters=jb.ISLAND_TRI_CLUSTERS,
        sph_clusters=jb.ISLAND_SPH_CLUSTERS, interpret=True)
    return np.asarray(imgs), last


@pytest.fixture(scope="module")
def port_batch():
    eng = small_engine()
    _, tst = start_states()
    imgs, last = render_frames_batch(
        eng.scene, tst, eng.sky_pack, eng.sky_h, eng.sky_w,
        vecs(BATCH_ACTIONS), H, W, tri_clusters=tb.ISLAND_TRI_CLUSTERS,
        sph_clusters=tb.ISLAND_SPH_CLUSTERS, t_subs=tb.ISLAND_TRI_SUBS)
    return eng, tst, imgs, last


def test_batch_matches_jax(jax_batch, port_batch):
    jimgs, jlast = jax_batch
    _, _, imgs, last = port_batch
    assert imgs.shape == (2, H, W, 3) and imgs.dtype == torch.uint8
    for k in range(2):
        rmse, off = golden_stats(imgs[k].numpy(), jimgs[k])
        assert rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC, (k, rmse, off)
    assert 8.0 < float(last.day_time) < 10.0     # inside the crossfade
    assert not bool(last.aa)
    assert_state_match(jlast, last, max_ulp=1)


def test_batch_matches_sequential_frames(port_batch):
    eng, tst, imgs, last = port_batch
    eng.set_state(tst)
    for k, a in enumerate(BATCH_ACTIONS):
        assert torch.equal(eng.step_and_frame(TAction.idle()._replace(**a),
                                              DT), imgs[k]), k
    for a, b in zip(interop.state_to_numpy(eng.state).items(),
                    interop.state_to_numpy(last).items()):
        if a[0] == "cam":
            assert all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
        else:
            assert np.array_equal(a[1], b[1]), a[0]


def test_fxaa_off_frame_is_the_base_frame(port_batch):
    """Frame 2 has aa off: it is the unfiltered frame, whose FXAA'd
    version is what the same state renders with aa on."""
    eng, tst, imgs, last = port_batch
    eng.set_state(last._replace(aa=torch.tensor(True)))
    on = eng.frame()
    assert not torch.equal(on, imgs[1]) and torch.equal(fxaa.fxaa(imgs[1]),
                                                        on)


def batch_packs_of(states, h, w):
    scene = tb.build_scene()
    packs = [frame_packs(scene, st, h, w, None, tb.ISLAND_TRI_CLUSTERS,
                        tb.ISLAND_SPH_CLUSTERS) for st in states]
    return (torch.stack([p[0] for p in packs]),
            torch.stack([p[1] for p in packs]), packs[0][2], packs[0][3])


def test_raytrace_batch_plain_equals_per_frame():
    st = tsim.settle(tsim.init_state())
    states = [st, tsim.settle(st._replace(day_time=torch.tensor(14.0))),
              tsim.animate(st, TAction.idle()._replace(
                  mouse_dx=np.float32(300.0)), 0.5)]
    coefs, params, nt, ns = batch_packs_of(states, 24, 40)
    planes = cuda_rt.raytrace_planes_batch(coefs, params, 24, 40, nt, ns)
    assert len(planes) == 7 and planes[0].shape == (3, 24, 40)
    for k in range(3):
        single = cuda_rt.raytrace_planes(coefs[k], params[k], 24, 40, nt, ns)
        assert all(torch.equal(p[k], s) for p, s in zip(planes, single)), k
    band = cuda_rt.raytrace_planes_batch_torch(coefs, params, 8, 40, nt, ns,
                                               row0=10, total_h=24)
    assert all(torch.equal(b, p[:, 10:18]) for b, p in zip(band, planes))


def test_fxaa_batch_plain_equals_per_frame():
    imgs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, 19, 23, 3)).astype(np.uint8))
    out = fxaa.fxaa_batch(imgs)
    assert out.shape == imgs.shape and out.dtype == torch.uint8
    for k in range(4):
        assert torch.equal(out[k], fxaa.fxaa(imgs[k])), k
    assert torch.equal(out, fxaa.fxaa_batch_torch(imgs))


def test_step_and_frame_batch_list_and_packed_inputs():
    acts = varied_actions(3)
    dts = [0.05, 0.2, 0.1]
    a, b, c = small_engine(), small_engine(), small_engine()
    seq = [a.step_and_frame(x, dt) for x, dt in zip(acts, dts)]
    from_list = b.step_and_frame_batch(acts, dts)
    from_vecs = c.step_and_frame_batch(
        np.stack([x.pack(dt) for x, dt in zip(acts, dts)]))
    for k in range(3):
        assert torch.equal(from_list[k], seq[k])
        assert torch.equal(from_vecs[k], seq[k])
    for e in (b, c):
        assert torch.equal(e.state.day_time, a.state.day_time)
        assert torch.equal(e.state.cam.pos, a.state.cam.pos)
        assert bool(e.state.aa) == bool(a.state.aa)
    with pytest.raises(ValueError, match="dts"):
        b.step_and_frame_batch(acts, dts[:2])
    with pytest.raises(ValueError):
        b.step_and_frame_batch(np.zeros((2, 15), np.float32))
    with pytest.raises(ValueError):
        b.step_and_frame_batch([])


def test_step_and_frame_batch_default_dt():
    acts = varied_actions(2)
    a, b = small_engine(), small_engine()
    seq = [a.step_and_frame(x) for x in acts]
    out = b.step_and_frame_batch(acts)
    assert all(torch.equal(out[k], seq[k]) for k in range(2))


def test_run_batch_then_remainder():
    eng = small_engine()
    start = eng.state
    stats = eng.run(6, batch=4, warmup=1)
    assert stats.frames == 6
    assert len(stats.frame_ms) == 3          # one batch + two single frames
    assert stats.seconds > 0
    assert stats.seconds * 1e3 >= max(stats.frame_ms)
    expect = start
    for _ in range(6):
        expect = tsim.animate(expect, TAction.idle(), 1 / 60)
    assert torch.equal(eng.state.day_time, expect.day_time)
    assert torch.equal(eng.state.sky_vars, expect.sky_vars)
    with pytest.raises(ValueError):
        eng.run(4, batch=2, on_frame=lambda i, img: None)
    with pytest.raises(ValueError):
        eng.run(4, batch=0)


def test_run_batch_action_fn_matches_single():
    acts = varied_actions(5)
    a, b = small_engine(), small_engine()
    a.run(5, action_fn=lambda i: acts[i], dt=0.1, warmup=0)
    b.run(5, action_fn=lambda i: acts[i], dt=0.1, warmup=0, batch=2)
    assert torch.equal(a.state.day_time, b.state.day_time)
    assert torch.equal(a.state.cam.hor_angle, b.state.cam.hor_angle)
    assert bool(a.state.aa) == bool(b.state.aa)


def scripted(n):
    return [TAction.idle()._replace(mouse_dx=np.float32(2.0 * i),
                                    time_control=np.int32(1),
                                    move_forward=np.int32(i % 2))
            for i in range(n)]


def test_fast_forward_equals_stepping():
    acts = scripted(7)
    a, b, c = small_engine(), small_engine(), small_engine()
    for x in acts:
        a.step(x, 1 / 30)
    b.fast_forward(acts, 1 / 30)
    c.fast_forward(np.stack([x.pack(1 / 30) for x in acts]))
    for e in (b, c):
        for x, y in zip(interop.state_to_numpy(a.state).items(),
                        interop.state_to_numpy(e.state).items()):
            if x[0] == "cam":
                assert all(np.array_equal(x[1][k], y[1][k]) for k in x[1])
            else:
                assert np.array_equal(x[1], y[1]), x[0]
    assert c.fast_forward([]) is c.state


def test_fast_forward_matches_jax():
    acts = scripted(6)
    jeng = JEngine(JConfig(width=32, height=16, sky_source="procedural",
                           procedural_sky_shape=(16, 32), path="fast"))
    jeng.FF_CHUNK = 4                   # one scanned chunk + 2 single steps
    eng = small_engine()
    eng.set_state(interop.state_from_numpy(jax_fields(jeng.state)))
    jeng.fast_forward([JAction.idle()._replace(**x._asdict()) for x in acts],
                      1 / 30)
    eng.fast_forward(acts, 1 / 30)
    assert_state_match(jeng.state, eng.state, max_ulp=1)


def test_resized_shares_assets():
    eng = small_engine()
    eng.step(TAction.idle(), 0.5)
    small = eng.resized(80, 48)
    assert (small.config.width, small.config.height) == (80, 48)
    assert small.scene is eng.scene and small.sky_pack is eng.sky_pack
    assert small.state is eng.state
    img = small.frame()
    assert img.shape == (48, 80, 3) and img.dtype == torch.uint8
    with pytest.raises(ValueError):
        Engine(RenderConfig(width=W, height=H, procedural_sky_shape=(32, 64)),
               "cpu", share_assets_from=eng)


@pytest.mark.parametrize("day", [0.0, 1.0, 5.999, 6.5, 13.75, 23.999])
def test_format_time_matches_jax(day):
    d = float(np.float32(day))
    assert tsim.format_time(d) == jsim.format_time(d)
    eng = small_engine()
    eng.set_state(eng.state._replace(day_time=torch.tensor(np.float32(day))))
    assert eng.time_string() == jsim.format_time(d)


def test_cpu_batch_wrappers_never_build_or_count(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    counts = lambda: (cuda_rt.raytrace_planes_batch.launches,  # noqa: E731
                      cuda_rt.raytrace_planes_batch.frames,
                      fxaa.fxaa_batch.launches, fxaa.fxaa_batch.frames,
                      sky_quantize.launches, sky_quantize.frames)
    before = counts()
    small_engine().step_and_frame_batch(varied_actions(2))
    assert counts() == before


def test_batch_wrappers_reject_other_devices():
    meta = torch.empty((1, 8, cuda_rt.N_CHANNELS), device="meta")
    with pytest.raises(ValueError):
        cuda_rt.raytrace_planes_batch(meta, meta, 4, 4, 1, 1)
    with pytest.raises(ValueError):
        fxaa.fxaa_batch(torch.empty((1, 4, 4, 3), dtype=torch.uint8,
                                    device="meta"))
