"""The `fast` and `oracle` render paths in the form the Engine's CUDA graphs
capture, on the CPU (96x160, a 64x128 procedural sky):

  - `render_base_image_fast(..., early_exit=False)` (every bounce and both
    shadow sweeps of each level run, masked, nothing read back) against the
    host-decided form, bit for bit (torch.equal), at the four golden
    states and the classic scene at 96x160, and at the seven degenerate
    states of tests/test_properties.py at 48x96 with a 32x64 sky (the size
    tests/test_torch_properties.py renders them at), each at two chunk
    sizes (several chunks with a padded last one, as the host-decided
    frame, and one chunk);
  - the `oracle` frame with the pad directions filled on the device against
    the same frame with them copied from a host tensor, as they were built
    before, bit for bit;
  - `fast` and `oracle` Engines driven through Engine._call (step_and_frame,
    frame(), step_and_frame_preview at preview 2, step_and_frame_batch of
    3) against an Engine that steps with step() and renders with
    _frame_eager(), frames and states bit for bit, and their masked device
    step (`fast`: Engine._step_render(..., early_exit=False), what a card
    captures) against the same frames;
  - the same Engines' frames against the JAX package's
    Engine(path="fast"|"oracle") on the same actions from the same state
    (carried across as numpy), under the golden contract of
    tests/test_golden.py:82-86: RMSE < 2e-3 and < 0.3 % of pixels off by
    more than 2 levels. The JAX Engine runs once per path per module;
  - a sharded `fast` frame by mesh entry (parallel/mesh.py
    entry_bands_plain, masked, each entry's rows with its halo rows
    recomputed, then place_bands) on ["cpu"] * 4 at interleave 1 and 2,
    against the single-device frame, bit for bit, and a sharded Engine's
    calls against the unsharded Engine's from the same state;
  - experiments/plain_graphs_torch.py, which measures those graphs on a
    card, refuses to run without one.

Widths and chunk sizes are multiples of 16 (ATen's vectorised CPU asin and
atan2 round differently in a scalar tail).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (CASES, EXTREME, GOLDEN_OFF_FRAC, GOLDEN_RMSE,
                        classic_env, golden_stats, make_state,
                        random_actions, states_equal)
from raytracing_cuda_tpu.app.loop import Engine as JEngine
from raytracing_cuda_tpu.sim.actions import Action as JAction
from raytracing_cuda_tpu.utils.config import RenderConfig as JConfig
from raytracing_cuda_tpu_torch import interop
from raytracing_cuda_tpu_torch.app.loop import Engine, _box_downsample
from raytracing_cuda_tpu_torch.core.math3d import true_div
from raytracing_cuda_tpu_torch.parallel.mesh import (entry_bands_plain,
                                                     place_bands)
from raytracing_cuda_tpu_torch.render import reference
from raytracing_cuda_tpu_torch.render.fast import render_base_image_fast
from raytracing_cuda_tpu_torch.render.pipeline import pack_actions
from raytracing_cuda_tpu_torch.scene import builders as tb
from raytracing_cuda_tpu_torch.scene.textures import (blend_sky,
                                                      procedural_skies)
from raytracing_cuda_tpu_torch.sim.state import camera_rays, derive_frame
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.images import box_downsample
from test_torch_sim import jax_fields

torch.set_num_threads(2)

H, W = 96, 160
SKY = (64, 128)
CHUNK = 4096
DT = 0.05
# the degenerate states at tests/test_torch_properties.py's size
H_X, W_X, SKY_X = 48, 96, (32, 64)


def engine(sharded=False, **kw) -> Engine:
    return Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY,
                               chunk=CHUNK, **kw), "cpu", sharded=sharded)


def fast_inputs(scene, texels, st, h, w):
    """render_base_image_fast's arguments before (height, width) for state
    st, as render_frame derives them."""
    scene_f, lights, ambient = derive_frame(scene, st)
    return (scene_f, lights, ambient, blend_sky(texels, st.sky_vars),
            true_div(st.day_time, 24.0), camera_rays(st.cam, w / h))


@pytest.fixture(scope="module")
def host_bases():
    """Each state's host-decided `fast` base frame (chunk 4096 at 96x160,
    1024 at 48x96) and its render_base_image_fast inputs, rendered once."""
    island = tb.build_scene()
    texels = {SKY: torch.from_numpy(procedural_skies(*SKY)),
              SKY_X: torch.from_numpy(procedural_skies(*SKY_X))}
    cache = {}

    def get(name):
        if name not in cache:
            if name == "classic":
                scene, st = classic_env()
            else:
                scene, st = island, make_state(**{**CASES, **EXTREME}[name])
            h, w, sky, chunk = ((H_X, W_X, SKY_X, 1024) if name in EXTREME
                                else (H, W, SKY, CHUNK))
            args = (*fast_inputs(scene, texels[sky], st, h, w), h, w)
            cache[name] = (args, chunk,
                           render_base_image_fast(*args, chunk=chunk))
        return cache[name]

    return get


@pytest.mark.parametrize("whole", [False, True], ids=["chunks", "one_chunk"])
@pytest.mark.parametrize("name", sorted(CASES) + ["classic"]
                         + sorted(EXTREME))
def test_masked_fast_equals_host_decided(host_bases, name, whole):
    """Every level and sweep run, masked, give the pixels of the early
    exits decided on the host, where NaN angles, the sea at +-500 and
    clamp's -0.0 could part them."""
    args, chunk, want = host_bases(name)
    h, w = args[-2:]
    got = render_base_image_fast(*args, chunk=h * w if whole else chunk,
                                 early_exit=False)
    assert got.shape == (h, w, 3) and torch.equal(got, want)


def test_oracle_pad_filled_on_the_device_changes_nothing(monkeypatch):
    """The padded last chunk (96 x 160 = 3 chunks of 4096 + 3072) with its
    directions filled on the device against the host tensor copied in
    before: the same rays and the same oracle frame."""
    def host_pad(cam, height, width, row0, total_height, chunk):
        flat = reference.primary_rays(cam, height, width, row0,
                                      total_height).reshape(-1, 3)
        n_px = height * width
        chunk = min(chunk, n_px)
        pad = -n_px % chunk
        up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32)
        return torch.cat([flat, up.expand(pad, 3)]).reshape(-1, chunk,
                                                            3), n_px

    scene, texels = tb.build_scene(), torch.from_numpy(procedural_skies(*SKY))
    args = (*fast_inputs(scene, texels, make_state(**CASES["island_night"]),
                         H, W), H, W)
    rays = reference.chunked_rays(args[5], H, W, 0, None, CHUNK)
    new = reference.render_base_image(*args, chunk=CHUNK)
    monkeypatch.setattr(reference, "chunked_rays", host_pad)
    old_rays = reference.chunked_rays(args[5], H, W, 0, None, CHUNK)
    assert torch.equal(rays[0], old_rays[0]) and rays[1] == old_rays[1]
    assert torch.equal(new, reference.render_base_image(*args, chunk=CHUNK))


KINDS = ("step_and_frame", "frame", "preview", "batch")


@pytest.fixture(scope="module")
def plain_calls():
    """Per path, one Engine (preview 2) driven through Engine._call —
    step_and_frame, frame(), step_and_frame_preview, a batch of 3 — and one
    stepped by step() and rendered by _frame_eager(), from the JAX
    Engine's start state; on `fast` the masked device step from the same
    state; the JAX Engine's step_and_frame frames of the same five
    actions. Each path runs once per module."""
    acts = random_actions(5, seed=61)
    cache = {}

    def get(path):
        if path in cache:
            return cache[path]
        jeng = JEngine(JConfig(width=W, height=H, sky_source="procedural",
                               procedural_sky_shape=SKY, path=path,
                               chunk=CHUNK))
        start = interop.state_from_numpy(jax_fields(jeng.state))
        jax_imgs = [np.asarray(jeng.step_and_frame(
            JAction.idle()._replace(**a._asdict()), DT)) for a in acts]
        eng, ref = engine(path=path, preview=2), engine(path=path)
        for e in (eng, ref):
            e.set_state(start)
        got, want, states, masked = {}, {}, {}, {}
        st = ref.state

        def step_masked(kind, a):
            # the masked device step a card captures, from the same state
            nonlocal st
            if path == "fast":
                st, masked[kind] = eng._step_render(kind, st, eng._upload(
                    pack_actions(a, [DT] * len(a))), early_exit=False)

        step_masked("frame", acts[:1])
        got["step_and_frame"] = eng.step_and_frame(acts[0], DT)
        ref.step(acts[0], DT)
        want["step_and_frame"] = ref._frame_eager()
        states["step_and_frame"] = (eng.state, ref.state)
        got["frame"] = eng.frame()
        want["frame"] = want["step_and_frame"]
        states["frame"] = (eng.state, ref.state)
        step_masked("preview", acts[1:2])
        got["preview"] = eng.step_and_frame_preview(acts[1], DT)
        ref.step(acts[1], DT)
        want["preview"] = _box_downsample(ref._frame_eager(), 2)
        states["preview"] = (eng.state, ref.state)
        got["batch"] = eng.step_and_frame_batch(acts[2:], [DT] * 3)
        batch = []
        for a in acts[2:]:
            ref.step(a, DT)
            batch.append(ref._frame_eager())
        want["batch"] = torch.stack(batch)
        states["batch"] = (eng.state, ref.state)
        step_masked("batch", acts[2:])
        cache[path] = dict(got=got, want=want, states=states, masked=masked,
                           masked_state=st, jax=jax_imgs, eng=eng)
        return cache[path]

    return get


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("path", ["fast", "oracle"])
def test_plain_engine_calls_equal_step_then_eager_frame(plain_calls, path,
                                                        kind):
    run = plain_calls(path)
    got, want = run["got"][kind], run["want"][kind]
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert states_equal(*run["states"][kind])
    warm = set(run["eng"]._single.warm)
    assert {("frame", 1), ("render", 1), ("preview", 1)} <= warm
    assert not any(k[0] == "batch" for k in warm)   # K frame calls


@pytest.mark.parametrize("kind", ["frame", "preview", "batch"])
def test_masked_device_step_equals_engine_calls(plain_calls, kind):
    """The `fast` Engine's _step_render with early_exit=False (the graphs'
    form) on the same actions: frame, preview 2 and the batch of 3, frames
    and the last state."""
    run = plain_calls("fast")
    want = run["want"]["step_and_frame" if kind == "frame" else kind]
    assert torch.equal(run["masked"][kind], want)
    assert states_equal(run["masked_state"], run["states"]["batch"][1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("path", ["fast", "oracle"])
def test_plain_engine_calls_match_jax_engine(plain_calls, path, kind):
    run = plain_calls(path)
    got = run["got"][kind].numpy()
    jax_imgs = run["jax"]
    want = {"step_and_frame": jax_imgs[0], "frame": jax_imgs[0],
            "preview": box_downsample(jax_imgs[1], 2),
            "batch": np.stack(jax_imgs[2:])}[kind]
    assert got.shape == want.shape
    rmse, off = golden_stats(got, want)
    print(f"port {path} {kind} vs JAX Engine: rmse {rmse:.6f}, pixels off "
          f"by more than 2 levels {off:.4%}")
    assert rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC, (rmse, off)


@pytest.fixture(scope="module")
def single_fast():
    """A single-device `fast` Engine and its frame at mountains_day."""
    eng = engine(path="fast")
    st = make_state(**CASES["mountains_day"])
    eng.set_state(st)
    return eng, st, eng._frame_eager()


@pytest.mark.parametrize("interleave", [1, 2])
def test_masked_entry_bands_equal_exchange_and_single(single_fast,
                                                      interleave):
    """Each of 4 mesh entries renders its chunks with their halo rows,
    early exits masked (entry_bands_plain), place_bands gathers them; the
    frame equals the single-device frame."""
    eng, st, ref = single_fast
    frame = torch.empty((1, H, W, 3), dtype=torch.uint8)
    for e in range(4):
        rows = entry_bands_plain(eng.scene, st, eng.sky_texels, entry=e, n=4,
                                 height=H, width=W, chunk=CHUNK,
                                 interleave=interleave, early_exit=False)
        assert rows.shape == (1, interleave, H // (4 * interleave), W, 3)
        place_bands(frame, rows, e, 4)
    assert torch.equal(frame[0], ref)


@pytest.mark.parametrize("interleave", [1, 2])
def test_sharded_fast_engine_calls_equal_eager_reference(single_fast,
                                                         interleave):
    """A sharded `fast` Engine on ["cpu"] * 4: frame() and step_and_frame
    through its entries against the single-device `fast` Engine's calls
    from the same state."""
    one, st, ref = single_fast
    eng = engine(sharded=["cpu"] * 4, path="fast",
                 shard_interleave=interleave)
    eng.set_state(st)
    assert torch.equal(eng.frame(), ref)
    act = random_actions(1, seed=62)[0]
    got = eng.step_and_frame(act, DT)
    one.set_state(st)
    want = one.step_and_frame(act, DT)
    assert torch.equal(got, want) and states_equal(eng.state, one.state)
    assert torch.equal(eng.frame(), one.frame())
    one.set_state(st)
    assert set(eng._replicas[tuple(eng.mesh)].warm) == {("render", 1),
                                                         ("bands", 1)}


def test_plain_graphs_probe_refuses_without_a_card(monkeypatch, capsys):
    """experiments/plain_graphs_torch.py measures CUDA graphs only: where
    no card is available it exits 2 and prints no result."""
    from experiments import plain_graphs_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert plain_graphs_torch.main([]) == 2
    assert capsys.readouterr().out == ""
