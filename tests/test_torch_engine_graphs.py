"""The Engine's entry points through the call bookkeeping its CUDA graphs
use (Engine._call: the state replicas, the `current` flags, the state
snapshot), on the CPU, where every call runs eagerly with the plain kernel
versions (96x160, a 64x128 procedural sky):

  - `frame()` (the JAX Engine's `_render_only`) against `_frame_eager()`,
    bit for bit (torch.equal), at golden states and with FXAA off; the
    state snapshot survives set_state → frame → step_and_frame → frame;
  - a sharded Engine's `frame()` on ["cpu"] * 4 (each entry renders its
    rows of its replica, unstepped) against its `_frame_eager()` (the
    single-device frame rendered eagerly on its device) and the
    single-device Engine's frame, bit for bit, at interleave 1 and 2 (the width
    is a multiple of 16: ATen's vectorised CPU asin/atan2 round a tensor's
    scalar tail differently);
  - `fast_forward` (one `step()` call per vector) against stepping frame
    by frame, exactly, for 0, 1, 3, 4, 5 and 11 vectors; against the JAX
    Engine's fast_forward with its chunk cut to 4, so that it runs jitted
    scans over chunk boundaries and single steps
    (raytracing_cuda_tpu/app/loop.py:256-283), under ROADMAP's state
    contract: add/multiply/fmod fields within 1 ulp of a jitted program,
    trig-derived fields within test_torch_sim's TRIG_ULP;
  - a sky_cache=False Engine's step_and_frame, preview and batch of 3
    (the one-shot render_frame inside the call) against step() then
    frame(), frames and states bit for bit.
"""

import numpy as np
import pytest
import torch

from bench_torch import CASES
from chip_smoke import make_state, random_actions, states_equal
from raytracing_cuda_tpu.app.loop import Engine as JEngine
from raytracing_cuda_tpu.sim.actions import Action as JAction
from raytracing_cuda_tpu.utils.config import RenderConfig as JConfig
from raytracing_cuda_tpu_torch import interop
from raytracing_cuda_tpu_torch.app.loop import Engine, _box_downsample
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from test_torch_sim import assert_state_match, jax_fields

torch.set_num_threads(2)

H, W = 96, 160
SKY = (64, 128)


def engine(sharded=False, **kw) -> Engine:
    return Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY,
                               **kw), device="cpu", sharded=sharded)


@pytest.fixture(scope="module")
def single():
    return engine()


@pytest.mark.parametrize("name,aa", [("island_morning", True),
                                     ("mountains_day", True),
                                     ("evening_flood_noaa", False)])
def test_frame_equals_eager_frame(single, name, aa):
    st = make_state(**dict(CASES[name], aa=aa))
    single.set_state(st)
    img = single.frame()
    assert img.shape == (H, W, 3) and img.dtype == torch.uint8
    assert torch.equal(img, single._frame_eager())
    assert single.state is st


def test_frame_keeps_the_state_snapshot():
    """frame() renders the replica without stepping it: the snapshot set
    or read before it is the one read after it, and its frame follows the
    state step_and_frame leaves."""
    eng, ref = engine(), engine()
    st = make_state(9.5)
    eng.set_state(st)
    first = eng.frame()
    assert eng.state is st
    acts = random_actions(2, seed=41)
    stepped = eng.step_and_frame(acts[0], 0.05)
    snap = eng.state
    again = eng.frame()
    assert eng.state is snap and torch.equal(again, stepped)
    ref.set_state(st)
    assert torch.equal(first, ref.frame())
    ref.step(acts[0], 0.05)
    assert states_equal(snap, ref.state)
    assert torch.equal(again, ref.frame())
    # set_state again: the next frame loads the replica from it
    eng.set_state(st)
    assert torch.equal(eng.frame(), first) and eng.state is st


@pytest.mark.parametrize("interleave", [1, 2])
def test_sharded_frame_equals_reference_and_single(single, interleave):
    sharded = engine(sharded=["cpu"] * 4, shard_interleave=interleave)
    for st in (make_state(**CASES["island_night"]), make_state(17.6,
                                                               yaw=315.0)):
        sharded.set_state(st)
        single.set_state(st)
        img = sharded.frame()
        assert torch.equal(img, sharded._frame_eager())
        assert torch.equal(img, single.frame())
        assert sharded.state is st
    # after a sharded step the replicas hold the state the frame renders
    act = random_actions(1, seed=42)[0]
    stepped = sharded.step_and_frame(act, 0.05)
    assert torch.equal(sharded.frame(), stepped)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 11])
def test_fast_forward_chunks_equal_stepping(n):
    acts = random_actions(n, seed=43)
    ff, stepped = engine(), engine()
    st = make_state(7.9)
    ff.set_state(st)
    stepped.set_state(st)
    got = ff.fast_forward(acts, 0.05)
    for a in acts:
        stepped.step(a, 0.05)
    assert got is ff.state and states_equal(got, stepped.state)
    assert set(ff._single.warm) == ({("step", 1)} if n else set())


def test_fast_forward_matches_jax_over_chunk_boundaries():
    acts = random_actions(10, seed=44)   # JAX: two chunks, two single steps
    jeng = JEngine(JConfig(width=32, height=16, sky_source="procedural",
                           procedural_sky_shape=(16, 32), path="fast"))
    jeng.FF_CHUNK = 4
    eng = engine()
    eng.set_state(interop.state_from_numpy(jax_fields(jeng.state)))
    jeng.fast_forward([JAction.idle()._replace(**a._asdict()) for a in acts],
                      1 / 30)
    eng.fast_forward(acts, 1 / 30)
    assert_state_match(jeng.state, eng.state, max_ulp=1)


@pytest.mark.parametrize("kind", ["frame", "preview", "batch"])
def test_sky_cache_off_calls_equal_step_then_frame(kind):
    preview = 2 if kind == "preview" else 1
    eng = engine(sky_cache=False, preview=preview)
    ref = engine(sky_cache=False, preview=preview)
    assert eng.sky_pack is None
    acts = random_actions(3 if kind == "batch" else 1, seed=45)
    st = make_state(9.5)                 # the 8-10 h crossfade
    for e in (eng, ref):
        e.set_state(st)
    if kind == "batch":
        got = eng.step_and_frame_batch(acts, [0.05] * 3)
    elif kind == "preview":
        got = eng.step_and_frame_preview(acts[0], 0.05)
    else:
        got = eng.step_and_frame(acts[0], 0.05)
    want = []
    for a in acts:
        ref.step(a, 0.05)
        want.append(_box_downsample(ref.frame(), preview))
    want = torch.stack(want) if kind == "batch" else want[0]
    assert torch.equal(got, want)
    assert states_equal(eng.state, ref.state)
    assert np.array_equal(eng.frame().numpy(), ref._frame_eager().numpy())
