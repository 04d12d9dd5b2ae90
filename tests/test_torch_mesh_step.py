"""The port's multi-device step on the CPU: every mesh entry steps its own
replica of the state and renders its rows with no exchange (meshes of
["cpu"] * n, plain kernels), as each entry's CUDA graph does on a card.

  - parallel.mesh.entry_bands (each chunk with its two halo rows
    recomputed) gathered by place_bands against the single-device frames
    of the same packs (frames_from_packs), bit for bit (torch.equal), for
    n in {2, 4, 8} at interleave 2 (and n = 4 at 1), FXAA on and off,
    K = 1 and 3;
  - a sharded Engine on ["cpu"] * 4 over 24 actions with a camera preset,
    FXAA toggles, set_state, fast_forward, a batch, a preview and resized:
    every frame equal to the unsharded Engine's bit for bit, and every
    replica equal to the unsharded Engine's state after every call;
  - Engine.render_script_dp on ["cpu"] * 2 and on a 2 x 2 hybrid: frames
    and end state equal to 16 step_and_frame calls, bit for bit;
  - one sharded Engine frame against the JAX render_frame_sharded
    (interpret mode, flat sky pack; the fixtures of test_torch_parallel.py)
    under the golden contract of tests/test_golden.py:82-86: RMSE < 2e-3
    and < 0.3 % of pixels off by more than 2 levels.

Widths are multiples of 16 (ATen's vectorised CPU asin/atan2 round a
tensor's scalar tail differently), so a band of chunk + 2 rows renders the
frame's rows bit for bit.
"""

import numpy as np
import pytest
import torch

from chip_smoke import states_equal, toggling_actions
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.parallel import mesh as M
from raytracing_cuda_tpu_torch.render.pipeline import (batch_packs,
                                                       frames_from_packs)
from raytracing_cuda_tpu_torch.sim import state as tsim
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from test_torch_parallel import H as SMALL_H, SKY as SMALL_SKY, W as SMALL_W
from test_torch_parallel import (golden_ok, jax_sharded,  # noqa: F401
                                 single, start)           # (fixtures)

torch.set_num_threads(2)

H, W = 96, 160
SKY = (64, 128)


def engine(sharded=False, **kw) -> Engine:
    return Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY,
                               **kw), device="cpu", sharded=sharded)


def replicas(eng: Engine) -> list:
    return eng._replicas[tuple(eng.mesh)].live


@pytest.fixture(scope="module")
def base_engine():
    return engine()


@pytest.fixture(scope="module")
def packs(base_engine):
    """Three frames' packs and states from a clock in the 8-10 h
    crossfade (two panoramas per texel), on the CPU."""
    eng = base_engine
    eng.set_state(tsim.settle(eng.state._replace(
        day_time=torch.tensor(8.5))))
    vecs = np.stack([a.pack(0.2) for a in toggling_actions(3, seed=31)])
    return batch_packs(eng.scene, eng.state, vecs, H, W, None,
                       eng.tri_clusters, eng.sph_clusters, eng.tri_subs,
                       eng.cull)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("aa", [True, False])
@pytest.mark.parametrize("n,interleave", [(2, 2), (4, 2), (8, 2), (4, 1)])
def test_entry_bands_equal_single_device_frames(base_engine, packs, n,
                                                interleave, aa, K):
    eng = base_engine
    coefs, params, nt, ns, cull, states = packs
    states = [st._replace(aa=torch.tensor(aa)) for st in states[:K]]
    coefs, params = coefs[:K], params[:K]
    want = frames_from_packs(coefs, params, nt, ns, eng.sky_pack, eng.sky_h,
                             eng.sky_w, states, H, W, cull)
    got = torch.empty_like(want)
    sub = H // (n * interleave)
    for e in range(n):
        bands = M.entry_bands(coefs, params, nt, ns, states, eng.sky_pack,
                              eng.sky_h, eng.sky_w, entry=e, n=n, height=H,
                              width=W, interleave=interleave, cull=cull)
        assert bands.shape == (K, interleave, sub, W, 3)
        M.place_bands(got, bands, e, n)
    assert torch.equal(got, want), (
        f"{(got != want).any(-1).float().mean():.4%} pixels differ")


@pytest.mark.parametrize("interleave", [1, 2])
def test_sharded_engine_follows_the_single_engine(interleave):
    """24 actions through the sharded and the unsharded Engine: frames bit
    for bit, and each of the four replicas equal to the unsharded state
    after every call; set_state, fast_forward and resized write every
    replica."""
    single = engine(preview=2)
    sharded = engine(sharded=["cpu"] * 4, shard_interleave=interleave,
                     preview=2)
    acts = toggling_actions(24, seed=32)
    dts = [0.05 + 0.02 * (i % 3) for i in range(24)]

    def same(kind, *args):
        a, b = (getattr(e, kind)(*args) for e in (single, sharded))
        assert torch.equal(a, b), kind
        for live in replicas(sharded):
            assert states_equal(live, single.state), kind
        assert states_equal(sharded.state, single.state)

    for i in range(8):
        same("step_and_frame", acts[i], dts[i])
    st = single.state._replace(day_time=torch.tensor(17.6),
                               sea_y=torch.tensor(0.5))
    for e in (single, sharded):
        e.set_state(st)
    same("step_and_frame_batch", acts[8:12], dts[8:12])
    for e in (single, sharded):
        e.fast_forward(acts[12:15], 0.05)
    same("step_and_frame_preview", acts[15], dts[15])
    for i in range(16, 20):
        same("step_and_frame", acts[i], dts[i])
    single, sharded = single.resized(W, H // 2), sharded.resized(W, H // 2)
    assert sharded.mesh == [torch.device("cpu")] * 4
    for i in range(20, 24):
        same("step_and_frame", acts[i], dts[i])
    # the replicas are copies of their own, not views of one another
    ptrs = [t.data_ptr() for live in replicas(sharded)
            for t in tsim.state_tensors(live)]
    assert len(set(ptrs)) == len(ptrs)


@pytest.fixture(scope="module")
def script():
    """16 actions, the start state, 16 step_and_frame frames and the end
    state."""
    eng = engine(shard_interleave=2)
    acts = toggling_actions(16, seed=33)
    st0 = eng.state
    frames = torch.stack([eng.step_and_frame(a, 1 / 30) for a in acts])
    return acts, st0, frames, eng.state


@pytest.mark.parametrize("label,kw", [
    ("dp", dict(mesh=["cpu"] * 2)),
    ("hybrid", dict(n_rows=2, mesh=[["cpu"] * 2] * 2))])
def test_render_script_dp_equals_step_and_frame(script, label, kw):
    acts, st0, frames, end = script
    eng = engine(shard_interleave=2)
    eng.set_state(st0)
    imgs = eng.render_script_dp(acts, dt=1 / 30, **kw)
    assert torch.equal(imgs, frames), label
    assert states_equal(eng.state, end), label
    flat = [torch.device("cpu")] * (2 if label == "dp" else 4)
    for live in eng._replicas[tuple(flat)].live:
        assert states_equal(live, end), label


def test_sharded_engine_frame_against_jax(start, single, jax_sharded):
    """The start state through the sharded Engine's step (an idle step of
    dt 0 keeps it) against the JAX row-sharded frame and the port's
    single-device frame."""
    _, tst, _ = start
    eng = Engine(RenderConfig(width=SMALL_W, height=SMALL_H,
                              procedural_sky_shape=SMALL_SKY), device="cpu",
                 sharded=["cpu"] * 4)
    eng.set_state(tst)
    img = eng.step_and_frame(Action.idle(), 0.0)
    assert torch.equal(img, single[True])
    golden_ok(img.numpy(), jax_sharded[True])
