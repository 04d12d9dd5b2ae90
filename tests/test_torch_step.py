"""The port's frame step on its device: the tensor-form state step on the
packed action vector, the sky lookup with device weights, FXAA selected by
a tensor flag, and the Engine's state placement and snapshots.

Tolerances, as in tests/test_torch_sim.py: against eager JAX every field
built from adds, multiplies, clips, fmod and where (day_time, sea_y,
sky_vars, recolor_vars, play, aa, fov, the angles) matches exactly; against
the jitted JAX step (what the JAX Engine runs) XLA's CPU code contracts
multiply-adds such as ver + 0.02·dy into FMAs, so the angles match within
1 ulp; the camera position, which passes through cos/sin, within TRIG_ULP
units in the last place of its largest component. The sky lookup with
device weights equals the host-branch lookup bit for bit, and FXAA's tensor
toggle equals the host toggle bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.sim import state as jsim
from raytracing_cuda_tpu.sim.actions import Action as JAction
from raytracing_cuda_tpu_torch import interop
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.render import fxaa as tfx
from raytracing_cuda_tpu_torch.scene import textures as ttx
from raytracing_cuda_tpu_torch.sim import state as tsim
from raytracing_cuda_tpu_torch.sim.actions import Action as TAction
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from tests.test_torch_sim import (jax_fields, random_actions, trig_close,
                                  ulp)

torch.set_num_threads(2)

H, W = 96, 160
SKY = (64, 128)
EXACT = ("day_time", "sea_y", "sky_vars", "recolor_vars", "play", "aa")


@pytest.fixture(scope="module")
def jax_step():
    """JAX's jitted step on a packed vector, as the JAX Engine runs it
    (loop.py:211-217), and its eager form."""
    def step(st, av):
        return jsim.animate(st, JAction.unpack(av), JAction.unpack_dt(av))

    return jax.jit(step), step


def stream(seed: int, n: int) -> np.ndarray:
    """n packed actions: random_actions' fields, then presets out of range
    (time 4..9, camera 2..5), scrubs both ways, pauses and plays, sea
    moves and moves with and without run."""
    rng = np.random.default_rng(seed)
    vecs = []
    for a, dt in random_actions(seed, n):
        r = rng.random()
        if r < 0.08:
            a["time_preset"] = np.int32(rng.integers(4, 10))
        elif r < 0.16:
            a["cam_preset"] = np.int32(rng.integers(2, 6))
        vecs.append(TAction.idle()._replace(**a).pack(dt))
    return np.stack(vecs)


def assert_step_match(jst, tst, angle_ulp: int):
    jf, tf = jax_fields(jst), interop.state_to_numpy(tst)
    for k in EXACT:
        if jf[k].dtype == bool:
            assert np.array_equal(jf[k], tf[k]), k
        else:
            assert ulp(jf[k], tf[k]) == 0, k
    assert ulp(jf["cam"]["fov"], tf["cam"]["fov"]) == 0
    for k in ("hor_angle", "ver_angle"):
        assert ulp(jf["cam"][k], tf["cam"][k]) <= angle_ulp, k
    assert trig_close(tf["cam"]["pos"], jf["cam"]["pos"])


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_step_matches_jax_over_200_actions(jax_step, seed):
    """animate_packed against JAX's step on Action.unpack(av), each step
    from the same state: exact against eager JAX, the angles within 1 ulp
    of the jitted program."""
    jitted, eager = jax_step
    vecs = stream(seed, 200)
    fields = (vecs[:, tsim.A_TIME_PRESET], vecs[:, tsim.A_CAM_PRESET])
    assert (fields[0] > 3).any() and (fields[1] > 1).any()
    assert (vecs[:, tsim.A_TIME] != 0).any() and (vecs[:, tsim.A_RUN] > 0).any()
    jst = jsim.settle(jsim.init_state())
    for av in vecs:
        tst = interop.state_from_numpy(jax_fields(jst))
        got = tsim.animate_packed(tst, torch.from_numpy(av))
        assert_step_match(eager(jst, av), got, angle_ulp=0)
        jst = jitted(jst, av)
        assert_step_match(jst, got, angle_ulp=1)


def test_packed_step_equals_action_step():
    """The Action form packs on the host and runs the same tensor step."""
    st = tsim.settle(tsim.init_state())
    for av in stream(2, 40):
        a, dt = TAction.unpack(av), TAction.unpack_dt(av)
        want = tsim.animate_packed(st, torch.from_numpy(av))
        got = tsim.animate(st, a, dt)
        assert all(torch.equal(x, y) for x, y in
                   zip(tsim.state_tensors(want), tsim.state_tensors(got)))
        st = want


def host_branch_pair(packed_all, h, w, d, day_frac, sky_vars):
    """The lookup as it was with the weights on the host: numpy argmax,
    one gather where one panorama is pure, two in a crossfade."""
    iy, ix = ttx._equirect_indices(h, w, d, float(np.float32(day_frac)))
    idx = (iy * w + ix).to(torch.int64)
    sv = np.asarray(sky_vars, np.float32)
    ia = int(np.argmax(sv))
    masked = np.where(np.arange(4) == ia, np.float32(-1.0), sv)
    ib = int(np.argmax(masked))
    wa, wb = np.float32(sv[ia]), np.float32(max(masked[ib], 0.0))
    ta = packed_all[ia][idx]
    if wb > 0:
        tb = packed_all[ib][idx]
        rgb = torch.stack(
            [torch.floor(((ta >> s) & 0xFF).to(torch.float32) * float(wa))
             + torch.floor(((tb >> s) & 0xFF).to(torch.float32) * float(wb))
             for s in (0, 8, 16)], dim=-1)
    else:
        rgb = ttx._unpack_rgb(ta)
    return rgb * ttx._INV_255


@pytest.mark.parametrize("day", [14.0, 9.0, 17.25])
def test_pair_lookup_with_device_weights_equals_host_branch(day):
    """A pure band (14 h: wb = 0, one gather before) and two crossfades:
    the device form always fetches both panoramas and equals the host
    branch bit for bit."""
    packed = ttx.pack_sky_all(torch.from_numpy(ttx.procedural_skies(*SKY)))
    rng = np.random.default_rng(3)
    d = torch.from_numpy(rng.standard_normal((40, 50, 3)).astype(np.float32))
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    day_t = torch.tensor(np.float32(day))
    sv = tsim.calc_sky_vars(day_t)
    day_frac = day_t / 24.0
    ia, ib, wa, wb = ttx.sky_blend_bands(sv)
    assert (float(wb) == 0.0 and float(wa) == 1.0) == (day == 14.0)
    got = ttx.sample_sky_packed_pair(packed, *SKY, d, day_frac, sv)
    want = host_branch_pair(packed, *SKY, d, float(day_frac), sv.numpy())
    assert torch.equal(got, want)
    batch = ttx.sample_sky_packed_pair_batch(
        packed, *SKY, torch.stack([d, d.flip(0)]), torch.stack([day_frac] * 2),
        torch.stack([sv, sv]))
    assert torch.equal(batch[0], want)


def test_apply_fxaa_tensor_flag():
    """A bool tensor selects on the device: the filtered frame where it is
    on, the base where it is off; (K,) flags select per frame."""
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(rng.integers(0, 256, (3, 24, 32, 3),
                                         dtype=np.uint8))
    on, off = torch.tensor(True), torch.tensor(False)
    assert torch.equal(tfx.apply_fxaa(imgs[0], on), tfx.fxaa_torch(imgs[0]))
    assert torch.equal(tfx.apply_fxaa(imgs[0], off), imgs[0])
    flags = torch.tensor([True, False, True])
    got = tfx.apply_fxaa(imgs, flags)
    for k in range(3):
        want = tfx.fxaa_torch(imgs[k]) if flags[k] else imgs[k]
        assert torch.equal(got[k], want)


def small_engine(**kw) -> Engine:
    return Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY,
                               **kw), device="cpu")


def test_engine_keeps_scene_state_and_cull_table_on_its_device():
    eng = small_engine()
    dev = eng.device
    assert all(t.device == dev for t in eng.scene)
    assert all(t.device == dev for t in tsim.state_tensors(eng.state))
    assert eng.cull.device == dev and eng.cull.dtype == torch.int32
    eng.set_state(tsim.settle(tsim.init_state()))
    eng.step_and_frame()
    assert all(t.device == dev for t in tsim.state_tensors(eng.state))


def test_state_snapshot_survives_steps_and_run_restores_it():
    """A state read before step_and_frame is unchanged after it, and
    run() times its frames from the state it started from (its warm-up
    frames are undone)."""
    eng = small_engine()
    before = eng.state
    kept = tsim.clone_state(before)
    act = TAction.idle()._replace(move_forward=np.int32(1),
                                  mouse_dx=np.float32(5.0),
                                  time_control=np.int32(1))
    eng.step_and_frame(act, 0.05)
    eng.step_and_frame_batch([act] * 2, [0.05] * 2)
    eng.step_and_frame_preview(act, 0.05)
    assert all(torch.equal(a, b) for a, b in
               zip(tsim.state_tensors(before), tsim.state_tensors(kept)))
    assert not torch.equal(eng.state.day_time, before.day_time)
    ref = small_engine()
    ref.set_state(tsim.clone_state(eng.state))
    eng.run(3, action_fn=lambda i: act, dt=0.05)     # after 2 warm-up frames
    for _ in range(3):
        ref.step(act, 0.05)
    assert all(torch.equal(a, b) for a, b in
               zip(tsim.state_tensors(eng.state), tsim.state_tensors(ref.state)))


def test_engine_step_frame_equals_step_then_frame():
    """The device step of one call (one frame, K frames, the preview)
    equals the state step followed by the frame of the new state, and
    fast_forward the same steps."""
    a, b = small_engine(preview=2), small_engine(preview=2)
    acts = [TAction.idle()._replace(mouse_dx=np.float32(3.0 * i),
                                    time_control=np.int32(i % 2),
                                    set_aa_off=np.bool_(i == 1))
            for i in range(4)]
    for act in acts[:2]:
        img = a.step_and_frame(act, 0.1)
        b.step(act, 0.1)
        assert torch.equal(img, b.frame())
    small = a.step_and_frame_preview(acts[2], 0.1)
    b.step(acts[2], 0.1)
    assert torch.equal(small, tsim_box(b.frame(), 2))
    c = small_engine()
    c.set_state(a.state)
    c.fast_forward(acts, 0.1)
    for act in acts:
        a.step(act, 0.1)
    assert all(torch.equal(x, y) for x, y in
               zip(tsim.state_tensors(a.state), tsim.state_tensors(c.state)))


def tsim_box(img, n):
    from raytracing_cuda_tpu_torch.utils.images import box_downsample

    return torch.from_numpy(box_downsample(img, n))
