"""The port's host state machine against the JAX package.

Scripted Action sequences step both packages from the same state, one step
at a time. Tolerances:
  - against eager JAX (every op rounded on its own, as in the port): fields
    built from adds, multiplies, clips and fmod (day_time, sea_y, sky_vars,
    recolor_vars, the angles, the flags) match exactly;
  - against the jitted JAX program (what the JAX Engine runs), XLA's CPU
    backend contracts some multiply-adds into FMAs (e.g. ver + 0.02*dy), so
    those fields match within 1 ulp;
  - fields that pass through sin/cos/tan (camera position after movement,
    light orbit, frustum corners; state.py:125-152) within TRIG_ULP units in
    the last place of the vector's largest component (absolute: cancelling
    sums such as a corner's small component lose relative precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.scene import builders as jb
from raytracing_cuda_tpu.sim import state as jsim
from raytracing_cuda_tpu.sim.actions import Action as JAction
from raytracing_cuda_tpu_torch import interop
from raytracing_cuda_tpu_torch.scene import builders as tb
from raytracing_cuda_tpu_torch.sim import state as tsim
from raytracing_cuda_tpu_torch.sim.actions import Action as TAction

torch.set_num_threads(2)

TRIG_ULP = 4
EXACT = ("day_time", "sea_y", "sky_vars", "recolor_vars", "play", "aa")


def trig_close(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.float32(max(1.0, float(np.max(np.abs(b))))))
    return bool(np.max(np.abs(a - b)) <= TRIG_ULP * scale)


def ulp(a, b) -> int:
    a = np.asarray(a, np.float32).reshape(-1)
    b = np.asarray(b, np.float32).reshape(-1)
    return int(np.max(np.abs(a.view(np.int32).astype(np.int64)
                             - b.view(np.int32)), initial=0))


def jax_fields(st) -> dict:
    d = {k: np.asarray(v) for k, v in st._asdict().items() if k != "cam"}
    d["cam"] = {k: np.asarray(v) for k, v in st.cam._asdict().items()}
    return d


def random_actions(seed: int, n: int):
    """n (field dict, dt) pairs exercising every control."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = dict(
            move_side=np.int32(rng.integers(-1, 2)),
            move_forward=np.int32(rng.integers(-1, 2)),
            move_up=np.int32(rng.integers(-1, 2)),
            run=np.bool_(rng.random() < 0.3),
            mouse_dx=np.float32(rng.normal() * 20),
            mouse_dy=np.float32(rng.normal() * 10),
            time_control=np.int32(rng.integers(-1, 2) if rng.random() < 0.3
                                  else 0),
            set_play=np.bool_(rng.random() < 0.1),
            set_pause=np.bool_(rng.random() < 0.1),
            sea_control=np.int32(rng.integers(-1, 2)),
            time_preset=np.int32(rng.integers(0, 4) if rng.random() < 0.1
                                 else -1),
            cam_preset=np.int32(rng.integers(0, 2) if rng.random() < 0.1
                                else -1),
            set_aa_on=np.bool_(rng.random() < 0.1),
            set_aa_off=np.bool_(rng.random() < 0.1))
        out.append((a, np.float32(rng.uniform(0.005, 0.05))))
    return out


def assert_state_match(jst, tst, max_ulp=0):
    jf, tf = jax_fields(jst), interop.state_to_numpy(tst)
    for k in EXACT:
        if jf[k].dtype == bool:
            assert np.array_equal(jf[k], tf[k]), k
        else:
            assert ulp(jf[k], tf[k]) <= max_ulp, k
    for k in ("hor_angle", "ver_angle", "fov"):
        assert ulp(jf["cam"][k], tf["cam"][k]) <= max_ulp, k
    assert trig_close(tf["cam"]["pos"], jf["cam"]["pos"])


@pytest.mark.parametrize("jitted", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_animate_scripted_matches(seed, jitted):
    animate = jax.jit(jsim.animate) if jitted else jsim.animate
    jst = jsim.settle(jsim.init_state())
    assert_state_match(jst, tsim.settle(tsim.init_state()))
    for a, dt in random_actions(seed, 40):
        tst = interop.state_from_numpy(jax_fields(jst))
        jst = animate(jst, JAction.idle()._replace(**a), jnp.float32(dt))
        tst = tsim.animate(tst, TAction.idle()._replace(**a), dt)
        assert_state_match(jst, tst, max_ulp=1 if jitted else 0)


def test_recolor_lags_one_frame():
    """recolor_vars is the previous frame's sky_vars (state.py:224-236)."""
    st = tsim.settle(tsim.init_state()._replace(day_time=torch.tensor(7.9)))
    st1 = tsim.animate(st, TAction.idle(), 1.0)        # crosses 8 h
    assert torch.equal(st1.recolor_vars, st.sky_vars)
    assert not torch.equal(st1.sky_vars, st.sky_vars)


@pytest.mark.parametrize("day", [0.0, 3.99, 4.0, 5.0, 6.0, 8.0, 9.0, 9.5,
                                 10.0, 16.0, 17.0, 18.0, 20.5, 22.0, 23.99])
def test_calc_sky_vars_and_settle_match(day):
    ref = np.asarray(jsim.calc_sky_vars(jnp.float32(day)))
    assert np.array_equal(tsim.calc_sky_vars(torch.tensor(day)).numpy(), ref)
    jst = jsim.settle(jsim.init_state()._replace(day_time=jnp.float32(day)))
    tst = tsim.settle(tsim.init_state()._replace(day_time=torch.tensor(day)))
    assert_state_match(jst, tst)


@pytest.mark.parametrize("kind", ["island", "classic"])
@pytest.mark.parametrize("day,sea", [(6.0, -4.5), (9.0, 0.0), (17.6, 2.0)])
def test_derive_frame_matches(kind, day, sea):
    build = {"island": (jb.build_scene, tb.build_scene),
             "classic": (jb.build_classic_scene, tb.build_classic_scene)}[kind]
    jst = jsim.settle(jsim.init_state()._replace(
        day_time=jnp.float32(day), sea_y=jnp.float32(sea)))
    tst = interop.state_from_numpy(jax_fields(jst))
    (js, jl, ja) = jsim.derive_frame(build[0](), jst)
    (ts, tl, ta) = tsim.derive_frame(build[1](), tst)
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    for name in ("color", "plane_pos", "tri_v0", "sph_r"):
        assert np.array_equal(getattr(ts, name).numpy(),
                              np.asarray(getattr(js, name))), name
    for name in ("sph_pos", "center"):
        assert trig_close(getattr(ts, name).numpy(),
                          np.asarray(getattr(js, name))), name
    assert trig_close(tl.pos.numpy(), np.asarray(jl.pos))
    assert trig_close(tl.color.numpy(), np.asarray(jl.color))
    assert np.array_equal(tl.intensity.numpy(), np.asarray(jl.intensity))


@pytest.mark.parametrize("aspect", [160 / 96, 1280 / 720, 1.7777])
@pytest.mark.parametrize("cp", [0, 1])
def test_camera_rays_match(cp, aspect):
    jst = jsim.apply_controls(
        jsim.init_state(), JAction.idle()._replace(cam_preset=np.int32(cp)),
        0.0)
    tst = interop.state_from_numpy(jax_fields(jst))
    jr = jsim.camera_rays(jst.cam, aspect)
    tr = tsim.camera_rays(tst.cam, aspect)
    for a, b in zip(jr, tr):
        assert trig_close(b.numpy(), np.asarray(a))


def test_action_pack_matches():
    a = dict(random_actions(5, 1)[0][0])
    jv = JAction.idle()._replace(**a).pack(0.025)
    tv = TAction.idle()._replace(**a).pack(0.025)
    assert np.array_equal(jv, tv)
    back = TAction.unpack(tv)
    assert back.pack(TAction.unpack_dt(tv)).tobytes() == tv.tobytes()
    assert TAction.unpack_dt(tv) == np.float32(0.025)


def test_state_interop_round_trip():
    tst = tsim.settle(tsim.init_state())
    back = interop.state_from_numpy(interop.state_to_numpy(tst))
    for a, b in zip(interop.state_to_numpy(tst).items(),
                    interop.state_to_numpy(back).items()):
        if a[0] == "cam":
            assert all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
        else:
            assert np.array_equal(a[1], b[1]) and a[1].dtype == b[1].dtype


@pytest.mark.parametrize("angle", [-45.0, 0.0, 30.0, 141.2, 309.0])
def test_math3d_matches(angle):
    """to_rad is exact on both paths; rotations within TRIG_ULP; the host
    normalize_np64 bit for bit; normalize within 1 ulp."""
    from raytracing_cuda_tpu.core import math3d as jm
    from raytracing_cuda_tpu_torch.core import math3d as tm

    assert tm.PI == jm.PI
    a32 = np.float32(angle)
    assert tm.to_rad(a32) == jm.to_rad(a32)
    ta = tm.to_rad(torch.tensor(angle))
    assert ta.numpy() == np.asarray(jm.to_rad(jnp.float32(angle)))
    v = np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)
    for tf, jf in ((tm.rot_y, jm.rot_y), (tm.rot_z, jm.rot_z)):
        ref = np.asarray(jf(jnp.asarray(v), jm.to_rad(jnp.float32(angle))))
        assert trig_close(tf(torch.from_numpy(v), ta).numpy(), ref)
        assert np.array_equal(tf(v, jm.to_rad(a32)), jf(v, jm.to_rad(a32)))
    assert ulp(tm.normalize(torch.from_numpy(v)).numpy(),
               np.asarray(jm.normalize(jnp.asarray(v)))) <= 1
    assert np.array_equal(tm.normalize_np64(v[0]), jm.normalize_np64(v[0]))
