"""The port's `state-v1` checkpoints: exact round trips within the port and
across packages (a state saved by one package loads in the other with every
field bit-identical), and the JAX package's validation, case for case."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.sim import state as jsim
from raytracing_cuda_tpu.utils import checkpoint as jck
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.sim import state as tsim
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils import checkpoint as tck
from raytracing_cuda_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)


def port_state():
    st = tsim.settle(tsim.init_state()._replace(
        day_time=torch.tensor(17.25), sea_y=torch.tensor(-2.0),
        aa=torch.tensor(False)))
    # an animated step: recolor_vars lags sky_vars, the pose is off-preset
    return tsim.animate(st, Action.idle()._replace(
        mouse_dx=np.float32(13.7), move_forward=np.int32(1),
        time_control=np.int32(1)), 0.37)


def jax_state():
    st = jsim.settle(jsim.init_state()._replace(
        day_time=jnp.float32(9.3), sea_y=jnp.float32(1.5)))
    return st._replace(cam=st.cam._replace(hor_angle=jnp.float32(123.456)))


def fields(st) -> dict:
    """Either package's state → flat dict of numpy arrays."""
    d = {k: np.asarray(v) for k, v in st._asdict().items() if k != "cam"}
    d.update({f"cam.{k}": np.asarray(v) for k, v in st.cam._asdict().items()})
    return d


def assert_same(a, b):
    fa, fb = fields(a), fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert np.array_equal(fa[k], fb[k]), k


def test_roundtrip_values(tmp_path):
    st = port_state()
    p = str(tmp_path / "state.json")
    tck.save_state(st, p)
    assert_same(st, tck.load_state(p))
    assert not torch.equal(st.sky_vars, st.recolor_vars)   # mid-crossfade


def test_jax_save_port_load(tmp_path):
    st = jax_state()
    p = str(tmp_path / "jax.json")
    jck.save_state(st, p)
    back = tck.load_state(p)
    assert_same(st, back)
    with open(p) as f:
        assert tck.state_to_dict(back) == json.load(f)


def test_port_save_jax_load(tmp_path):
    st = port_state()
    p = str(tmp_path / "port.json")
    tck.save_state(st, p)
    back = jck.load_state(p)
    fb, ft = fields(back), fields(st)
    for k in ft:
        assert np.array_equal(fb[k], ft[k]), k
    assert jck.state_to_dict(back) == tck.state_to_dict(st)


def test_roundtrip_renders_identically(tmp_path):
    eng = Engine(RenderConfig(width=40, height=24,
                              procedural_sky_shape=(32, 64)), "cpu")
    eng.set_state(port_state())
    a = eng.frame_np()
    p = str(tmp_path / "state.json")
    tck.save_state(eng.state, p)
    eng.set_state(tck.load_state(p))
    assert np.array_equal(a, eng.frame_np())


def _malformed(d):
    """(id, document) pairs: tests/test_checkpoint.py and
    tests/test_config_validation.py's cases, plus missing and mistyped
    fields."""
    cam = d["camera"]
    return [
        ("format_nope", {"format": "nope"}),
        ("format_other", dict(d, format="something-else")),
        ("sky_vars_3", dict(d, sky_vars=[0.0, 1.0, 0.0])),
        ("recolor_vars_5", dict(d, recolor_vars=[1.0] * 5)),
        ("pos_2", dict(d, camera=dict(cam, pos=[0.0, 1.0]))),
        ("pos_text", dict(d, camera=dict(cam, pos="abc"))),
        ("no_camera", {k: v for k, v in d.items() if k != "camera"}),
        ("no_fov", dict(d, camera={k: v for k, v in cam.items()
                                   if k != "fov"})),
        ("no_day_time", {k: v for k, v in d.items() if k != "day_time"}),
        ("camera_null", dict(d, camera=None)),
        ("not_an_object", [d]),
    ]


CASES = _malformed(jck.state_to_dict(jsim.init_state()))


@pytest.mark.parametrize("doc", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_malformed_documents_raise_value_error(doc, tmp_path):
    with pytest.raises(ValueError):
        jck.state_from_dict(doc)          # the reference refuses it too
    with pytest.raises(ValueError):
        tck.state_from_dict(doc)
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(doc))
    with pytest.raises(ValueError):
        tck.load_state(str(p))


def test_format_is_shared():
    assert tck.FORMAT == jck.FORMAT == "raytracing_cuda_tpu/state-v1"
