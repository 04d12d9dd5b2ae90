"""The port's window (app/window.py) and preview path on the CPU.

  - `_box_downsample`, the device twin of utils.images.box_downsample,
    against it and against the JAX package's (loop.py:30-40), bit for bit,
    a saturated box included; `step_and_frame_preview` against the box
    downsample of the full frame of the same state;
  - `poll_action`: the cases of tests/test_window_input.py with a stand-in
    for the pygame module;
  - `Readback` on CPU frames hands each frame back one submit late, in
    order;
  - `run_window` with SDL_VIDEODRIVER=dummy on device "cpu": the smoke
    cases of tests/test_window_smoke.py (frames, F5 / resize / F9, a bad
    checkpoint, F12, preview=2), behind pytest.importorskip("pygame").
"""

import dataclasses
import glob
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.app.loop import _box_downsample as jax_box_downsample
from chip_smoke import make_state
from raytracing_cuda_tpu_torch.app import window as win
from raytracing_cuda_tpu_torch.app.loop import Engine, _box_downsample
from raytracing_cuda_tpu_torch.app.window import Readback, poll_action
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils.checkpoint import load_state
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.images import box_downsample, load_png

torch.set_num_threads(2)

CFG = RenderConfig(width=64, height=48, procedural_sky_shape=(16, 32))


# --- the preview downsample ---


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
def test_box_downsample_matches_host_twin(n):
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (24, 36, 3)).astype(np.uint8)
    img[:6, :6] = 255    # a saturated box: mean + 0.5 = 255.5 stays 255
    got = _box_downsample(torch.from_numpy(img), n)
    assert got.dtype == torch.uint8
    assert got.shape == (24 // n, 36 // n, 3)
    assert np.array_equal(got.numpy(), box_downsample(img, n))
    assert got[0, 0].tolist() == [255, 255, 255]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_box_downsample_matches_jax(n):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
    img[-4:, -4:] = 255
    assert np.array_equal(
        _box_downsample(torch.from_numpy(img), n).numpy(),
        np.asarray(jax_box_downsample(jnp.asarray(img), n)))


def test_box_downsample_one_is_a_passthrough():
    img = torch.zeros(4, 4, 3, dtype=torch.uint8)
    assert _box_downsample(img, 1) is img


@pytest.mark.parametrize("preview,path", [(2, "auto"), (4, "auto"),
                                          (2, "fast")])
def test_step_and_frame_preview(preview, path):
    cfg = dataclasses.replace(CFG, preview=preview, path=path, chunk=1024)
    eng = Engine(cfg, "cpu")
    full = Engine(dataclasses.replace(cfg, preview=1), "cpu")
    st = make_state(day=14.0)
    act = Action.idle()._replace(mouse_dx=np.float32(12.0))
    eng.set_state(st)
    full.set_state(st)
    small = eng.step_and_frame_preview(act, 0.05)
    assert small.shape == (48 // preview, 64 // preview, 3)
    assert small.dtype == torch.uint8
    assert np.array_equal(small.numpy(),
                          box_downsample(full.step_and_frame(act, 0.05),
                                         preview))
    assert torch.equal(eng.state.day_time, full.state.day_time)


def test_preview_must_divide_framebuffer():
    with pytest.raises(ValueError, match="preview"):
        dataclasses.replace(CFG, preview=7)   # 64 % 7 != 0


# --- key state → Action ---


class _StubPygame:
    """Minimal stand-in for the pygame module: key constants + state."""

    def __init__(self, held=(), rel=(0, 0)):
        names = ("K_a K_b K_d K_e K_o K_p K_q K_s K_v K_w "
                 "K_LSHIFT K_RSHIFT K_LEFT K_RIGHT K_UP K_DOWN "
                 "K_1 K_2 K_3 K_4 K_5 K_6").split()
        for i, n in enumerate(names):
            setattr(self, n, i)
        pressed = [False] * 64
        for n in held:
            pressed[getattr(self, n)] = True
        self.key = type("K", (), {"get_pressed": staticmethod(lambda: pressed)})
        self.mouse = type("M", (), {"get_rel": staticmethod(lambda: rel)})


def test_idle_maps_to_idle():
    a = poll_action(_StubPygame(), grab=True)
    assert int(a.move_side) == 0 and int(a.move_forward) == 0
    assert int(a.time_preset) == -1 and int(a.cam_preset) == -1
    assert not bool(a.run) and not bool(a.set_aa_on)
    assert a.pack(1 / 60).tolist() == Action.idle().pack(1 / 60).tolist()


def test_movement_axes():
    a = poll_action(_StubPygame(held=("K_w", "K_d", "K_q", "K_LSHIFT")),
                    grab=True)
    assert int(a.move_forward) == 1 and int(a.move_side) == 1
    assert int(a.move_up) == 1 and bool(a.run)
    a = poll_action(_StubPygame(held=("K_s", "K_a", "K_e")), grab=True)
    assert int(a.move_forward) == -1 and int(a.move_side) == -1
    assert int(a.move_up) == -1


def test_opposing_keys_cancel():
    a = poll_action(_StubPygame(held=("K_w", "K_s", "K_LEFT", "K_RIGHT")),
                    grab=True)
    assert int(a.move_forward) == 0 and int(a.time_control) == 0


def test_time_and_sea_controls():
    a = poll_action(_StubPygame(held=("K_RIGHT", "K_UP")), grab=True)
    assert int(a.time_control) == 1 and int(a.sea_control) == 1
    a = poll_action(_StubPygame(held=("K_LEFT", "K_DOWN")), grab=True)
    assert int(a.time_control) == -1 and int(a.sea_control) == -1


def test_presets_and_toggles():
    a = poll_action(_StubPygame(held=("K_3", "K_6", "K_b", "K_o", "K_p")),
                    grab=True)
    assert int(a.time_preset) == 2          # key 3 → preset index 2
    assert int(a.cam_preset) == 1           # key 6 → mountains
    assert bool(a.set_aa_on) and bool(a.set_play) and bool(a.set_pause)


def test_mouse_rel_only_when_grabbed():
    a = poll_action(_StubPygame(rel=(7, -3)), grab=True)
    assert float(a.mouse_dx) == 7.0 and float(a.mouse_dy) == -3.0
    a = poll_action(_StubPygame(rel=(7, -3)), grab=False)
    assert float(a.mouse_dx) == 0.0


def test_action_pack_roundtrip():
    a = poll_action(_StubPygame(held=("K_w", "K_2", "K_v"), rel=(5, 2)),
                    grab=True)
    vec = a.pack(dt=1 / 30)
    back = Action.unpack(vec)
    assert int(back.move_forward) == 1
    assert int(back.time_preset) == 1
    assert bool(back.set_aa_off)
    assert abs(float(Action.unpack_dt(vec)) - 1 / 30) < 1e-7


# --- the readback ring ---


def test_readback_hands_cpu_frames_back_in_order():
    ring = Readback()
    frames = [torch.full((4, 6, 3), i, dtype=torch.uint8) for i in range(5)]
    got = [ring.submit(f) for f in frames]
    assert got[0] is None
    assert all(g is f for g, f in zip(got[1:], frames))   # the tensor itself
    assert ring.flush() is frames[-1]
    assert ring.flush() is None and ring.submit(frames[0]) is None


def test_readback_survives_a_resize():
    ring = Readback()
    small, big = (torch.zeros(4, 6, 3, dtype=torch.uint8),
                  torch.ones(8, 12, 3, dtype=torch.uint8))
    ring.submit(small)
    assert ring.flush() is small          # dropped at the resize
    assert ring.submit(big) is None and ring.submit(small) is big


def test_window_module_imports_without_pygame(monkeypatch):
    """pygame is imported inside run_window only."""
    monkeypatch.setitem(sys.modules, "pygame", None)
    with pytest.raises(ImportError, match="pygame"):
        win.run_window(CFG, "cpu", max_frames=1)


# --- run_window with no display (SDL_VIDEODRIVER=dummy) ---


@pytest.fixture
def pygame(monkeypatch, tmp_path):
    pg = pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    monkeypatch.chdir(tmp_path)        # checkpoints and screenshots land here
    return pg


def queue_at_init(monkeypatch, pygame, events):
    orig_init = pygame.init

    def init_and_queue():
        out = orig_init()
        for ev in events:
            pygame.event.post(ev)
        return out

    monkeypatch.setattr(pygame, "init", init_and_queue)


def test_run_window_renders_frames(pygame):
    assert win.run_window(CFG, "cpu", max_frames=2) == 2


def test_run_window_blits_the_previous_frame(pygame, monkeypatch):
    """Frame i is blitted at iteration i + 1: the surfaces made hold the
    frames the Engine rendered, in order, one late."""
    rendered, shown = [], []
    orig_step = Engine.step_and_frame

    def spy_step(self, action=None, dt=1 / 60):
        rendered.append(orig_step(self, action, dt))
        return rendered[-1]

    orig_make = pygame.surfarray.make_surface

    def spy_make(array):
        shown.append(np.array(array).transpose(1, 0, 2))
        return orig_make(array)

    monkeypatch.setattr(Engine, "step_and_frame", spy_step)
    monkeypatch.setattr(pygame.surfarray, "make_surface", spy_make)
    assert win.run_window(CFG, "cpu", max_frames=4) == 4
    assert len(rendered) == 4 and len(shown) == 3
    assert all(np.array_equal(s, r.numpy()) for s, r in zip(shown, rendered))


def test_run_window_checkpoint_and_resize_events(pygame, monkeypatch):
    """F5 (save), a VIDEORESIZE, then F9 (load) through the real loop; the
    resize is applied on the next frame (resize_settle_s=0) and the engine
    rebuilt at the new size."""
    sizes = []
    orig_resized = Engine.resized

    def spy_resized(self, w, h):
        sizes.append((w, h))
        return orig_resized(self, w, h)

    monkeypatch.setattr(Engine, "resized", spy_resized)
    queue_at_init(monkeypatch, pygame, [
        pygame.event.Event(pygame.KEYDOWN, key=pygame.K_F5),
        pygame.event.Event(pygame.VIDEORESIZE, w=96, h=64),
        pygame.event.Event(pygame.KEYDOWN, key=pygame.K_F9)])
    st = make_state(day=17.5, cp=1)
    assert win.run_window(CFG, "cpu", max_frames=3, resize_settle_s=0.0,
                          initial_state=st) == 3
    assert sizes == [(96, 64)]
    saved = load_state(win.CHECKPOINT)
    assert torch.equal(saved.day_time, st.day_time)
    assert torch.equal(saved.cam.pos, st.cam.pos)


def test_run_window_resize_snaps_to_preview(pygame, monkeypatch):
    sizes = []
    orig_resized = Engine.resized

    def spy_resized(self, w, h):
        sizes.append((w, h))
        return orig_resized(self, w, h)

    monkeypatch.setattr(Engine, "resized", spy_resized)
    queue_at_init(monkeypatch, pygame,
                  [pygame.event.Event(pygame.VIDEORESIZE, w=99, h=67)])
    cfg = dataclasses.replace(CFG, preview=4)
    assert win.run_window(cfg, "cpu", max_frames=3,
                          resize_settle_s=0.0) == 3
    assert sizes == [(96, 64)]


def test_run_window_skips_a_bad_checkpoint(pygame, monkeypatch, capsys):
    with open(win.CHECKPOINT, "w") as f:
        f.write("{not json")
    queue_at_init(monkeypatch, pygame,
                  [pygame.event.Event(pygame.KEYDOWN, key=pygame.K_F9)])
    assert win.run_window(CFG, "cpu", max_frames=2) == 2
    assert "checkpoint load skipped" in capsys.readouterr().out


def test_run_window_screenshot_key(pygame, monkeypatch):
    """F12 saves a full-size PNG of the current state, whatever the
    preview, under a name that does not collide."""
    queue_at_init(monkeypatch, pygame, [
        pygame.event.Event(pygame.KEYDOWN, key=pygame.K_F12),
        pygame.event.Event(pygame.KEYDOWN, key=pygame.K_F12)])
    cfg = dataclasses.replace(CFG, preview=2)
    st = make_state(day=14.0)
    assert win.run_window(cfg, "cpu", max_frames=2, initial_state=st) == 2
    shots = sorted(glob.glob("screenshot_*.png"))
    assert len(shots) == 2
    eng = Engine(CFG, "cpu")
    eng.set_state(st)
    for shot in shots:
        assert np.array_equal(load_png(shot), eng.frame_np())


@pytest.mark.parametrize("kw", [dict(preview=2), dict(path="fast",
                                                      chunk=1024)],
                         ids=["preview2", "fast"])
def test_run_window_other_configs(pygame, kw):
    """preview=2: full-size render, 1/2-size readback, upscaled in the
    blit; and the loop on the `fast` path."""
    assert win.run_window(dataclasses.replace(CFG, **kw), "cpu",
                          max_frames=2) == 2


def test_run_window_quits_on_escape(pygame, monkeypatch):
    queue_at_init(monkeypatch, pygame,
                  [pygame.event.Event(pygame.KEYDOWN, key=pygame.K_ESCAPE)])
    # the iteration that reads the key still renders its frame
    assert win.run_window(CFG, "cpu", max_frames=50) == 1
    assert not os.path.exists(win.CHECKPOINT)
