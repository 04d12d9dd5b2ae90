"""The port's command line, `python -m raytracing_cuda_tpu_torch`, on the CPU.

The batching, resume and SSAA cases of tests/test_cli.py, rewritten for
`record`'s fixed RECORD_BATCH split (full step_and_frame_batch batches,
then the tail frame by frame) with the renders stubbed to index-tagged
images; then unstubbed runs on `--path plain` held against the Engine
(bit for bit) and against the JAX CLI (the golden contract of
tests/test_golden.py:82-86).
"""

import ast
import os
import sys

import numpy as np
import pytest
import torch

from chip_smoke import GOLDEN_OFF_FRAC, GOLDEN_RMSE, golden_stats
from raytracing_cuda_tpu.__main__ import main as jax_main
from raytracing_cuda_tpu.utils.images import box_downsample as jax_box
from raytracing_cuda_tpu_torch import __main__ as cli
from raytracing_cuda_tpu_torch.__main__ import (RECORD_DT, main,
                                                scripted_action)
from raytracing_cuda_tpu_torch.app import loop as loop_mod
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.sim import state as tsim
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils.checkpoint import save_state
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.images import (box_downsample, load_png,
                                                    save_png)

torch.set_num_threads(2)

SMALL = ["--size", "160x96", "--sky-shape", "128x64"]
STUB = ["--size", "128x64", "--sky-shape", "64x32", "--path", "plain"]


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """The JAX CLI re-applies JAX_PLATFORMS from the environment; keep it
    on the CPU backend that tests/conftest.py forced (tests/test_cli.py)."""
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)


def _tag_img(i, h=64, w=128):
    img = np.zeros((h, w, 3), np.uint8)
    img[0, 0, 0] = i
    return img


def cli_engine() -> Engine:
    """The Engine main() builds for SMALL --path plain."""
    return Engine(RenderConfig(width=160, height=96, sky_source="auto",
                               procedural_sky_shape=(64, 128)), "cpu")


def test_record_batches_and_tail(tmp_path, monkeypatch):
    """10 frames: one RECORD_BATCH = 8 batch, then two single-frame steps,
    every frame landing at its own script index."""
    calls = []

    def fake_batch(self, actions, dts=None):
        assert len(actions) == len(dts) == cli.RECORD_BATCH
        assert all(dt == RECORD_DT for dt in dts)
        calls.append(("batch", len(actions)))
        start = sum(c[1] for c in calls[:-1])
        return np.stack([_tag_img(start + j) for j in range(len(actions))])

    def fake_step(self, action, dt):
        calls.append(("seq", 1))
        return _tag_img(sum(c[1] for c in calls[:-1]))

    monkeypatch.setattr(loop_mod.Engine, "step_and_frame_batch", fake_batch)
    monkeypatch.setattr(loop_mod.Engine, "step_and_frame", fake_step)
    out = str(tmp_path / "frames")
    assert main(["record", out, "--frames", "10", *STUB]) == 0
    assert calls == [("batch", 8), ("seq", 1), ("seq", 1)]
    for i in range(10):
        assert load_png(os.path.join(out, f"{i:04d}.png"))[0, 0, 0] == i, i


def test_record_resume_skips_prefix_and_fast_forwards(tmp_path, monkeypatch):
    """--resume: the contiguous prefix is skipped but for its last frame,
    the state machine fast-forwarded past exactly those frames, and only
    the missing tail rendered (a later gap does not extend the skip)."""
    out = tmp_path / "frames"
    out.mkdir()
    for i in range(4):
        save_png(_tag_img(i), str(out / f"{i:04d}.png"))
    save_png(_tag_img(6), str(out / "0006.png"))
    ff, rendered = [], []

    def fake_ff(self, actions, dt=1 / 30):
        ff.append((len(actions), dt))
        return self.state

    def fake_step(self, action, dt):
        rendered.append(len(rendered))
        return _tag_img(100 + rendered[-1])

    monkeypatch.setattr(loop_mod.Engine, "fast_forward", fake_ff)
    monkeypatch.setattr(loop_mod.Engine, "step_and_frame", fake_step)
    assert main(["record", str(out), "--frames", "8", "--resume", *STUB]) == 0
    assert ff == [(3, RECORD_DT)] and len(rendered) == 5
    for i, tag in [(0, 0), (2, 2), (3, 100), (4, 101), (7, 104)]:
        assert load_png(str(out / f"{i:04d}.png"))[0, 0, 0] == tag, i


def test_record_ssaa_resolves_at_write_time(tmp_path, monkeypatch):
    """--ssaa 2: the engine is built at 2x --size and written frames are
    box-resolved back to --size."""
    seen_cfg = []
    orig_init = loop_mod.Engine.__init__

    def spy_init(self, cfg, device, **kw):
        seen_cfg.append((cfg.width, cfg.height, device))
        return orig_init(self, cfg, device, **kw)

    def fake_step(self, action, dt):
        img = np.zeros((128, 256, 3), np.uint8)
        img[0, 0] = 255            # a lone bright texel → 64 after 2x2 mean
        return img

    monkeypatch.setattr(loop_mod.Engine, "__init__", spy_init)
    monkeypatch.setattr(loop_mod.Engine, "step_and_frame", fake_step)
    out = str(tmp_path / "frames")
    assert main(["record", out, "--frames", "2", "--ssaa", "2", *STUB]) == 0
    assert seen_cfg == [(256, 128, "cpu")]
    img = load_png(os.path.join(out, "0000.png"))
    assert img.shape == (64, 128, 3)
    assert img[0, 0, 0] == 64 and (img[0, 1] == 0).all()


def test_record_gif_and_png_level_note(tmp_path, monkeypatch, capsys):
    pytest.importorskip("PIL")
    monkeypatch.setattr(loop_mod.Engine, "step_and_frame",
                        lambda self, a, dt: _tag_img(7))
    gif = tmp_path / "a.gif"
    assert main(["record", str(tmp_path / "f"), "--frames", "2", "--gif",
                 str(gif), "--png-level", "12", *STUB]) == 0
    assert gif.stat().st_size > 0
    assert "clamped to 9" in capsys.readouterr().err


def test_gif_needs_pil(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit):
        main(["record", str(tmp_path / "f"), "--frames", "1", "--gif",
              str(tmp_path / "a.gif"), *STUB])


def test_box_downsample_semantics():
    """SSAA resolve: n×n box mean, round half up, uint8 in and out; the
    same numbers as the JAX package's host resolve."""
    img = np.zeros((4, 4, 3), np.uint8)
    img[:2, :2] = 100
    img[:2, 2:4, 0] = [[10, 11], [10, 12]]      # mean 10.75 → 11
    out = box_downsample(img, 2)
    assert out.shape == (2, 2, 3) and out.dtype == np.uint8
    assert (out[0, 0] == 100).all()
    assert out[0, 1, 0] == 11 and out[0, 1, 1] == 0
    assert (out[1] == 0).all()
    src = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    assert np.array_equal(box_downsample(src, 1), src)
    rnd = np.random.default_rng(0).integers(0, 256, (12, 18, 3)).astype(
        np.uint8)
    for n in (1, 2, 3):
        assert np.array_equal(box_downsample(torch.from_numpy(rnd), n),
                              jax_box(rnd, n))


@pytest.mark.parametrize("argv", [
    ["window", "--ssaa", "2"], ["render", "--path", "cuda", "--device", "cpu"],
    ["render", "--device", "gpu0"], ["render", "--device", "-1"],
    ["record", "--dp", "2", "--path", "fast", "--device", "cpu"],
    ["record", "--dp", "-2"], ["record", "--dp-rows", "-2"],
    ["render", "--dp", "2"], ["bench", "--dp-rows", "2"],
    ["render", "--ssaa", "0"], ["bench", "--ssaa", "2"],
    ["render", "--size", "1280"], ["render", "--sky-shape", "x64"],
    ["render", "--sky", "reference"], ["render", "--size", "1x1"],
    ["render", "--device", "1"], ["render", "--path", "pallas"],
], ids=lambda a: "_".join(a).replace("-", ""))
def test_usage_errors(argv, tmp_path):
    """Refused before any engine is built (the CUDA card, if present, is
    never touched: --path plain unless the case names another path)."""
    path = [] if "--path" in argv else ["--path", "plain"]
    with pytest.raises(SystemExit) as e:
        main([*argv, *path])
    assert e.value.code not in (0, None)


def test_cuda_path_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be checked")
    for path in (["--path", "cuda"], [], ["--path", "fast"],
                 ["--path", "oracle", "--device", "0"]):
        with pytest.raises(SystemExit, match="CUDA"):
            main(["render", str(tmp_path / "x.png"), *SMALL, *path])
    assert not (tmp_path / "x.png").exists()


@pytest.mark.parametrize("batch", [8, 4], ids=["tail_only", "batch_and_tail"])
def test_record_plain_matches_engine(tmp_path, monkeypatch, batch):
    """Unstubbed 5-frame record: the files hold the frames of 5 scripted
    step_and_frame calls, bit for bit, whether they came from a batch or
    from the tail."""
    monkeypatch.setattr(cli, "RECORD_BATCH", batch)
    out = str(tmp_path / "frames")
    assert main(["record", out, "--frames", "5", *SMALL, "--path",
                 "plain"]) == 0
    eng = cli_engine()
    for i in range(5):
        img = eng.step_and_frame(scripted_action(i), RECORD_DT).numpy()
        assert np.array_equal(load_png(os.path.join(out, f"{i:04d}.png")),
                              img), i


def test_render_matches_jax_cli(tmp_path):
    flags = ["--day", "14", "--cam", "1", *SMALL]
    assert main(["render", str(tmp_path / "port.png"), *flags, "--path",
                 "plain"]) == 0
    assert jax_main(["render", str(tmp_path / "jax.png"), *flags, "--path",
                     "fast"]) == 0
    port, ref = load_png(str(tmp_path / "port.png")), load_png(
        str(tmp_path / "jax.png"))
    assert port.shape == ref.shape == (96, 160, 3)
    rmse, off = golden_stats(port, ref)
    assert rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC, (rmse, off)


def test_render_state_checkpoint(tmp_path):
    """--state renders the saved state verbatim (no settle)."""
    st = tsim.animate(tsim.settle(tsim.init_state()),
                      Action.idle()._replace(mouse_dx=np.float32(40.0),
                                             time_control=np.int32(1),
                                             set_aa_off=np.bool_(True)), 0.6)
    save_state(st, str(tmp_path / "s.json"))
    assert main(["render", str(tmp_path / "s.png"), "--state",
                 str(tmp_path / "s.json"), *SMALL, "--path", "plain"]) == 0
    eng = cli_engine()
    eng.set_state(st)
    assert np.array_equal(load_png(str(tmp_path / "s.png")), eng.frame_np())


def test_bench_prints_its_stats(capsys):
    assert main(["bench", "--frames", "2", *SMALL, "--path", "plain"]) == 0
    stats = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == 2 and stats["fps"] > 0


def path_engine(path) -> Engine:
    """The Engine main() builds for SMALL --path fast|oracle --device cpu."""
    return Engine(RenderConfig(width=160, height=96, sky_source="auto",
                               path=path, procedural_sky_shape=(64, 128)),
                  "cpu")


@pytest.mark.parametrize("path", ["fast", "oracle"])
def test_render_on_plain_paths(tmp_path, path):
    """render --path fast|oracle --device cpu writes that path's Engine
    frame."""
    flags = ["--day", "18", "--cam", "1", *SMALL, "--path", path, "--device",
             "cpu"]
    out = str(tmp_path / f"{path}.png")
    assert main(["render", out, *flags]) == 0
    eng = path_engine(path)
    eng.set_state(cli.build_state(cli._parser().parse_args(
        ["render", *flags]), eng.state))
    assert np.array_equal(load_png(out), eng.frame_np())


@pytest.mark.parametrize("path", ["fast", "oracle"])
def test_bench_on_plain_paths(capsys, path):
    assert main(["bench", "--frames", "2", *SMALL, "--path", path,
                 "--device", "cpu"]) == 0
    stats = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == 2 and stats["fps"] > 0


def test_record_on_the_fast_path(tmp_path):
    """record renders its batches frame by frame on these paths and writes
    the scripted step_and_frame frames."""
    out = str(tmp_path / "frames")
    assert main(["record", out, "--frames", "3", *SMALL, "--path", "fast",
                 "--device", "cpu"]) == 0
    eng = path_engine("fast")
    for i in range(3):
        img = eng.step_and_frame(scripted_action(i), RECORD_DT).numpy()
        assert np.array_equal(load_png(os.path.join(out, f"{i:04d}.png")),
                              img), i


def test_device_cpu_is_the_plain_path(tmp_path):
    """--device cpu on the default path runs the kernels' plain versions,
    as --path plain does."""
    flags = ["--day", "14", *SMALL]
    assert main(["render", str(tmp_path / "a.png"), *flags, "--device",
                 "cpu"]) == 0
    assert main(["render", str(tmp_path / "b.png"), *flags, "--path", "plain",
                 "--device", "cpu"]) == 0
    assert np.array_equal(load_png(str(tmp_path / "a.png")),
                          load_png(str(tmp_path / "b.png")))


def test_cli_preview_is_window_only():
    """--preview reaches RenderConfig for the window command only: it is a
    window-loop knob, and forwarded for render/record/bench the config's
    divisibility check would refuse runs that never read it."""
    flags = ["--preview", "3", "--path", "plain"]  # 720 % 3 == 0, 1280 % 3 != 0
    for command in ("render", "record", "bench"):
        assert cli._config(cli._parser().parse_args(
            [command, *flags])).preview == 1
    with pytest.raises(ValueError, match="preview"):
        cli._config(cli._parser().parse_args(["window", *flags]))
    with pytest.raises(SystemExit) as e:
        main(["window", *flags])
    assert e.value.code not in (0, None)
    cfg = cli._config(cli._parser().parse_args(
        ["window", "--preview", "4", "--path", "oracle"]))
    assert (cfg.preview, cfg.path) == (4, "oracle")


def test_window_command_runs_the_viewer(tmp_path, monkeypatch):
    """window builds its config, device and start state and hands them to
    run_window; bounded to 2 frames with SDL_VIDEODRIVER=dummy."""
    pytest.importorskip("pygame")
    from raytracing_cuda_tpu_torch.app import window as win

    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    monkeypatch.chdir(tmp_path)
    seen = {}
    orig = win.run_window

    def bounded(config, device, **kw):
        seen.update(config=config, device=device, **kw)
        seen["frames"] = orig(config, device, max_frames=2, **kw)

    monkeypatch.setattr(win, "run_window", bounded)
    assert main(["window", "--size", "64x48", "--sky-shape", "32x16",
                 "--preview", "2", "--day", "14", "--scene", "classic",
                 "--device", "cpu"]) == 0
    assert seen["frames"] == 2 and seen["device"] == "cpu"
    assert (seen["config"].preview, seen["config"].path) == (2, "auto")
    st = seen["initial_state"]
    assert float(st.day_time) == 14.0
    # the classic scene keeps its own camera pose under --day
    assert torch.equal(st.cam.pos, loop_mod.initial_state(
        seen["config"]).cam.pos)


def test_window_needs_pygame(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "pygame", None)
    with pytest.raises(SystemExit) as e:
        main(["window", "--device", "cpu"])
    assert e.value.code not in (0, None)
    assert "pygame" in capsys.readouterr().err
