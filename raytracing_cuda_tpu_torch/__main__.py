"""Command-line entry points (port of raytracing_cuda_tpu/__main__.py).

  python -m raytracing_cuda_tpu_torch window              interactive viewer
  python -m raytracing_cuda_tpu_torch render out.png      one frame to PNG
  python -m raytracing_cuda_tpu_torch record out_dir/     scripted frames
  python -m raytracing_cuda_tpu_torch bench               sustained-FPS loop

`--device` names where a command runs: a card index N (`cuda:N`; card 0
when the flag is absent) or the word `cpu`. Nothing falls back: a command
for a card fails where torch.cuda.is_available() is false. `--path` names
the raytracer: `auto` (the default) is the megakernel path, the CUDA
kernels on a card and their plain PyTorch versions on the CPU; `cuda` is
`auto` on a card only; `plain` is `auto` on the CPU (`--device cpu` is then
implied); `fast` and `oracle` are the plain PyTorch raytracers of
render/fast.py and render/reference.py, on either device. `window` needs
pygame; `window --preview N` renders at full size and reads back a 1/N-size
downsample made on the device. `record --dp N
[--dp-rows R]` spreads batches of frames over N devices, or N groups of R
devices that split each frame into row bands (parallel/): distinct cards
on the CUDA paths, failing before any frame is written where fewer exist;
N x R entries of the one CPU device on the CPU. `--dp` needs the
megakernel path.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# record: full batches of this many frames through step_and_frame_batch,
# then the tail frame by frame
RECORD_BATCH = 8
RECORD_DT = 1 / 30


def scripted_action(i: int):
    """record's input for frame i: a slow sine pan with the clock
    scrubbing forward (__main__.py:199-202 of the JAX CLI)."""
    from raytracing_cuda_tpu_torch.sim.actions import Action

    return Action.idle()._replace(
        mouse_dx=np.float32(3.0 * np.sin(i * 0.05)),
        time_control=np.int32(1))


def _parse_wh(value: str, flag: str) -> "tuple[int, int]":
    try:
        w, h = (int(v) for v in value.lower().split("x"))
    except ValueError:
        raise SystemExit(f"{flag} must be WxH (e.g. 1280x720), "
                         f"got {value!r}")
    return w, h


def _config(args):
    from raytracing_cuda_tpu_torch.utils.config import RenderConfig

    w, h = _parse_wh(args.size, "--size")
    # SSAA (render/record only): the engine renders at N x the requested
    # size; frames are box-resolved back down at write time
    if args.command in ("render", "record") and args.ssaa > 1:
        w, h = w * args.ssaa, h * args.ssaa
    ssw, ssh = _parse_wh(args.sky_shape, "--sky-shape")
    # preview is the window's knob: forwarded for another command, the
    # config's divisibility check would refuse runs that never read it
    preview = args.preview if args.command == "window" else 1
    path = args.path if args.path in ("fast", "oracle") else "auto"
    return RenderConfig(width=w, height=h, sky_source=args.sky, path=path,
                        scene=args.scene, procedural_sky_shape=(ssh, ssw),
                        sky_downsample=args.sky_downsample, preview=preview)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="raytracing_cuda_tpu_torch")
    ap.add_argument("command", choices=["window", "render", "record", "bench"])
    ap.add_argument("target", nargs="?", default=None,
                    help="output png (render) / output dir (record)")
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--sky", default="auto",
                    choices=["auto", "reference", "procedural"],
                    help="reference: the panoramas under assets/backgrounds/ "
                         "(not shipped); auto: those where that directory "
                         "exists, else procedural")
    ap.add_argument("--sky-downsample", type=int, default=1,
                    help="point-sample every k-th reference sky texel")
    ap.add_argument("--sky-shape", default="2048x1024",
                    help="procedural panorama size WxH, same axis order as "
                         "--size")
    ap.add_argument("--path", default="auto",
                    choices=["auto", "cuda", "plain", "fast", "oracle"],
                    help="auto: the megakernel path (CUDA kernels on a "
                         "card, their plain PyTorch versions on the CPU); "
                         "cuda: auto, on a card only; plain: auto on the "
                         "CPU; fast/oracle: the plain PyTorch raytracers, "
                         "on either device")
    ap.add_argument("--scene", default="island", choices=["island", "classic"])
    ap.add_argument("--state", default=None,
                    help="load a FrameState checkpoint (utils.checkpoint JSON)")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--day", type=float, default=None, help="clock hour 0-24")
    ap.add_argument("--cam", type=int, default=None, help="camera preset 0/1")
    ap.add_argument("--no-aa", action="store_true")
    ap.add_argument("--gif", default=None,
                    help="record: also assemble frames into an animated GIF "
                         "(needs PIL)")
    ap.add_argument("--dp", type=int, default=1,
                    help="record: spread each batch of frames over N "
                         "devices (parallel/frames.py)")
    ap.add_argument("--dp-rows", type=int, default=1,
                    help="record: with --dp N, also split each frame into "
                         "row bands over R devices (N x R devices)")
    ap.add_argument("--resume", action="store_true",
                    help="record: skip frames already on disk (contiguous "
                         "prefix, re-rendering its last frame) and "
                         "fast-forward the state machine past them")
    ap.add_argument("--png-level", type=int, default=0,
                    help="record PNG compression 0-9 (0 = stored deflate, "
                         "the default; >0 = Sub-filtered zlib on writer "
                         "threads)")
    ap.add_argument("--ssaa", type=int, default=1,
                    help="render/record: render at N x --size and "
                         "box-resolve down")
    ap.add_argument("--preview", type=int, default=1,
                    help="window: render at full size but read back a "
                         "1/N-size downsample made on the device and "
                         "upscale it in the blit")
    ap.add_argument("--device", default=None,
                    help="a CUDA card index N (cuda:N, the reference's "
                         "-device=N flag, main.cpp:391; default card 0) or "
                         "the word cpu; no fallback from a card to the CPU")
    return ap


def _check_usage(ap, args) -> None:
    """Refuse what the port does not run, before any engine is built."""
    if args.device not in (None, "cpu") and not args.device.isdecimal():
        ap.error(f"--device takes a card index or the word cpu, got "
                 f"{args.device!r}")
    if args.path == "cuda" and args.device == "cpu":
        ap.error("--path cuda runs the CUDA kernels; --device cpu has none")
    if args.path == "plain" and args.device not in (None, "cpu"):
        ap.error("--device selects a CUDA card; --path plain runs on the CPU")
    if args.command == "window":
        try:
            import pygame  # noqa: F401
        except ImportError:
            ap.error("window needs pygame, which is not installed")
    if args.dp < 1 or args.dp_rows < 1:
        ap.error(f"--dp and --dp-rows must be >= 1, got {args.dp} and "
                 f"{args.dp_rows}")
    if (args.dp > 1 or args.dp_rows > 1) and args.command != "record":
        ap.error("--dp/--dp-rows apply to record only")
    if (args.dp > 1 or args.dp_rows > 1) and args.path in ("fast", "oracle"):
        ap.error(f"--dp/--dp-rows need the megakernel path, not --path "
                 f"{args.path}")
    if args.ssaa < 1:
        ap.error(f"--ssaa must be >= 1, got {args.ssaa}")
    if args.ssaa > 1 and args.command in ("window", "bench"):
        ap.error(f"--ssaa applies to render/record only; {args.command} "
                 f"always runs at --size")
    if args.sky_downsample < 1:
        ap.error(f"--sky-downsample must be >= 1, got {args.sky_downsample}")
    if args.sky == "reference":
        from raytracing_cuda_tpu_torch.scene.textures import (
            REFERENCE_BACKGROUNDS)

        if not os.path.isdir(REFERENCE_BACKGROUNDS):
            ap.error(f"--sky reference reads the panoramas under "
                     f"{REFERENCE_BACKGROUNDS}, which does not exist")
    if args.gif:
        try:
            import PIL  # noqa: F401
        except ImportError:
            ap.error("--gif needs PIL (pillow), which is not installed")


def _device(args) -> str:
    if args.path == "plain" or args.device == "cpu":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"--path {args.path} runs on a CUDA card unless "
                         f"--device cpu is given, and "
                         f"torch.cuda.is_available() is False")
    return f"cuda:{args.device or 0}"


def build_state(args, default_state):
    """Apply --state/--day/--cam/--no-aa. A loaded checkpoint is used
    verbatim (settle would overwrite its recolor_vars); settle runs only
    when --day/--cam changed the clock or pose, or no checkpoint was
    given."""
    import torch

    from raytracing_cuda_tpu_torch.sim import state as sim
    from raytracing_cuda_tpu_torch.sim.actions import Action

    st = default_state
    if args.state:
        from raytracing_cuda_tpu_torch.utils.checkpoint import load_state

        st = load_state(args.state)
    needs_settle = not args.state
    dev = st.day_time.device
    if args.day is not None:
        st = st._replace(day_time=torch.tensor(np.float32(args.day),
                                               device=dev))
        needs_settle = True
    if args.cam is not None:
        st = sim.apply_controls(
            st, Action.idle()._replace(cam_preset=np.int32(args.cam)), 0.0)
        needs_settle = True
    if args.no_aa:
        st = st._replace(aa=torch.tensor(False, device=dev))
    return sim.settle(st) if needs_settle else st


def _record_mesh(args, device: str):
    """record's device mesh for --dp/--dp-rows (None without them): dp
    lists of dp_rows devices. Raises SystemExit with the mesh's error where
    too few devices exist."""
    if args.dp == 1 and args.dp_rows == 1:
        return None
    import torch

    from raytracing_cuda_tpu_torch.parallel.frames import make_hybrid_mesh

    try:
        return make_hybrid_mesh(args.dp, args.dp_rows,
                                torch.device(device).type)
    except ValueError as e:
        raise SystemExit(f"record --dp {args.dp} --dp-rows {args.dp_rows}: "
                         f"{e}")


def _record(args, eng, mesh=None) -> int:
    from raytracing_cuda_tpu_torch.utils import frameio
    from raytracing_cuda_tpu_torch.utils.images import box_downsample, to_host

    out_dir = args.target or "frames"
    os.makedirs(out_dir, exist_ok=True)
    if not frameio.available():
        frameio.build()      # g++ once into _build/; save_png fallback below

    def frame_path(i):
        return os.path.join(out_dir, f"{i:04d}.png")

    start = 0
    if args.resume:
        while start < args.frames and os.path.exists(frame_path(start)):
            start += 1
        # the last prefix frame may be truncated by the very crash --resume
        # recovers from (writes are not atomic): always re-render it
        start = max(start - 1, 0)
        if start:
            eng.fast_forward([scripted_action(i) for i in range(start)],
                             RECORD_DT)
            print(f"resume: {start} frames already in {out_dir}, state "
                  f"fast-forwarded", file=sys.stderr)

    if mesh is None:
        batch = RECORD_BATCH

        def render(actions):
            return eng.step_and_frame_batch(actions,
                                            [RECORD_DT] * len(actions))
    else:
        # --dp: batches of dp * 4 frames, the size fixed once, then the
        # rest frame by frame (the JAX CLI's sizing, __main__.py:221-247)
        batch = min(args.dp * 4,
                    (args.frames - start) // args.dp * args.dp)

        def render(actions):
            return eng.render_script_dp(actions, dt=RECORD_DT,
                                        n_rows=args.dp_rows, mesh=mesh)

    def emit_all(write):
        i = start
        while batch and args.frames - i >= batch:
            imgs = to_host(render([scripted_action(i + j)
                                   for j in range(batch)]))
            for j in range(batch):
                write(box_downsample(imgs[j], args.ssaa), frame_path(i + j))
            i += batch
        for i in range(i, args.frames):
            img = eng.step_and_frame(scripted_action(i), RECORD_DT)
            write(box_downsample(img, args.ssaa), frame_path(i))

    level = frameio.set_png_level(args.png_level)
    if level != args.png_level:
        if level == 0 and args.png_level > 0:
            print("note: PNG compression unavailable (zlib-less frameio "
                  "build) — writing uncompressed (level 0)", file=sys.stderr)
        else:
            print(f"note: PNG level clamped to {level} (valid range 0-9)",
                  file=sys.stderr)
    if frameio.available():
        threads = 4 if level > 0 else 1
        with frameio.AsyncFrameWriter(ring=4, threads=threads) as w:
            emit_all(w.submit)
            w.drain()
            written = w.written
        if written != args.frames - start:
            print(f"ERROR: only {written}/{args.frames - start} frames "
                  f"written (disk full or {out_dir} unwritable?)",
                  file=sys.stderr)
            return 1
    else:
        emit_all(frameio.write_png)
    print(f"wrote {args.frames} frames to {out_dir}")
    if args.gif and args.frames > 0:
        from PIL import Image

        def load(i):
            return Image.open(frame_path(i)).convert("P")

        rest = (load(i) for i in range(1, args.frames))
        load(0).save(args.gif, save_all=True, append_images=rest,
                     duration=33, loop=0)
        print(f"wrote {args.gif}")
    return 0


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    _check_usage(ap, args)
    try:
        config = _config(args)
    except ValueError as e:
        ap.error(str(e))
    device = _device(args)
    mesh = _record_mesh(args, device) if args.command == "record" else None

    from raytracing_cuda_tpu_torch.app.loop import Engine, initial_state

    if args.command == "window":
        from raytracing_cuda_tpu_torch.app.window import run_window

        run_window(config, device,
                   initial_state=build_state(args, initial_state(config)))
        return 0

    eng = Engine(config, device)
    eng.set_state(build_state(args, eng.state))

    if args.command == "render":
        from raytracing_cuda_tpu_torch.utils.images import (box_downsample,
                                                            save_png)

        out = args.target or "frame.png"
        save_png(box_downsample(eng.frame_np(), args.ssaa), out)
        print(f"wrote {out}")
        return 0
    if args.command == "record":
        return _record(args, eng, mesh)
    print(eng.run(args.frames).as_dict())
    return 0


if __name__ == "__main__":
    sys.exit(main())
