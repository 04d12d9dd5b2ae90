#!/usr/bin/env python
"""The windowed viewer's frame rate: step + render + host readback per
frame (port of experiments/readback_fps.py).

The sustained bench keeps frames on the device; the window blits a host
copy, so each of its frames also pays a device-to-host copy of the frame
(2.8 MB at 1280x720; preview^2 less with --preview). Two disciplines over
bench_torch.camera_path:

  serialised  each frame copied to the host before the next is stepped
              (frame.cpu(), which waits for the frame);
  one behind  the window's app/window.Readback ring: frame i's copy starts
              into pinned memory right after its work is queued, and frame
              i - 1 is handed back, so a copy overlaps the next frame.

Frames per second by the host clock and, on a card, by CUDA events around
the same loop; medians over reps.

  python experiments/readback_fps_torch.py [--frames 120 --reps 5]
      [--size 1280x720 --preview 1] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from bench_torch import camera_path as act
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.app.window import Readback
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.timing import device_sync

MODES = ("serialised", "one_behind")


def loop_fps(eng: Engine, step, frames: int, mode: str):
    """One timed loop of `frames` frames → (fps by the host clock, fps by
    CUDA events or None on the CPU)."""
    cuda = eng.device.type == "cuda"
    if cuda:
        stream = torch.cuda.current_stream(eng.device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
    t0 = time.perf_counter()
    if mode == "serialised":
        for i in range(frames):
            step(act(i)).cpu()
    else:
        ring = Readback()
        for i in range(frames):
            ring.submit(step(act(i)))
        ring.flush()
    host = frames / (time.perf_counter() - t0)
    if not cuda:
        return host, None
    b.record(stream)
    device_sync(eng.device)
    return host, frames / (a.elapsed_time(b) / 1e3)


def main(argv=None, report=None) -> int:
    """Print each rep and the medians; `report`, a dict, also receives
    {mode: {"host_fps": [...], "events_fps": [...]}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--preview", type=int, default=1,
                    help="on-device box-downsample factor before readback "
                         "(the window's --preview; 1 = full frames)")
    ap.add_argument("--sky-shape", default="4096x2048",
                    help="procedural panorama size WxH")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))
    ssw, ssh = (int(v) for v in args.sky_shape.lower().split("x"))
    eng = Engine(RenderConfig(width=w, height=h, preview=args.preview,
                              procedural_sky_shape=(ssh, ssw)), args.device)
    step = (eng.step_and_frame_preview if args.preview > 1
            else eng.step_and_frame)
    name = (torch.cuda.get_device_name(eng.device)
            if eng.device.type == "cuda" else "cpu")
    print(f"{w}x{h} preview {args.preview} on {eng.device} ({name}): "
          f"{args.frames} frames per loop", flush=True)
    for i in range(3):                        # warm
        step(act(i)).cpu()
    res = {m: {"host_fps": [], "events_fps": []} for m in MODES}
    for r in range(args.reps):
        line = []
        for m in MODES:
            host, events = loop_fps(eng, step, args.frames, m)
            res[m]["host_fps"].append(host)
            res[m]["events_fps"].append(events)
            line.append(f"{m} {host:.2f} fps"
                        + (f" (events {events:.2f})" if events else ""))
        print(f"rep {r}: " + "   ".join(line), flush=True)
    print("median " + "   ".join(
        f"{m} {statistics.median(res[m]['host_fps']):.2f} fps"
        + (f" (events {statistics.median(res[m]['events_fps']):.2f})"
           if res[m]["events_fps"][0] else "") for m in MODES), flush=True)
    if report is not None:
        report.update(res, device=name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
