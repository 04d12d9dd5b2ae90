#!/usr/bin/env python
"""Long sustained soak of the port: consecutive timed segments across the
full clock (port of experiments/soak.py).

Segments of sustained frames with the clock playing and the bench camera
script, the host's peak RSS and, on a card, the peak of
torch.cuda.max_memory_allocated() sampled per segment. The per-segment fps
spread follows the content (open-sea views cull nearly everything; low-sun
windows sweep the mountain ring with near-horizontal shadow rays) and the
host's speed of the moment; the minimum segment is the floor. Each segment
is read by the Engine's frame timer (CUDA events on a card) and by the host
clock.

  python experiments/soak_torch.py [--segments 5 --frames 400 --day0 12.0]
      [--size 1280x720] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import resource
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from bench_torch import camera_path
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.sim import state as sim
from raytracing_cuda_tpu_torch.utils.config import RenderConfig


def soak(eng: Engine, segments: int, frames: int, day0: float, out=print):
    """Run the segments → one dict per segment: fps by the frame timer and
    by the host clock, the clock string, host peak RSS in GB and the
    device's peak allocated bytes in the segment (None on the CPU)."""
    cuda = eng.device.type == "cuda"
    eng.set_state(sim.settle(sim.init_state()._replace(
        day_time=torch.tensor(day0, dtype=torch.float32))))
    rows, done = [], 0
    for seg in range(segments):
        if cuda:
            torch.cuda.reset_peak_memory_stats(eng.device)
        stats = eng.run(frames, action_fn=lambda i: camera_path(done + i),
                        dt=1 / 60, warmup=2 if seg == 0 else 0)
        done += frames
        row = {"fps": stats.fps, "host_fps": stats.host_fps,
               "clock": eng.time_string(),
               "rss_gb": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 1e6,
               "device_peak_bytes": (torch.cuda.max_memory_allocated(
                   eng.device) if cuda else None)}
        rows.append(row)
        out(f"segment {seg}: {row['fps']:7.2f} fps (host clock "
            f"{row['host_fps']:7.2f})  clock={row['clock']}  "
            f"rss={row['rss_gb']:.2f} GB"
            + (f"  device peak={row['device_peak_bytes'] / 1e6:.1f} MB"
               if cuda else ""))
    fps = [r["fps"] for r in rows]
    out(f"floor {min(fps):.2f} fps   median {statistics.median(fps):.2f} "
        f"fps   peak {max(fps):.2f} fps over {done} frames")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--segments", type=int, default=5)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--day0", type=float, default=12.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))
    eng = Engine(RenderConfig(width=w, height=h), args.device)
    name = (torch.cuda.get_device_name(eng.device)
            if eng.device.type == "cuda" else "cpu")
    print(f"{w}x{h} on {eng.device} ({name})", flush=True)
    soak(eng, args.segments, args.frames, args.day0,
         out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
