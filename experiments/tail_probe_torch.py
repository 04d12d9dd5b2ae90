#!/usr/bin/env python
"""Per-frame tail latency of the sustained loop (port of
experiments/tail_probe.py).

B blocks of K frames of Engine.run on bench_torch.camera_path, the clock
playing from --day0, each block one run with one end sync. Two readings:
per block by the host clock (block time / K, the JAX probe's reading, with
the end sync amortised over K frames), and per frame from the Engine's
frame timer (CUDA events recorded after each frame's work on a card; the
host clock on the CPU). p50/p90/p99, mean, min and max of each.

  python experiments/tail_probe_torch.py [--blocks 60 --frames 10]
      [--size 1280x720 --day0 12.0 --sky auto] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from bench_torch import camera_path
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.sim import state as sim
from raytracing_cuda_tpu_torch.utils.config import RenderConfig


def quantiles(ms) -> dict:
    """p50/p90/p99 (nearest rank below, as the JAX probe), mean, min, max."""
    s = sorted(ms)
    q = lambda p: s[min(len(s) - 1, int(len(s) * p))]  # noqa: E731
    return {"p50": q(0.50), "p90": q(0.90), "p99": q(0.99),
            "mean": statistics.mean(s), "min": s[0], "max": s[-1]}


def tails(eng: Engine, blocks: int, frames: int, day0: float, out=print):
    """Warm up, then run the blocks → {"block_host": quantiles of the
    host-clock ms per frame of each block, "frame": quantiles of the frame
    timer's ms per frame}."""
    eng.set_state(sim.settle(sim.init_state()._replace(
        day_time=torch.tensor(day0, dtype=torch.float32))))
    eng.run(20, action_fn=camera_path, dt=1 / 60, warmup=2)   # warm
    done, per_block, per_frame = 20, [], []
    for _ in range(blocks):
        t0 = time.perf_counter()
        stats = eng.run(frames, action_fn=lambda i: camera_path(done + i),
                        dt=1 / 60, warmup=0)
        per_block.append((time.perf_counter() - t0) * 1e3 / frames)
        per_frame += stats.frame_ms
        done += frames
    res = {"block_host": quantiles(per_block), "frame": quantiles(per_frame)}
    clock = ("CUDA events after each frame" if eng.device.type == "cuda"
             else "host clock per frame")
    for key, what in (("block_host", f"per block of {frames} frames, host "
                                     f"clock, one sync per block"),
                      ("frame", f"per frame, {clock}")):
        r = res[key]
        out(f"{what}: p50 {r['p50']:.4f}  p90 {r['p90']:.4f}  p99 "
            f"{r['p99']:.4f}  mean {r['mean']:.4f}  min {r['min']:.4f}  max "
            f"{r['max']:.4f} ms")
    return res


def main(argv=None, report=None) -> int:
    """Print both readings; `report`, a dict, also receives them."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--blocks", type=int, default=60)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--day0", type=float, default=12.0)
    ap.add_argument("--sky", default="auto",
                    choices=["auto", "reference", "procedural"])
    ap.add_argument("--sky-shape", default="4096x2048",
                    help="procedural panorama size WxH")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))
    ssw, ssh = (int(v) for v in args.sky_shape.lower().split("x"))
    eng = Engine(RenderConfig(width=w, height=h, sky_source=args.sky,
                              procedural_sky_shape=(ssh, ssw)), args.device)
    name = (torch.cuda.get_device_name(eng.device)
            if eng.device.type == "cuda" else "cpu")
    print(f"{args.blocks} blocks x {args.frames} frames at {w}x{h} on "
          f"{eng.device} ({name}), clock from {args.day0}", flush=True)
    res = tails(eng, args.blocks, args.frames, args.day0,
                out=lambda line: print(line, flush=True))
    if report is not None:
        report.update(res, device=name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
