#!/usr/bin/env python
"""Probe frame cost across (day, camera yaw) to find the port's worst state
(port of experiments/worst_state_probe.py).

The clock and the camera ride the frame state, so every probe reuses one
Engine. Each pose is read twice: the megakernel's device time, from the
replay of a CUDA graph of its launches on the pose's packs (the loop is
bound by the host, whose time hides the kernel's), and beside it the
host-clock frame time as the reference probe reads it (n frames enqueued,
one end sync). The poses are ranked by the kernel's device time; the
per-ray cluster culls of csrc/raytrace.cu need not share the TPU kernel's
worst pose (day 17.6, yaw 315, which bench_torch.py's configuration 4c
keeps). On the CPU there is no kernel: the poses are ranked by the
host-clock frame time of the plain versions, and the output says so.

  python experiments/worst_state_probe_torch.py [--size 1280x720]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from bench_torch import time_frames
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.render.cuda_rt import raytrace_planes
from raytracing_cuda_tpu_torch.render.pipeline import host_packs
from raytracing_cuda_tpu_torch.sim import state as sim
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.timing import graph_device_ms

DAYS = (6.5, 12.0, 14.0, 17.0, 17.6, 18.0, 19.0, 1.0)
PITCH = -7.07


def pose_state(day: float, yaw: float, pitch: float = PITCH):
    """The initial state at a clock hour and camera yaw, clock stopped."""
    t = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    base = sim.init_state()
    return sim.settle(base._replace(
        day_time=t(day), cam=base.cam._replace(hor_angle=t(yaw),
                                               ver_angle=t(pitch)),
        play=torch.tensor(False)))


def kernel_ms(eng: Engine, state, reps: int = 10) -> float:
    """The megakernel's device ms per launch on this state's packs."""
    c = eng.config
    coef, params, nt, ns, cull = host_packs(
        eng.scene, state, c.height, c.width, c.aspect, eng.tri_clusters,
        eng.sph_clusters, eng.tri_subs)
    coef, params, cull = (v.to(eng.device) for v in (coef, params, cull))
    with torch.cuda.device(eng.device):
        return graph_device_ms(lambda: raytrace_planes(
            coef, params, c.height, c.width, nt, ns, cull=cull), reps)


def probe(eng: Engine, days=DAYS, yaws=tuple(range(0, 360, 45)), n: int = 8,
          out=print):
    """Sweep the poses → (worst pose's ranking ms, (day, yaw), every
    reading as {(day, yaw): (kernel ms or None, host-clock frame ms)})."""
    cuda = eng.device.type == "cuda"
    time_frames(eng, pose_state(14.0, 309.0), n=2, warmup=1)      # warm
    worst, readings = (0.0, None), {}
    for day in days:
        row = []
        for yaw in yaws:
            st = pose_state(day, float(yaw))
            frame = time_frames(eng, st, n=n, warmup=1).host
            kern = kernel_ms(eng, st) if cuda else None
            readings[(day, yaw)] = (kern, frame)
            rank = kern if cuda else frame
            row.append(f"{yaw:3d}°=" + (f"{kern:.4f}/" if cuda else "")
                       + f"{frame:.2f}")
            if rank > worst[0]:
                worst = (rank, (day, yaw))
        out(f"day {day:4.1f}: " + "  ".join(row))
    return worst[0], worst[1], readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))
    eng = Engine(RenderConfig(width=w, height=h), args.device)
    cuda = eng.device.type == "cuda"
    name = torch.cuda.get_device_name(eng.device) if cuda else "cpu"
    print(f"{w}x{h} on {eng.device} ({name}); each pose: "
          + ("megakernel device ms (CUDA graph replay) / " if cuda else "")
          + "host-clock frame ms", flush=True)
    ms, (day, yaw), _ = probe(eng, out=lambda line: print(line, flush=True))
    print(f"worst: {ms:.4f} ms "
          + ("of megakernel device time" if cuda
             else "per frame by the host clock (plain versions, no kernel)")
          + f" at day={day} yaw={yaw}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
