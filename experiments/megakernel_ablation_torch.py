#!/usr/bin/env python
"""Split kernel A's time at a pose by its diagnostic arms (port of
experiments/megakernel_ablation.py).

The arms are static variants of the megakernel (csrc/raytrace_arms.cu;
render/cuda_rt.py parse_ablate), each launched through
raytrace_planes(..., ablate=...) on the same packs:

  full        the shipped kernel (ablate=())
  noshadow    no shadow ray is cast: lights are never blocked
  noshade     a hit ends the ray and adds nothing: the primary sweeps
  sweep_only  noshade + noshadow. On the card it runs noshade's
              instructions (its shadow rays are cast from the shading that
              noshade skips), so the two differ by the noise alone
  depth0/1/2  levels 0..N only
  nocull      no per-ray cluster cull, and shadow rays test the sea plane
              after the groups (the JAX package's nocull also turns its
              below-horizon cull off)
  no_tbound   the culls' t_hi is BIG (the JAX package's t_bound=False)
  nohcull     shadow rays test the sea plane after the groups

Reading: full - noshadow = the shadow sweeps at every level; full - depth1
= levels 2 and up; noshade (= sweep_only) = the level-0 sweeps; nocull -
full = what the per-ray culls save; no_tbound - full = the t-bound's share;
nohcull - full = the plane-first shadow test's share.

Timing is device time: each arm's n launches are captured once in a CUDA
graph, and every rep replays the arms' graphs in turn, so a drift of the
card falls on all arms alike; each arm's median over the reps, its delta
from full and its spread (min..max) are printed. On the CPU (--device cpu)
the plain versions run the same arms, timed by the host clock, and the
output says so.

--arms takes a comma list. hcull is full (the port's shadow rays test the
plane first); specgate and nospecgate exit 2: the TPU kernel's hoisted
specular gate has no counterpart here.

  python experiments/megakernel_ablation_torch.py [--day 17.6 --yaw 315]
      [--size 1280x720 --reps 7 --n 10 --arms full,noshadow] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from bench_torch import preset_state
from raytracing_cuda_tpu_torch.render.cuda_rt import raytrace_planes
from raytracing_cuda_tpu_torch.render.pipeline import frame_packs
from raytracing_cuda_tpu_torch.scene.builders import (ISLAND_SPH_CLUSTERS,
                                                      ISLAND_TRI_CLUSTERS,
                                                      ISLAND_TRI_SUBS,
                                                      build_scene)
from raytracing_cuda_tpu_torch.utils.timing import capture_graph, replay_ms

ARMS = {
    "full": (),
    "noshadow": ("noshadow",),
    "noshade": ("noshade",),
    "sweep_only": ("noshade", "noshadow"),
    "depth0": ("depth0",),
    "depth1": ("depth1",),
    "depth2": ("depth2",),
    "nocull": ("nocull",),
    "no_tbound": ("no_tbound",),
    "nohcull": ("nohcull",),
}
ALIASES = {"hcull": "full"}
NO_COUNTERPART = ("specgate", "nospecgate")
# (what a difference of two arms' medians measures, minuend, subtrahend)
READINGS = (("shadow sweeps", "full", "noshadow"),
            ("levels 2+", "full", "depth1"),
            ("level-0 sweeps", "sweep_only", None),
            ("per-ray culls save", "nocull", "full"),
            ("t-bound's share", "no_tbound", "full"),
            ("plane-first shadow test's share", "nohcull", "full"))


def pose_packs(day: float, yaw: float, h: int, w: int, device):
    """Kernel A's packs of the island at bench_torch.preset_state(day, yaw)
    on `device` → (coef, params, n_tri_rows, n_sph_rows, cull)."""
    coef, params, nt, ns, cull = frame_packs(
        build_scene(), preset_state(day=day, yaw=yaw), h, w, None,
        ISLAND_TRI_CLUSTERS, ISLAND_SPH_CLUSTERS, ISLAND_TRI_SUBS)
    return coef.to(device), params.to(device), nt, ns, cull.to(device)


def arm_names(spec):
    """--arms → the arm names in ARMS order; SystemExit(2) naming what has
    no counterpart or is unknown."""
    if spec is None:
        return list(ARMS)
    asked = [ALIASES.get(a, a) for a in spec.split(",") if a]
    for a in asked:
        if a in NO_COUNTERPART:
            print(f"arm {a}: the TPU kernel's hoisted specular gate has no "
                  f"counterpart in csrc/raytrace.cu, which computes each "
                  f"ray's specular term where it shades the ray",
                  file=sys.stderr)
            raise SystemExit(2)
        if a not in ARMS:
            print(f"unknown arm {a!r}; the arms are {list(ARMS)} (hcull = "
                  f"full)", file=sys.stderr)
            raise SystemExit(2)
    return [a for a in ARMS if a in asked]


def main(argv=None, report=None) -> int:
    """Run the arms and print each one's median; `report`, a dict, also
    receives {arm: {"median_ms", "delta_ms", "samples_ms"}} under "arms",
    the device under "device" and the clock under "clock"."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--day", type=float, default=17.6)
    ap.add_argument("--yaw", type=float, default=315.0)
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--n", type=int, default=10,
                    help="launches per graph (per timed block on the CPU)")
    ap.add_argument("--arms", default=None,
                    help=f"comma list of {list(ARMS)} (hcull = full); "
                         f"default: all")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)
    names = arm_names(args.arms)
    w, h = (int(v) for v in args.size.lower().split("x"))
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is "
                         "False; pass --device cpu for the plain versions")
    coef, params, nt, ns, cull = pose_packs(args.day, args.yaw, h, w, dev)

    def launch(ablate):
        return lambda: raytrace_planes(coef, params, h, w, nt, ns, cull=cull,
                                       ablate=ablate)

    fns = {name: launch(ARMS[name]) for name in names}
    samples = {name: [] for name in names}
    if cuda:
        clock = "device ms per launch, CUDA graph replay"
        card = torch.cuda.get_device_name(dev)
        with torch.cuda.device(dev):
            graphs = {name: capture_graph(fn, args.n)
                      for name, fn in fns.items()}
            for _ in range(args.reps):
                for name in names:          # interleaved within each rep
                    samples[name].append(replay_ms(graphs[name], args.n))
    else:
        clock = "host-clock ms per call of the plain version (no kernel)"
        card = "cpu"
        for fn in fns.values():
            fn()                            # warm up
        for _ in range(args.reps):
            for name in names:
                t0 = time.perf_counter()
                for _ in range(args.n):
                    fns[name]()
                samples[name].append((time.perf_counter() - t0) * 1e3
                                     / args.n)
    print(f"kernel A arms at day {args.day} yaw {args.yaw}, {w}x{h}, on "
          f"{dev} ({card}): {clock}, median of {args.reps} reps of "
          f"{args.n}", flush=True)
    med = {name: statistics.median(v) for name, v in samples.items()}
    ref = "full" if "full" in med else names[0]
    for name in names:
        v = samples[name]
        print(f"{name}: {med[name]:.4f} ms (delta vs {ref} "
              f"{med[name] - med[ref]:+.4f}) [spread {min(v):.4f}.."
              f"{max(v):.4f}: {', '.join(f'{x:.4f}' for x in v)}]",
              flush=True)
    for what, a, b in READINGS:
        if a in med and (b is None or b in med):
            d = med[a] - (med[b] if b else 0.0)
            print(f"  {what}: {d:+.4f} ms ({a}" + (f" - {b})" if b else ")"),
                  flush=True)
    if report is not None:
        report.update(device=card, clock=clock, arms={
            name: {"median_ms": med[name], "delta_ms": med[name] - med[ref],
                   "samples_ms": samples[name]} for name in names})
    return 0


if __name__ == "__main__":
    sys.exit(main())
