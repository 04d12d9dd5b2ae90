#!/usr/bin/env python
"""Decompose one frame at a pose: the step + packs, kernel A, the sky
stage, kernel B, and the host's share (port of
experiments/worst_pose_decompose.py).

Device stages, each captured once in a CUDA graph of n calls and replayed
in turns within every rep (device time by CUDA graph replay; the stage
costs are the differences of their medians): the state step and the packs
on the device (sim.animate_packed, then pipeline.frame_packs: on a card one
launch of csrc/packs.cu over the Engine's pack base); kernel A alone on
those packs; kernel A + the sky lookup + quantize (pipeline._base); the
same + FXAA (kernel B, selected by the state's toggle); and the whole frame
as the Engine's CUDA graph runs it (Engine._step_render: step, packs,
kernel A, sky, kernel B). Beside them, by the host clock (median of reps of
n calls): the host time of one Engine.step_and_frame call on the card (the
graph's replay enqueued, the action vector copied, the frame copied out),
and the CPU Engine's host half as the old reference, the same code on CPU
tensors: the state step, derive_frame + camera_rays, and the packing
(frame_packs less the derive and camera it runs too). On the CPU (--device
cpu) every stage runs on the host and is read by the host clock, and the
output says so.

--sky procedural|reference|auto picks the panoramas (reference: the four
PNGs under --sky-dir, default assets/backgrounds/, point-sampled by
--sky-downsample; auto: those where the directory exists). --sky
reference where a panorama is missing exits 2 and names it.

  python experiments/worst_pose_decompose_torch.py [--day 17.6 --yaw 315]
      [--size 1280x720 --reps 5 --n 10 --sky procedural] [--device cpu]
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
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.render.cuda_rt import raytrace_planes
from raytracing_cuda_tpu_torch.render.fxaa import apply_fxaa
from raytracing_cuda_tpu_torch.render.pipeline import _base, frame_packs
from raytracing_cuda_tpu_torch.scene.builders import (ISLAND_SPH_CLUSTERS,
                                                      ISLAND_TRI_CLUSTERS,
                                                      ISLAND_TRI_SUBS,
                                                      build_scene)
from raytracing_cuda_tpu_torch.scene.textures import (REFERENCE_BACKGROUNDS,
                                                      load_skies,
                                                      pack_sky_all)
from raytracing_cuda_tpu_torch.sim import state as sim
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.timing import capture_graph, replay_ms

DEVICE_STAGES = ("step+packs", "kernel_only", "kernel+sky", "kernel+sky+fxaa",
                 "whole_frame")
HOST_STAGES = ("engine_call", "cpu_step", "cpu_derive+camera", "cpu_packing")


def host_ms(fn, reps: int, n: int) -> list:
    """Host-clock ms per call of fn(), one sample per rep of n calls."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) * 1e3 / n)
    return out


def main(argv=None, report=None) -> int:
    """Print each stage's median; `report`, a dict, also receives
    {stage: samples in ms} under "device_ms" and "host_ms", the device's
    clock under "device_clock" and the sky under "sky"."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--day", type=float, default=17.6)
    ap.add_argument("--yaw", type=float, default=315.0)
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--sky", default="procedural",
                    choices=["procedural", "reference", "auto"])
    ap.add_argument("--sky-dir", default=REFERENCE_BACKGROUNDS,
                    help="the reference panoramas' directory")
    ap.add_argument("--sky-downsample", type=int, default=1)
    ap.add_argument("--sky-shape", default="4096x2048",
                    help="procedural panorama size WxH")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))
    ssw, ssh = (int(v) for v in args.sky_shape.lower().split("x"))
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is "
                         "False; pass --device cpu for the plain versions")
    try:
        texels = load_skies(args.sky, args.sky_downsample, (ssh, ssw),
                            path=args.sky_dir).texels
    except FileNotFoundError as e:
        print(f"--sky {args.sky}: {e}", file=sys.stderr)
        return 2
    sky_h, sky_w = texels.shape[1:3]
    # the engine's own panoramas are a placeholder: those of --sky replace
    # them, as the engine reads no other path
    eng = Engine(RenderConfig(width=w, height=h, sky_source="procedural",
                              procedural_sky_shape=(8, 8)), dev)
    eng.sky_pack = eng._skies[eng.device] = pack_sky_all(
        torch.from_numpy(texels).to(dev))
    eng.sky_h, eng.sky_w = sky_h, sky_w
    del texels

    st = sim.state_to(preset_state(day=args.day, yaw=args.yaw), dev)
    av = eng._upload(Action.idle().pack(1 / 60)[None])
    clusters = (ISLAND_TRI_CLUSTERS, ISLAND_SPH_CLUSTERS, ISLAND_TRI_SUBS)
    coef, params, nt, ns, cull = eng._packs(st)

    def step_packs():
        return eng._packs(sim.animate_packed(st, av[0]))

    def kernel_only():
        return raytrace_planes(coef, params, h, w, nt, ns, cull=cull)

    def kernel_sky():
        return _base(coef, params, nt, ns, eng.sky_pack, sky_h, sky_w, st, h,
                     w, cull)

    def kernel_sky_fxaa():
        return apply_fxaa(kernel_sky(), st.aa)

    def whole_frame():
        return eng._step_render("frame", st, av)

    fns = dict(zip(DEVICE_STAGES, (step_packs, kernel_only, kernel_sky,
                                   kernel_sky_fxaa, whole_frame)))
    dev_ms = {name: [] for name in DEVICE_STAGES}
    if cuda:
        dev_clock = "device ms per call, CUDA graph replay"
        card = torch.cuda.get_device_name(dev)
        with torch.cuda.device(dev):
            graphs = {k: capture_graph(fn, args.n) for k, fn in fns.items()}
            for _ in range(args.reps):
                for k in DEVICE_STAGES:     # interleaved within each rep
                    dev_ms[k].append(replay_ms(graphs[k], args.n))
    else:
        dev_clock = "host-clock ms per call of the plain versions (no kernel)"
        card = "cpu"
        for k, fn in fns.items():
            dev_ms[k] = host_ms(fn, args.reps, args.n)

    # the host's share: one Engine call (the graph's replay on a card),
    # then the CPU Engine's host half, the old reference
    aspect = w / h
    eng.set_state(st)
    eng.step_and_frame()          # eager: the warm-up; the next captures
    host = {"engine_call": host_ms(eng.step_and_frame, args.reps, args.n)}
    scene_c = build_scene()
    st_c = preset_state(day=args.day, yaw=args.yaw)
    av_c = av[0].cpu()
    derive = host_ms(lambda: (sim.derive_frame(scene_c, st_c),
                              sim.camera_rays(st_c.cam, aspect)),
                     args.reps, args.n)
    packs = host_ms(lambda: frame_packs(scene_c, st_c, h, w, None, *clusters,
                                        cull.cpu()),
                    args.reps, args.n)
    host.update({"cpu_step": host_ms(lambda: sim.animate_packed(st_c, av_c),
                                     args.reps, args.n),
                 "cpu_derive+camera": derive,
                 "cpu_packing": [p - d for p, d in zip(packs, derive)]})
    if cuda:
        torch.cuda.synchronize(dev)

    print(f"frame at day {args.day} yaw {args.yaw}, {w}x{h}, on {dev} "
          f"({card}); sky {args.sky} {sky_h}x{sky_w}; median of "
          f"{args.reps} reps of {args.n}", flush=True)
    med = {k: statistics.median(v) for k, v in dev_ms.items()}
    for k in DEVICE_STAGES:
        print(f"{k}: {med[k]:.4f} ms [{', '.join(f'{x:.4f}' for x in dev_ms[k])}]"
              f" ({dev_clock})", flush=True)
    print(f"stages: step + packs {med['step+packs']:.4f}, kernel A "
          f"{med['kernel_only']:.4f}, sky lookup + quantize "
          f"{med['kernel+sky'] - med['kernel_only']:+.4f}, kernel B "
          f"{med['kernel+sky+fxaa'] - med['kernel+sky']:+.4f}; the whole "
          f"frame {med['whole_frame']:.4f} ms (differences of the medians; "
          f"{dev_clock})", flush=True)
    hmed = {k: statistics.median(v) for k, v in host.items()}
    print("host: " + ", ".join(f"{k} {hmed[k]:.4f}" for k in HOST_STAGES)
          + " ms (host clock; engine_call on " + str(dev) + ", the cpu_* "
          "rows the CPU Engine's host half)", flush=True)
    if report is not None:
        report.update(device=card, device_clock=dev_clock, device_ms=dev_ms,
                      host_ms=host, sky=(args.sky, sky_h, sky_w))
    return 0


if __name__ == "__main__":
    sys.exit(main())
