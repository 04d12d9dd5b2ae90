#!/usr/bin/env python
"""Decompose one frame at a pose: kernel A, the sky stage, kernel B and the
host half (port of experiments/worst_pose_decompose.py).

Three device stages, each a prefix of the frame's device work on the same
packs: kernel A alone; kernel A + the sky lookup + quantize (pipeline
._base); the same + FXAA (kernel B). Each stage's n calls are captured once
in a CUDA graph, and every rep replays the three graphs in turn; the
figures are device time by CUDA graph replay, the stage costs the
differences of their medians. Beside them the host half of a frame, each
step by the host clock (median of reps of n calls): the state step
(sim.animate), derive_frame + camera_rays, the packing (host_packs, less
the derive and camera it runs too), and the upload (the packs into pinned
memory and onto the card, to the copy's end, as Engine._upload makes it).
On the CPU (--device cpu) every stage runs on the host and is read by the
host clock, and the output says so.

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
from raytracing_cuda_tpu_torch.render.cuda_rt import raytrace_planes
from raytracing_cuda_tpu_torch.render.fxaa import apply_fxaa
from raytracing_cuda_tpu_torch.render.pipeline import _base, host_packs
from raytracing_cuda_tpu_torch.scene.builders import (ISLAND_SPH_CLUSTERS,
                                                      ISLAND_TRI_CLUSTERS,
                                                      ISLAND_TRI_SUBS,
                                                      build_scene)
from raytracing_cuda_tpu_torch.scene.textures import (REFERENCE_BACKGROUNDS,
                                                      load_skies,
                                                      pack_sky_all)
from raytracing_cuda_tpu_torch.sim import state as sim
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils.timing import capture_graph, replay_ms

DEVICE_STAGES = ("kernel_only", "kernel+sky", "kernel+sky+fxaa")
HOST_STAGES = ("step", "derive+camera", "packing", "upload")


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
    sky_pack = pack_sky_all(torch.from_numpy(texels).to(dev))
    del texels

    scene = build_scene()
    st = preset_state(day=args.day, yaw=args.yaw)
    clusters = (ISLAND_TRI_CLUSTERS, ISLAND_SPH_CLUSTERS, ISLAND_TRI_SUBS)
    coef, params, nt, ns, cull = host_packs(scene, st, h, w, None, *clusters)
    coef_d, params_d, cull_d = (t.to(dev) for t in (coef, params, cull))

    def kernel_only():
        return raytrace_planes(coef_d, params_d, h, w, nt, ns, cull=cull_d)

    def kernel_sky():
        return _base(coef_d, params_d, nt, ns, sky_pack, sky_h, sky_w, st, h,
                     w, cull_d)

    def kernel_sky_fxaa():
        return apply_fxaa(kernel_sky(), bool(st.aa))

    fns = dict(zip(DEVICE_STAGES, (kernel_only, kernel_sky, kernel_sky_fxaa)))
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

    # the host half of a frame, step by step
    aspect = w / h
    n_packs = coef.numel()
    if cuda:
        pinned = torch.empty(n_packs + params.numel(), pin_memory=True)
        dev_buf = torch.empty(pinned.shape, dtype=pinned.dtype, device=dev)

    def upload():
        if cuda:
            pinned[:n_packs] = coef.reshape(-1)
            pinned[n_packs:] = params.reshape(-1)
            dev_buf.copy_(pinned, non_blocking=True)
            torch.cuda.synchronize(dev)
        else:
            torch.cat([coef.reshape(-1), params.reshape(-1)])

    derive = host_ms(lambda: (sim.derive_frame(scene, st),
                              sim.camera_rays(st.cam, aspect)),
                     args.reps, args.n)
    packs = host_ms(lambda: host_packs(scene, st, h, w, None, *clusters),
                    args.reps, args.n)
    host = {"step": host_ms(lambda: sim.animate(st, Action.idle(), 1 / 60),
                            args.reps, args.n),
            "derive+camera": derive,
            "packing": [p - d for p, d in zip(packs, derive)],
            "upload": host_ms(upload, args.reps, args.n)}

    print(f"frame at day {args.day} yaw {args.yaw}, {w}x{h}, on {dev} "
          f"({card}); sky {args.sky} {sky_h}x{sky_w}; median of "
          f"{args.reps} reps of {args.n}", flush=True)
    med = {k: statistics.median(v) for k, v in dev_ms.items()}
    for k in DEVICE_STAGES:
        print(f"{k}: {med[k]:.4f} ms [{', '.join(f'{x:.4f}' for x in dev_ms[k])}]"
              f" ({dev_clock})", flush=True)
    print(f"stages: kernel A {med['kernel_only']:.4f}, sky lookup + quantize "
          f"{med['kernel+sky'] - med['kernel_only']:+.4f}, kernel B "
          f"{med['kernel+sky+fxaa'] - med['kernel+sky']:+.4f} ms "
          f"(differences of the medians; {dev_clock})", flush=True)
    hmed = {k: statistics.median(v) for k, v in host.items()}
    print("host half: " + ", ".join(f"{k} {hmed[k]:.4f}" for k in HOST_STAGES)
          + f" ms; sum {sum(hmed.values()):.4f} ms (host clock)", flush=True)
    if report is not None:
        report.update(device=card, device_clock=dev_clock, device_ms=dev_ms,
                      host_ms=host, sky=(args.sky, sky_h, sky_w))
    return 0


if __name__ == "__main__":
    sys.exit(main())
