"""GPU smoke test of the PyTorch/CUDA port: build, check, drive, time.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--frames 120] [--out report.json]

Phases (any failure exits non-zero):
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build both kernels (csrc/raytrace.cu, csrc/fxaa.cu) with nvcc;
  3. each kernel against its plain PyTorch version on the card at
     1280x720, for the four golden states, with times;
  4. the slice: Engine(device="cuda") renders the four golden states
     against tests/golden/tpu/*.png, then runs the idle animated loop;
     both kernels' launch counters must have moved in this phase;
  5. a JSON line per kernel, the card line, and the final status line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
H, W = 720, 1280
SKY_SHAPE = (2048, 4096)
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden", "tpu")
# golden states of tests/test_golden.py:39-44
CASES = {
    "island_morning": dict(day=6.0),
    "mountains_day": dict(day=14.0, cp=1),
    "island_night": dict(day=1.0),
    "evening_flood_noaa": dict(day=18.0, sea=2.0, aa=False),
}
# golden contract (tests/test_golden.py:82-86)
GOLDEN_RMSE = 2e-3
GOLDEN_OFF_FRAC = 0.003
# FXAA kernel vs plain (tests/test_fxaa.py:111-112)
FXAA_RMSE = 2.5e-3
FXAA_DIFF_FRAC = 0.01


def make_state(day, cp=None, sea=None, aa=True):
    """tests/test_golden.py make_state on the port's state machine."""
    from raytracing_cuda_tpu_torch.sim import state as sim
    from raytracing_cuda_tpu_torch.sim.actions import Action

    s = sim.init_state()._replace(day_time=torch.tensor(day,
                                                        dtype=torch.float32))
    if cp is not None:
        s = sim.apply_controls(
            s, Action.idle()._replace(cam_preset=np.int32(cp)), 0.0)
    if sea is not None:
        s = s._replace(sea_y=torch.tensor(sea, dtype=torch.float32))
    return sim.settle(s._replace(aa=torch.tensor(aa)))


def golden_stats(img: np.ndarray, ref: np.ndarray):
    d = np.abs(img.astype(np.float64) - ref.astype(np.float64))
    return (float(np.sqrt(np.mean((d / 255.0) ** 2))),
            float(np.mean(np.any(d > 2.0, axis=-1))))


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches (after a warmup)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


class Failed(Exception):
    pass


def require(ok: bool, what: str):
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        raise Failed(what)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", default=None, help="write a JSON report here")
    args = ap.parse_args()

    # --- 1. environment ---
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from raytracing_cuda_tpu_torch import _build
    from raytracing_cuda_tpu_torch.app.loop import Engine
    from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa as fx
    from raytracing_cuda_tpu_torch.render.pipeline import host_packs, quantize
    from raytracing_cuda_tpu_torch.scene.builders import (
        ISLAND_SPH_CLUSTERS, ISLAND_TRI_CLUSTERS, ISLAND_TRI_SUBS,
        build_scene)
    from raytracing_cuda_tpu_torch.scene.textures import (
        pack_sky_all, procedural_skies, sample_sky_packed_pair)
    from raytracing_cuda_tpu_torch.sim import state as sim
    from raytracing_cuda_tpu_torch.sim.actions import Action
    from raytracing_cuda_tpu_torch.utils.config import RenderConfig
    from raytracing_cuda_tpu_torch.utils.images import load_png

    dev = torch.device(DEVICE)
    card = card_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    print(f"card: {card}", flush=True)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # --- 2. build ---
    print(_build.nvcc_version(), flush=True)
    for name in ("raytrace", "fxaa"):
        t0 = time.perf_counter()
        _build.load(name)
        log = _build.BUILD_LOG[name]
        print(f"built {name}: nvcc {log['seconds']:.2f} s "
              f"(load {time.perf_counter() - t0:.2f} s)\n{log['ptxas']}",
              flush=True)
        report[f"build_{name}_s"] = log["seconds"]

    # --- 3. kernels vs plain versions on the card ---
    scene = build_scene()
    sky_np = procedural_skies(*SKY_SHAPE)
    sky_pack = pack_sky_all(torch.from_numpy(sky_np).to(dev))
    del sky_np
    clusters = (ISLAND_TRI_CLUSTERS, ISLAND_SPH_CLUSTERS, ISLAND_TRI_SUBS)
    a_err, a_mismatch, b_err = 0.0, 0, 0
    timing_inputs = None
    for name, kw in CASES.items():
        st = make_state(**kw)
        coef, params, nt, ns = host_packs(scene, st, H, W, None, *clusters)
        coef, params = coef.to(dev), params.to(dev)
        kern = torch.stack(cuda_rt.raytrace_planes(coef, params, H, W, nt, ns))
        plain = torch.stack(cuda_rt.raytrace_planes_torch(coef, params, H, W,
                                                          nt, ns))
        torch.cuda.synchronize()
        require(bool(torch.isfinite(kern).all()), f"{name}: kernel A planes "
                f"finite")
        miss_k, miss_p = kern[3] > 0, plain[3] > 0
        mism = int((miss_k != miss_p).sum())
        same = (miss_k == miss_p)
        err = float((kern - plain).abs()[:, same].max())
        a_err, a_mismatch = max(a_err, err), max(a_mismatch, mism)
        print(f"{name}: kernel A vs plain: plane max|diff| {err:.3g} on "
              f"class-agreeing pixels, hit/miss mismatches {mism}", flush=True)

        def base_of(planes, st=st):
            r, g, b, mw, mdx, mdy, mdz = planes
            sky = sample_sky_packed_pair(
                sky_pack, *SKY_SHAPE, torch.stack([mdx, mdy, mdz], -1),
                st.day_time / 24.0, st.sky_vars)
            return quantize(torch.stack([r, g, b], -1) + mw[..., None] * sky)

        bk, bp = base_of(kern), base_of(plain)
        rm, off = golden_stats(bk.cpu().numpy(), bp.cpu().numpy())
        require(rm < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC,
                f"{name}: kernel A frame vs plain frame rmse {rm:.3g} "
                f"off>2 {off:.4%} (contract {GOLDEN_RMSE}, "
                f"{GOLDEN_OFF_FRAC:.1%})")
        fk, fp = fx.fxaa(bk), fx.fxaa_torch(bk)
        d = (fk.int() - fp.int()).abs()
        frm = float(torch.sqrt(((d.double() / 255.0) ** 2).mean()))
        fdiff = float((d.amax(-1) > 0).double().mean())
        b_err = max(b_err, int(d.max()))
        require(frm < FXAA_RMSE and fdiff < FXAA_DIFF_FRAC,
                f"{name}: kernel B vs plain rmse {frm:.3g} differing "
                f"{fdiff:.4%} (gate {FXAA_RMSE}, {FXAA_DIFF_FRAC:.0%})")
        print(f"{name}: kernel B vs plain: {int((d.amax(-1) > 0).sum())} "
              f"pixels differ, max {int(d.max())} levels", flush=True)
        if timing_inputs is None:
            timing_inputs = (coef, params, nt, ns, bk, kern, base_of)

    coef, params, nt, ns, bk, kern, base_of = timing_inputs
    ms_a = cuda_ms(lambda: cuda_rt.raytrace_planes(coef, params, H, W, nt, ns),
                   20)
    ms_a_plain = cuda_ms(lambda: cuda_rt.raytrace_planes_torch(
        coef, params, H, W, nt, ns), 3)
    ms_b = cuda_ms(lambda: fx.fxaa(bk), 200)
    ms_b_plain = cuda_ms(lambda: fx.fxaa_torch(bk), 20)
    print(f"kernel A raytrace 720p island_morning: {ms_a:.4f} ms "
          f"(plain {ms_a_plain:.4f} ms) [{card}]", flush=True)
    print(f"kernel B fxaa 720p island_morning: {ms_b:.4f} ms "
          f"(plain {ms_b_plain:.4f} ms) [{card}]", flush=True)

    # where one frame's time goes: the host half (state step + packs, host
    # clock) and the device stages between the kernels (CUDA events)
    st0 = make_state(6.0)
    t0 = time.perf_counter()
    for _ in range(50):
        host_packs(scene, sim.animate(st0, Action.idle(), 1 / 60), H, W,
                   None, *clusters)
    host_ms = (time.perf_counter() - t0) * 1e3 / 50
    ms_sky = cuda_ms(lambda: base_of(kern), 50)
    print(f"breakdown 720p island_morning: host step+packs {host_ms:.4f} ms "
          f"(host clock), sky+quantize {ms_sky:.4f} ms, kernel A "
          f"{ms_a:.4f} ms, kernel B {ms_b:.4f} ms (CUDA events) [{card}]",
          flush=True)
    report["breakdown_ms"] = {"host_step_packs": host_ms,
                              "sky_quantize": ms_sky, "raytrace": ms_a,
                              "fxaa": ms_b}

    # --- 4. the slice through Engine on the card ---
    eng = Engine(RenderConfig(width=W, height=H, scene="island",
                              sky_source="procedural",
                              procedural_sky_shape=SKY_SHAPE), device=DEVICE)
    cuda_rt.raytrace_planes.launches = 0
    fx.fxaa.launches = 0
    worst = 0.0
    for name, kw in CASES.items():
        eng.set_state(make_state(**kw))
        img = eng.frame_np()
        require(img.shape == (H, W, 3) and img.dtype == np.uint8,
                f"{name}: frame shape {img.shape} {img.dtype}")
        rm, off = golden_stats(img, load_png(os.path.join(GOLDEN_DIR,
                                                          f"{name}.png")))
        worst = max(worst, rm)
        report[f"golden_{name}"] = {"rmse": rm, "off_frac": off}
        require(rm < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC,
                f"{name}: Engine frame vs golden rmse {rm:.5f} off>2 "
                f"{off:.4%}")
    eng.set_state(make_state(6.0))
    stats = eng.run(args.frames)
    launches = {"raytrace": cuda_rt.raytrace_planes.launches,
                "fxaa": fx.fxaa.launches}
    ms = sorted(stats.frame_ms)
    print(f"slice: Engine.run({args.frames}) idle animated loop 1280x720 "
          f"island: {stats.fps:.2f} fps, frame ms median "
          f"{ms[len(ms) // 2]:.4f} min {ms[0]:.4f} max {ms[-1]:.4f} "
          f"(CUDA events) [{card}]", flush=True)
    print(f"launch counts in the slice phase: {launches}", flush=True)
    require(all(v > 0 for v in launches.values()),
            "both kernels launched by the main path")
    report.update(slice=stats.as_dict(), launches=launches,
                  golden_rmse_max=worst)

    # --- 5. report ---
    kernels = [
        {"name": "raytrace_megakernel", "route": "cuda",
         "source": "raytracing_cuda_tpu_torch/csrc/raytrace.cu",
         "replaces": "raytracing_cuda_tpu/render/pallas_rt.py:1151",
         "launches": launches["raytrace"], "max_abs_err": a_err,
         "ms": ms_a, "plain_ms": ms_a_plain},
        {"name": "fxaa", "route": "cuda",
         "source": "raytracing_cuda_tpu_torch/csrc/fxaa.cu",
         "replaces": "raytracing_cuda_tpu/render/fxaa.py:265",
         "launches": launches["fxaa"], "max_abs_err": b_err,
         "ms": ms_b, "plain_ms": ms_b_plain},
    ]
    report["kernels"] = kernels
    report["kernel_a_hit_miss_mismatch_max"] = a_mismatch
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke failed: {e}", file=sys.stderr)
        sys.exit(1)
