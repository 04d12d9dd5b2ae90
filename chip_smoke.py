"""GPU smoke test of the PyTorch/CUDA port: build, check, drive, time.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--frames 120] [--out report.json]

Phases (any failure exits non-zero):
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build both kernels (csrc/raytrace.cu, csrc/fxaa.cu) with nvcc, in
     parallel; ptxas must report no spills;
  3. each kernel against its plain PyTorch version on the card at
     1280x720, bit for bit, for the four golden states, the worst pose, the
     seven degenerate states (EXTREME) and the classic scene, with times;
     kernel A at a size whose warp tiles hang over the frame's edges
     (ODD_SIZE), one frame and 3 frames per launch; kernel A's counting
     launch and its lane-efficiency line;
  4. the slice: Engine(device="cuda") renders the four golden states
     against tests/golden/tpu/*.png, then runs the idle animated loop;
     both kernels' launch counters must have moved in this phase;
  5. the batch path: both kernels' K-frame forms against their plain
     versions and single-frame launches, step_and_frame_batch against
     step_and_frame, Engine.run(batch=8) against Engine.run; the batch
     forms' counters must have moved in run(batch=8);
  6. the CLI (render, record, record --resume, render --state, bench)
     in-process in a temporary directory, against Engine frames;
  7. a torch.profiler trace of 30 loop frames: the top device ops and the
     device-busy share of the window;
  8. parallel/ at 1280x720 on meshes that repeat the one card: kernel B's
     halo'd band form against its plain version (bands of 2, 4 and 8) and
     the full-frame kernel, kernel A's launches for the bands of a 4-band
     split against its plain version, render_frame_sharded against Engine
     frames (FXAA on and off), Engine(sharded=...) driven with its band
     counter, Engine.render_script_dp frame DP and hybrid against
     step_and_frame, and `record --dp` on a one-card machine;
  9. the `fast` and `oracle` render paths and the window's pieces at
     1280x720: Engine(path=...) frames for the golden states against the
     720p goldens and the megakernel path's frames, `fast` at two chunk
     sizes, sky_cache=False, a row-sharded `fast` Engine, and the CLI's
     `--path fast|oracle` and `window`; then the viewer's loop without a
     display: step_and_frame_preview against the box downsample of the full
     frame, and 30 frames through the readback ring, with both kernels'
     launch counters read around them;
 10. other sizes: Engine(device="cuda") at 1920x1080 against the four
     goldens in tests/golden/tpu/1920x1080/ under the golden contract, and
     at 640x480 (mountains, FXAA off: bench_torch.py's configuration 1)
     against the CPU Engine's frame under the same contract; at each size
     both kernels against their plain versions bit for bit (at 1080p for
     every golden state), then the device times of kernel A and kernel B
     (CUDA graph replay) and of the sky stage between them (CUDA events);
     both kernels bit for bit at the shapes phase 11's scripts hand them:
     entry()'s 144x256 frame, dryrun_multichip(8)'s 128x128 frames whole
     and in bands of 16 and 8 rows, one and two frames per launch;
 11. the root scripts, in-process on the card: bench_torch.main at 1280x720
     with 60 frames and every configuration (its JSON line is printed, and
     its parity gate must pass), __torch_entry__.dryrun_multichip(8) on
     eight entries of the card and entry(), the worst-state probe over a
     3 x 4 sub-grid, one soak segment of 120 frames; the kernels' launch
     counters are read around each;
 12. a JSON line per kernel form (each with its bound, from this run's
     inputs), the card line, and the final status line.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import bench_torch
from bench_torch import CASES, GOLDEN_OFF_FRAC, GOLDEN_RMSE
from raytracing_cuda_tpu_torch.utils.timing import graph_device_ms

DEVICE = "cuda"
H, W = 720, 1280
SKY_SHAPE = (2048, 4096)
BATCH = 8              # the K of run(batch=8) and of the CLI's record
GOLDEN_DIR = bench_torch.GOLDEN_ROOT
# POSES: the golden states (bench_torch.CASES), the worst pose (day 17.6,
# yaw 315, bench.py:796-800, where the most geometry and sea reflections
# fill the frame and near-horizontal shadow rays sweep the mountain ring)
# and the degenerate states of tests/test_properties.py:28-36, where the sea
# plane's t that seeds kernel A's per-ray bound is extreme or always
# missing: the camera inside the island, below the sea and far away (yaw
# 120, fov 40), the clock at both ends, the sea above and below everything
EXTREME = {
    "camera_inside_island": dict(pos=[0.0, -1.0, 0.0], ver=44.0),
    "camera_below_sea": dict(pos=[0.0, -50.0, 0.0], ver=-44.0),
    "camera_very_far": dict(pos=[5000.0, 800.0, -4000.0], ver=-30.0),
    "day_wraparound": dict(day=24.0),
    "day_zero": dict(day=0.0),
    "sea_above_everything": dict(sea=500.0),
    "sea_far_below": dict(sea=-500.0),
}
POSES = dict(CASES, worst_pose=dict(day=17.6, yaw=315.0), **EXTREME)
# a size whose last warp tiles (8 x 4 pixels) hang over both frame edges
ODD_SIZE = (37, 53)

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): device
# memory bytes/s and float32 operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# Float operations per item as csrc/raytrace.cu writes them (a multiply,
# an add, a min/max or a compare counts one): a ray cast at one level (its
# cross product, dot products and plane test), then each triangle and
# sphere row it must test (intersection and nearest-hit select), a shaded
# hit (normal, two lights' Phong terms and specular, the mirror bounce),
# and a shadow ray (its origin and plane test), then each row it must test.
A_OPS_RAY, A_OPS_TRI, A_OPS_SPH = 24, 44, 24
A_OPS_SHADED, A_OPS_SHADOW, A_OPS_SHADOW_TRI, A_OPS_SHADOW_SPH = (
    200, 20, 42, 22)
# The FXAA function per interior pixel, as csrc/fxaa.cu computes it: its
# luminance once (7; the border's, also read, are not charged) and the
# contrast test (12); then, only where the test finds an edge, the blend
# factor, edge pick and three blended channels (62). fabsf is an operand
# modifier and not counted; border pixels and pixels with no edge copy.
B_OPS_PIXEL, B_OPS_EDGE = 19, 62


def make_state(day=None, cp=None, sea=None, aa=True, yaw=None, pos=None,
               ver=0.0):
    """tests/test_golden.py make_state on the port's state machine; yaw
    turns the camera as bench.py preset_state does; pos and ver place it
    as tests/test_properties.py _extreme_state does (yaw 120, fov 40)."""
    from raytracing_cuda_tpu_torch.core.types import Camera
    from raytracing_cuda_tpu_torch.sim import state as sim
    from raytracing_cuda_tpu_torch.sim.actions import Action

    t = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    s = sim.init_state()
    if pos is not None:
        s = s._replace(cam=Camera(pos=t(pos), hor_angle=t(120.0),
                                  ver_angle=t(ver), fov=t(40.0)))
    if day is not None:
        s = s._replace(day_time=t(day))
    if cp is not None:
        s = sim.apply_controls(
            s, Action.idle()._replace(cam_preset=np.int32(cp)), 0.0)
    if sea is not None:
        s = s._replace(sea_y=torch.tensor(sea, dtype=torch.float32))
    if yaw is not None:
        s = s._replace(cam=s.cam._replace(
            hor_angle=torch.tensor(yaw, dtype=torch.float32)))
    return sim.settle(s._replace(aa=torch.tensor(aa)))


def classic_env():
    """The classic demo scene at its camera pose, day 14
    (tests/test_golden.py classic_env)."""
    from raytracing_cuda_tpu_torch.core.types import Camera
    from raytracing_cuda_tpu_torch.scene.builders import (
        CLASSIC_CAMERA, build_classic_scene)
    from raytracing_cuda_tpu_torch.sim import state as sim

    cc = CLASSIC_CAMERA
    t = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    st = sim.settle(sim.init_state()._replace(
        day_time=t(14.0), cam=Camera(pos=t(cc["pos"]),
                                     hor_angle=t(cc["hor_angle"]),
                                     ver_angle=t(cc["ver_angle"]),
                                     fov=t(cc["fov"]))))
    return build_classic_scene(), st


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


def timed(fn):
    """(fn(), device ms of that one call)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def varied_actions(n):
    """n actions that turn, move, scrub the clock and toggle FXAA."""
    from raytracing_cuda_tpu_torch.sim.actions import Action

    return [Action.idle()._replace(
        mouse_dx=np.float32(7.0 * (i - 3)), move_forward=np.int32(i % 3 == 1),
        time_control=np.int32(1 if i % 2 else 0),
        set_aa_off=np.bool_(i == 2), set_aa_on=np.bool_(i == 5))
        for i in range(n)]


def reset_counts():
    from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa as fx

    for fn in (cuda_rt.raytrace_planes, cuda_rt.raytrace_planes_batch,
               fx.fxaa, fx.fxaa_batch, fx.fxaa_ext):
        fn.launches = 0
    cuda_rt.raytrace_planes_batch.frames = 0
    fx.fxaa_batch.frames = 0
    fx.fxaa_ext.frames = 0


def read_counts() -> dict:
    from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa as fx

    return {"raytrace_megakernel": cuda_rt.raytrace_planes.launches,
            "raytrace_megakernel_k8": cuda_rt.raytrace_planes_batch.launches,
            "raytrace_megakernel_k8_frames":
                cuda_rt.raytrace_planes_batch.frames,
            "fxaa": fx.fxaa.launches, "fxaa_k8": fx.fxaa_batch.launches,
            "fxaa_k8_frames": fx.fxaa_batch.frames,
            "fxaa_band": fx.fxaa_ext.launches,
            "fxaa_band_frames": fx.fxaa_ext.frames}


def states_equal(a, b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip(a.cam, b.cam))
            and all(torch.equal(x, y) for x, y in zip(a[1:], b[1:])))


def device_activity(trace_path: str):
    """Chrome trace → (top device ops [(name, total ms, count)], device
    busy ms, window ms). Busy is the union of kernel/memcpy/memset
    intervals; the window spans every complete event of the trace."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    ops: dict = {}
    for e in dev:
        ms, n = ops.get(e["name"], (0.0, 0))
        ops[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    busy, end = 0.0, None
    for e in sorted(dev, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    window = (max(e["ts"] + e["dur"] for e in events)
              - min(e["ts"] for e in events)) if events else 0.0
    top = sorted(((n, ms, c) for n, (ms, c) in ops.items()),
                 key=lambda t: -t[1])
    return top, busy / 1e3, window / 1e3


def bound(nbytes: float, ops: float):
    """(least ms on the card, what bounds it) for moving nbytes once and
    doing ops float32 operations: the larger of the two times at the
    card's published peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def raytrace_bound(work: dict, coefs, params, K: int, h: int, w: int):
    """Kernel A's bound for K frames of h x w, from what these inputs
    needed: raytrace_planes_torch's work counts with the scene's cull
    groups, so a ray is charged only the rows under the cluster bounds it
    can reach (before the sea plane's hit, or before the light for a
    shadow ray), and not the bound tests, which a tile of rays can share.
    An occluded shadow ray is charged one triangle row, the least its
    early exit can test."""
    ops = (work["rays"] * A_OPS_RAY + work["tri_tests"] * A_OPS_TRI
           + work["sph_tests"] * A_OPS_SPH + work["shaded"] * A_OPS_SHADED
           + work["shadow"] * A_OPS_SHADOW
           + work["occluded"] * A_OPS_SHADOW_TRI
           + work["shadow_tri_tests"] * A_OPS_SHADOW_TRI
           + work["shadow_sph_tests"] * A_OPS_SHADOW_SPH)
    nbytes = (coefs.numel() + params.numel()) * 4 + 7 * 4 * K * h * w
    return bound(nbytes, ops)


def fxaa_edges(ext: torch.Tensor, row0: int, total_h: int) -> int:
    """Interior pixels of bands with their halo rows ((..., h + 2, W, 3)
    uint8) that pass FXAA's contrast test: those whose blend the kernel
    computes (render/fxaa.py fxaa_ext_torch's test)."""
    from raytracing_cuda_tpu_torch.render import fxaa as fx

    lum = fx.luminance(ext.float())
    nb = torch.stack([lum[..., 1:-1, 1:-1], lum[..., :-2, 1:-1],
                      lum[..., 2:, 1:-1], lum[..., 1:-1, 2:],
                      lum[..., 1:-1, :-2]])
    high, low = nb.amax(0), nb.amin(0)
    edge = ~(high - low < torch.clamp(fx.RELATIVE_THRESHOLD * high,
                                      min=fx.CONTRAST_THRESHOLD))
    y = row0 + torch.arange(ext.shape[-3] - 2, device=ext.device)
    return int((edge & ((y > 0) & (y < total_h - 1))[:, None]).sum())


def fxaa_bound(ext: torch.Tensor, row0: int = 0, total_h=None,
               halo: bool = True):
    """Kernel B's bound for K frames (or bands of h rows at row0) of width
    w, ext (K, h + 2, w, 3) with their halo rows: each input byte read once
    (the halo rows only where the launch reads them), each output written
    once, B_OPS_PIXEL operations per interior pixel and B_OPS_EDGE more per
    edge pixel (fxaa_edges)."""
    K, h, w = ext.shape[0], ext.shape[1] - 2, ext.shape[2]
    total_h = h if total_h is None else total_h
    rows = sum(1 for y in range(row0, row0 + h) if 0 < y < total_h - 1)
    nbytes = K * 3 * w * ((h + 2 if halo else h) + h)
    return bound(nbytes, K * rows * (w - 2) * B_OPS_PIXEL
                 + fxaa_edges(ext, row0, total_h) * B_OPS_EDGE)


def framed(frames: torch.Tensor) -> torch.Tensor:
    """(K, H, W, 3) frames → (K, H + 2, W, 3) with a zero halo row above
    and below (never read: a frame's first and last rows pass through)."""
    return torch.nn.functional.pad(frames, (0, 0, 0, 0, 1, 1))


def halo_bands(img: torch.Tensor, n: int):
    """(row0, band with its halo rows) for n bands of a (H, W, 3) frame,
    zero rows beyond the frame's top and bottom."""
    sub = img.shape[0] // n
    zero = torch.zeros_like(img[:1])
    for c in range(n):
        top = img[c * sub - 1:c * sub] if c else zero
        bot = img[(c + 1) * sub:(c + 1) * sub + 1] if c < n - 1 else zero
        yield c * sub, torch.cat([top, img[c * sub:(c + 1) * sub], bot])


PROFILE_TRIES = 4


def profiled(fn, reps: int, knames):
    """device_activity of a torch.profiler trace of reps calls of fn(),
    traced again (up to PROFILE_TRIES traces) while the trace holds no
    device event of a kernel named in knames: now and then a trace comes
    back without its device events. None if no trace holds them."""
    from raytracing_cuda_tpu_torch.utils import profiling

    for attempt in range(1, PROFILE_TRIES + 1):
        fn()
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            act = device_activity(os.path.join(tmp, profiling.TRACE_FILE))
        missing = [k for k in knames
                   if not any(k in name for name, _, _ in act[0])]
        if not missing:
            return act
        print(f"torch.profiler trace {attempt} of {PROFILE_TRIES} holds no "
              f"device event of {missing} ({len(act[0])} device ops)",
              flush=True)
    return None


def kernel_device_ms(fn, reps: int, kname: str) -> float:
    """Device milliseconds per launch of the kernel named kname over reps
    calls of fn(), from a torch.profiler trace (CUDA events around
    back-to-back launches time the host's launch rate once that is the
    slower side); from graph_device_ms where no trace holds the kernel's
    device events."""
    act = profiled(fn, reps, (kname,))
    if act is None:
        ms = graph_device_ms(fn, reps)
        print(f"{kname}: {ms:.4f} ms per launch by CUDA graph replay, as no "
              f"profiler trace held its device events", flush=True)
        return ms
    ms, n = next((ms, n) for name, ms, n in act[0] if kname in name)
    return ms / n


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
    t_start = time.perf_counter()

    def phase(n: int):
        """Say where the run's time goes: seconds in when phase n starts."""
        print(f"phase {n} starts {time.perf_counter() - t_start:.1f} s in",
              flush=True)

    # --- 1. environment ---
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from raytracing_cuda_tpu_torch import _build
    from raytracing_cuda_tpu_torch.app.loop import Engine
    from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa as fx
    from raytracing_cuda_tpu_torch.render.pipeline import host_packs
    from raytracing_cuda_tpu_torch.render.reference import quantize
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

    # --- 2. build, one nvcc per source, started together ---
    phase(2)
    from concurrent.futures import ThreadPoolExecutor

    print(_build.nvcc_version(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.load, ("raytrace", "fxaa")))
    print(f"built both kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name in ("raytrace", "fxaa"):
        log = _build.BUILD_LOG[name]
        print(f"built {name}: nvcc {log['seconds']:.2f} s\n{log['ptxas']}",
              flush=True)
        report[f"build_{name}_s"] = log["seconds"]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill",
                                             log["ptxas"])]
        require(bool(spills) and not any(spills),
                f"ptxas reports no spills for {name} ({spills})")

    # --- 3. kernels vs plain versions on the card, bit for bit ---
    phase(3)
    scene = build_scene()
    sky_np = procedural_skies(*SKY_SHAPE)
    sky_pack = pack_sky_all(torch.from_numpy(sky_np).to(dev))
    del sky_np
    clusters = (ISLAND_TRI_CLUSTERS, ISLAND_SPH_CLUSTERS, ISLAND_TRI_SUBS)
    classic_scene, classic_st = classic_env()
    a_err, a_mismatch, b_err = 0.0, 0, 0
    golden_bases, inputs, works = [], {}, {}
    for name, kw in [*POSES.items(), ("classic", None)]:
        sc, st, cl = ((classic_scene, classic_st, (None,) * 3) if kw is None
                      else (scene, make_state(**kw), clusters))
        coef, params, nt, ns, cu = host_packs(sc, st, H, W, None, *cl)
        coef, params, cu = coef.to(dev), params.to(dev), cu.to(dev)
        kern = torch.stack(cuda_rt.raytrace_planes(coef, params, H, W, nt, ns,
                                                   cull=cu))
        work = (dict.fromkeys(cuda_rt.WORK_KEYS, 0)
                if name in ("island_morning", "mountains_day", "worst_pose")
                else None)
        plain = torch.stack(cuda_rt.raytrace_planes_torch(
            coef, params, H, W, nt, ns, work=work, cull=cu))
        torch.cuda.synchronize()
        require(bool(torch.isfinite(kern).all()), f"{name}: kernel A planes "
                f"finite")
        mism = int(((kern[3] > 0) != (plain[3] > 0)).sum())
        err = float((kern - plain).abs().max())
        a_err, a_mismatch = max(a_err, err), max(a_mismatch, mism)
        require(err == 0.0 and mism == 0,
                f"{name}: kernel A vs plain at 720p: planes max|diff| {err}, "
                f"hit/miss mismatches {mism}")

        def base_of(planes, st=st):
            r, g, b, mw, mdx, mdy, mdz = planes
            sky = sample_sky_packed_pair(
                sky_pack, *SKY_SHAPE, torch.stack([mdx, mdy, mdz], -1),
                st.day_time / 24.0, st.sky_vars)
            return quantize(torch.stack([r, g, b], -1) + mw[..., None] * sky)

        bk = base_of(kern)
        if name in CASES:
            golden_bases.append(bk)
        fk, fp = fx.fxaa(bk), fx.fxaa_torch(bk)
        d = int((fk.int() - fp.int()).abs().max())
        b_err = max(b_err, d)
        require(d == 0, f"{name}: kernel B vs plain at 720p: max|diff| {d}")
        inputs[name] = (coef, params, nt, ns, cu, bk, kern, base_of)
        if work is not None:
            works[name] = work

    # kernel A where the last warp tiles hang over the right and bottom
    # edges: one frame per launch, and 3 frames per launch
    oh, ow = ODD_SIZE
    odd = [host_packs(scene, make_state(**POSES[n]), oh, ow, None, *clusters)
           for n in ("island_morning", "mountains_day",
                     "sea_above_everything")]
    odd_coefs = torch.stack([p[0] for p in odd]).to(dev)
    odd_params = torch.stack([p[1] for p in odd]).to(dev)
    odd_cull = odd[0][4].to(dev)
    odd_plain = cuda_rt.raytrace_planes_batch_torch(
        odd_coefs, odd_params, oh, ow, *odd[0][2:4])
    odd_k3 = cuda_rt.raytrace_planes_batch(odd_coefs, odd_params, oh, ow,
                                           *odd[0][2:4], cull=odd_cull)
    odd_k1 = cuda_rt.raytrace_planes(odd_coefs[0], odd_params[0], oh, ow,
                                     *odd[0][2:4], cull=odd_cull)
    torch.cuda.synchronize()
    odd_err = max([float((a - b).abs().max())
                   for a, b in zip(odd_k3, odd_plain)]
                  + [float((a - b[0]).abs().max())
                     for a, b in zip(odd_k1, odd_plain)])
    a_err = max(a_err, odd_err)
    require(odd_err == 0.0 and all(p.shape == (3, oh, ow) for p in odd_k3),
            f"kernel A vs plain at {oh}x{ow} (partial warp tiles), K=1 and "
            f"K=3: max|diff| {odd_err}")

    coef, params, nt, ns, cull, bk, kern, base_of = inputs["island_morning"]
    ms_a_pose = {name: cuda_ms(lambda i=inputs[name]: cuda_rt.raytrace_planes(
        i[0], i[1], H, W, i[2], i[3], cull=i[4]), 20)
        for name in ("island_morning", "mountains_day", "worst_pose",
                     "classic")}
    ms_a = ms_a_pose["island_morning"]
    ms_a_plain = cuda_ms(lambda: cuda_rt.raytrace_planes_torch(
        coef, params, H, W, nt, ns), 3)
    ms_b = cuda_ms(lambda: fx.fxaa(bk), 200)
    ms_b_plain = cuda_ms(lambda: fx.fxaa_torch(bk), 20)
    bounds_a = {name: raytrace_bound(w, inputs[name][0], inputs[name][1], 1,
                                     H, W) for name, w in works.items()}
    bound_a = bounds_a["island_morning"]
    bound_b = fxaa_bound(framed(bk[None]), halo=False)
    for name, ms in ms_a_pose.items():
        bd = bounds_a.get(name)
        print(f"kernel A raytrace 720p {name}: {ms:.4f} ms"
              + (f" (bound {bd[0]:.6f} ms, {bd[1]}; {ms / bd[0]:.1f}x)"
                 if bd else "") + f" [{card}]", flush=True)
    print(f"kernel A plain version 720p island_morning: {ms_a_plain:.4f} ms "
          f"[{card}]", flush=True)
    print(f"kernel B fxaa 720p island_morning: {ms_b:.4f} ms "
          f"(plain {ms_b_plain:.4f} ms) [{card}]", flush=True)
    print(f"bounds 720p island_morning: kernel A {bound_a[0]:.6f} ms "
          f"({bound_a[1]}; rays {works['island_morning']}), kernel B "
          f"{bound_b[0]:.6f} ms ({bound_b[1]}) [{card}]", flush=True)

    # the culls' lane efficiency: row tests the warps executed against those
    # their lanes needed (the counting launch), beside the plain version's
    # per-ray counts (cast rays: rows under the bounds reached before the
    # plane's hit; shadow rays: the unoccluded rays' rows)
    lane_eff = {}
    for name, w in works.items():
        c_coef, c_params, c_nt, c_ns, c_cull = inputs[name][:5]
        planes, cnt = cuda_rt.raytrace_planes_count(
            c_coef[None], c_params[None], H, W, c_nt, c_ns, cull=c_cull)
        require(all(torch.equal(p[0], q) for p, q in zip(planes,
                                                         inputs[name][6])),
                f"{name}: the counting launch renders the same planes")
        eff = {k: cnt[f"{k}_lane_rows"] / (32 * cnt[f"{k}_warp_rows"])
               for k in ("cast", "shadow")}
        lane_eff[name] = dict(cnt, efficiency=eff)
        print(f"lane efficiency 720p {name}: cast rows warp-executed "
              f"{cnt['cast_warp_rows']} lane-needed {cnt['cast_lane_rows']} "
              f"({eff['cast']:.2%} of 32 lanes; plain per-ray "
              f"{w['tri_tests'] + w['sph_tests']}), shadow rows "
              f"warp-executed {cnt['shadow_warp_rows']} lane-needed "
              f"{cnt['shadow_lane_rows']} ({eff['shadow']:.2%}; plain "
              f"per-ray, unoccluded rays "
              f"{w['shadow_tri_tests'] + w['shadow_sph_tests']}) [{card}]",
              flush=True)
    report.update(kernel_a_ms=ms_a_pose, lane_efficiency=lane_eff,
                  kernel_a_bounds={k: v[0] for k, v in bounds_a.items()})

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
    phase(4)
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

    # --- 5. the batch path ---
    phase(5)
    from raytracing_cuda_tpu_torch.scene.textures import (
        sample_sky_packed_pair_batch)

    def stacked_packs(states):
        packs = [host_packs(scene, st, H, W, None, *clusters)
                 for st in states]
        return (torch.stack([p[0] for p in packs]).to(dev),
                torch.stack([p[1] for p in packs]).to(dev))

    def bases_of(planes, states):
        r, g, b, mw, mdx, mdy, mdz = planes
        sky = sample_sky_packed_pair_batch(
            sky_pack, *SKY_SHAPE, torch.stack([mdx, mdy, mdz], -1),
            [st.day_time / 24.0 for st in states],
            [st.sky_vars for st in states])
        return quantize(torch.stack([r, g, b], -1) + mw[..., None] * sky)

    golden_states = [make_state(**kw) for kw in CASES.values()]
    coefs4, params4 = stacked_packs(golden_states)
    k4 = cuda_rt.raytrace_planes_batch(coefs4, params4, H, W, nt, ns,
                                       cull=cull)
    p4 = cuda_rt.raytrace_planes_batch_torch(coefs4, params4, H, W, nt, ns)
    singles = [cuda_rt.raytrace_planes(coefs4[k], params4[k], H, W, nt, ns,
                                       cull=cull) for k in range(4)]
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(k4, p4)),
            "kernel A K=4 (golden states) equals its plain version bit for "
            "bit")
    require(all(torch.equal(k4[p][k], singles[k][p]) for p in range(7)
                for k in range(4)),
            "kernel A K=4 equals 4 single-frame launches bit for bit")

    # K = 8: the golden states and 4 animated ones, at the main path's K
    anim = [sim.animate(golden_states[0], a, 1 / 30)
            for a in varied_actions(4)]
    states8 = golden_states + anim
    coefs8, params8 = stacked_packs(states8)
    k8 = cuda_rt.raytrace_planes_batch(coefs8, params8, H, W, nt, ns,
                                       cull=cull)
    p8, ms_a8_plain = timed(lambda: cuda_rt.raytrace_planes_batch_torch(
        coefs8, params8, H, W, nt, ns))
    work8 = dict.fromkeys(cuda_rt.WORK_KEYS, 0)     # counted apart, untimed
    cuda_rt.raytrace_planes_batch_torch(coefs8, params8, H, W, nt, ns,
                                        work=work8, cull=cull)
    bound_a8 = raytrace_bound(work8, coefs8, params8, BATCH, H, W)
    a8_err = max(float((a - b).abs().max()) for a, b in zip(k8, p8))
    require(a8_err == 0.0, f"kernel A K=8 vs plain max|diff| {a8_err}")
    ms_a8 = cuda_ms(lambda: cuda_rt.raytrace_planes_batch(
        coefs8, params8, H, W, nt, ns, cull=cull), 10)
    print(f"kernel A 720p: K=8 {ms_a8:.4f} ms per launch = "
          f"{ms_a8 / BATCH:.4f} ms per frame vs K=1 {ms_a:.4f} ms per frame "
          f"(plain K=8 {ms_a8_plain:.4f} ms) [{card}]", flush=True)

    base8 = bases_of(k8, states8)
    bound_b8 = fxaa_bound(framed(base8), halo=False)
    fb8 = fx.fxaa_batch(base8)
    fb8_plain = fx.fxaa_batch_torch(base8)
    fb8_err = int((fb8.int() - fb8_plain.int()).abs().max())
    require(fb8_err == 0, f"kernel B K=8 vs plain max|diff| {fb8_err}")
    require(all(torch.equal(fb8[k], fx.fxaa(base8[k])) for k in range(8)),
            "kernel B K=8 equals per-frame launches bit for bit")
    ms_b8 = cuda_ms(lambda: fx.fxaa_batch(base8), 100)
    ms_b8_plain = cuda_ms(lambda: fx.fxaa_batch_torch(base8), 5)
    print(f"kernel B 720p: K=8 {ms_b8:.4f} ms per launch = "
          f"{ms_b8 / BATCH:.4f} ms per frame vs K=1 {ms_b:.4f} ms "
          f"(plain K=8 {ms_b8_plain:.4f} ms) [{card}]", flush=True)

    acts = varied_actions(BATCH)
    dts = [1 / 60 + 0.01 * i for i in range(BATCH)]
    st0 = make_state(9.5)            # the 8-10 h crossfade: two panoramas
    eng.set_state(st0)
    reset_counts()
    imgs = eng.step_and_frame_batch(acts, dts)
    torch.cuda.synchronize()
    counts = read_counts()
    end_batch = eng.state
    eng.set_state(st0)
    seq = [eng.step_and_frame(a, dt) for a, dt in zip(acts, dts)]
    require(all(torch.equal(imgs[k], seq[k]) for k in range(BATCH))
            and states_equal(end_batch, eng.state),
            f"step_and_frame_batch of {BATCH} equals {BATCH} step_and_frame "
            f"calls (frames and end state)")
    require(counts["raytrace_megakernel_k8"] == 1 and counts["fxaa_k8"] == 1
            and counts["raytrace_megakernel_k8_frames"] == BATCH,
            f"step_and_frame_batch launched each batch kernel once: {counts}")

    fps = {}
    batch_counts = None
    for label, batch in (("single", 1), ("batch8", BATCH), ("batch8", BATCH),
                         ("single", 1)):
        eng.set_state(make_state(6.0))
        reset_counts()
        st = eng.run(args.frames, batch=batch)
        if batch > 1:
            batch_counts = read_counts()
        fps.setdefault(label, []).append(st.fps)
        ms = sorted(st.frame_ms)
        print(f"Engine.run({args.frames}, batch={batch}) 1280x720 island: "
              f"{st.fps:.2f} fps, frame ms median {ms[len(ms) // 2]:.4f} "
              f"(CUDA events) [{card}]", flush=True)
    print(f"run fps single {fps['single']} vs batch={BATCH} {fps['batch8']}",
          flush=True)
    print(f"launch counts in Engine.run(batch={BATCH}): {batch_counts}",
          flush=True)
    require(batch_counts["raytrace_megakernel_k8"] > 0
            and batch_counts["fxaa_k8"] > 0,
            "both batch kernel forms launched by run(batch=8)")
    report.update(batch={"fps": fps, "counts": batch_counts,
                         "kernel_a_k8_ms": ms_a8, "fxaa_k8_ms": ms_b8})

    # --- 6. the CLI, in-process ---
    phase(6)
    from raytracing_cuda_tpu_torch import __main__ as cli
    from raytracing_cuda_tpu_torch.utils.checkpoint import save_state

    with tempfile.TemporaryDirectory() as tmp:
        common = ["--size", f"{W}x{H}", "--path", "cuda"]

        def run_cli(*argv):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main([*argv, *common])
            require(rc == 0, f"cli {' '.join(argv)} exits 0")
            return out.getvalue()

        def cli_state(*argv):
            return cli.build_state(cli._parser().parse_args(
                [*argv, *common]), cli_eng.state)

        cli_eng = Engine(RenderConfig(width=W, height=H, sky_source="auto",
                                      procedural_sky_shape=(1024, 2048)),
                         device=DEVICE)
        fresh = cli_eng.state
        run_cli("render", f"{tmp}/r.png", "--day", "14", "--cam", "1")
        cli_eng.set_state(cli_state("render", "--day", "14", "--cam", "1"))
        require(np.array_equal(load_png(f"{tmp}/r.png"), cli_eng.frame_np()),
                "cli render equals the Engine frame of the same state")

        rec = f"{tmp}/rec"
        reset_counts()
        run_cli("record", rec, "--frames", "20")
        rec_counts = read_counts()
        require(rec_counts["raytrace_megakernel_k8"] == 2
                and rec_counts["fxaa_k8"] == 2,
                f"cli record ran 2 batches of {BATCH}: {rec_counts}")
        require(sorted(os.listdir(rec)) == [f"{i:04d}.png"
                                            for i in range(20)],
                "cli record wrote 20 PNGs")
        cli_eng.set_state(fresh)
        want = {}
        for i in range(20):
            img = cli_eng.step_and_frame(cli.scripted_action(i),
                                         cli.RECORD_DT)
            if i in (0, 8, 19):
                want[i] = img.cpu().numpy()
        for i, img in want.items():
            require(np.array_equal(load_png(f"{rec}/{i:04d}.png"), img),
                    f"cli record frame {i} equals the scripted Engine frame")

        before = {i: open(f"{rec}/{i:04d}.png", "rb").read()
                  for i in range(14, 20)}
        for i in range(15, 20):
            os.remove(f"{rec}/{i:04d}.png")
        run_cli("record", rec, "--frames", "20", "--resume")
        require(all(open(f"{rec}/{i:04d}.png", "rb").read() == before[i]
                    for i in range(14, 20)),
                "cli record --resume rewrote frames 14-19 byte-identical")

        saved = sim.animate(make_state(18.0, sea=2.0), varied_actions(2)[1],
                            0.3)
        save_state(saved, f"{tmp}/s.json")
        run_cli("render", f"{tmp}/s.png", "--state", f"{tmp}/s.json")
        cli_eng.set_state(saved)
        require(np.array_equal(load_png(f"{tmp}/s.png"), cli_eng.frame_np()),
                "cli render --state renders the saved state")

        bench = ast.literal_eval(
            run_cli("bench", "--frames", "60").strip().splitlines()[-1])
        print(f"cli bench --frames 60: {bench} [{card}]", flush=True)
        require(bench["frames"] == 60 and bench["fps"] > 0,
                "cli bench prints its stats")
        report["cli_bench"] = bench

    # --- 7. profile 30 loop frames ---
    phase(7)
    eng.set_state(make_state(6.0))
    for _ in range(5):
        eng.step_and_frame()
    act = profiled(eng.step_and_frame, 30, ("raytrace_kernel", "fxaa_kernel"))
    require(act is not None, "a torch.profiler trace of 30 loop frames "
            "holds device events")
    top, busy_ms, window_ms = act
    # the profiler slows the host half, so also hold the device work per
    # frame against the same 30 frames run without it
    t0 = time.perf_counter()
    for _ in range(30):
        eng.step_and_frame()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / 30
    print(f"profile of 30 loop frames: device busy {busy_ms:.4f} ms of a "
          f"{window_ms:.4f} ms window = {busy_ms / max(window_ms, 1e-9):.2%}"
          f" (torch.profiler); device work {busy_ms / 30:.4f} ms per frame "
          f"= {busy_ms / 30 / frame_ms:.2%} of an unprofiled frame "
          f"({frame_ms:.4f} ms, host clock) [{card}]", flush=True)
    for rank, (name, ms_tot, n) in enumerate(top[:5], 1):
        print(f"  top {rank}: {ms_tot:.4f} ms in {n} calls: {name[:100]}",
              flush=True)
    names = [t[0] for t in top]
    for kname in ("raytrace_kernel", "fxaa_kernel"):
        ranks = [i + 1 for i, n in enumerate(names) if kname in n]
        require(bool(ranks), f"the profile names {kname} (rank {ranks})")
    report["profile"] = {"busy_ms": busy_ms, "window_ms": window_ms,
                         "unprofiled_frame_ms": frame_ms,
                         "top": top[:5]}

    # --- 8. parallel/: row bands, frame DP, the hybrid ---
    phase(8)
    from raytracing_cuda_tpu_torch.parallel.mesh import (
        render_frame_sharded, replicate)

    # kernel B's band form against its plain version and the full frame
    band_err, assembled = 0, True
    for base in golden_bases:
        full = fx.fxaa(base)
        for n in (2, 4, 8):
            parts = []
            for row0, ext in halo_bands(base, n):
                out = fx.fxaa_ext(ext, row0, H)
                ref = fx.fxaa_ext_torch(ext, row0, H)
                band_err = max(band_err, int((out.int() - ref.int()).abs()
                                             .max()))
                parts.append(out)
            assembled &= torch.equal(torch.cat(parts), full)
    require(band_err == 0, f"kernel B band form (2, 4, 8 bands of the 4 "
            f"golden bases) vs plain max|diff| {band_err}")
    require(assembled, "kernel B bands assembled equal the full-frame "
            "kernel bit for bit")
    row0, ext = list(halo_bands(golden_bases[0], 4))[1]
    ext4 = torch.stack([list(halo_bands(b, 4))[1][1] for b in golden_bases])
    require(torch.equal(fx.fxaa_ext(ext4, row0, H),
                        fx.fxaa_ext_torch(ext4, row0, H)),
            "kernel B K=4 band form equals its plain version bit for bit")
    ms_band = cuda_ms(lambda: fx.fxaa_ext(ext, row0, H), 200)
    ms_band_plain = cuda_ms(lambda: fx.fxaa_ext_torch(ext, row0, H), 20)
    ms_full = cuda_ms(lambda: fx.fxaa(golden_bases[0]), 200)
    bound_band = fxaa_bound(ext[None], row0, H)
    print(f"kernel B band form, 180-row band at row0 {row0} of 720p: "
          f"{ms_band:.4f} ms (plain {ms_band_plain:.4f} ms, bound "
          f"{bound_band[0]:.6f} ms, {bound_band[1]}) vs full frame "
          f"{ms_full:.4f} ms (CUDA events) [{card}]", flush=True)
    dev_band = kernel_device_ms(lambda: fx.fxaa_ext(ext, row0, H), 50,
                                "fxaa_kernel")
    dev_full = kernel_device_ms(lambda: fx.fxaa(golden_bases[0]), 50,
                                "fxaa_kernel")
    graph_band = graph_device_ms(lambda: fx.fxaa_ext(ext, row0, H), 50)
    graph_full = graph_device_ms(lambda: fx.fxaa(golden_bases[0]), 50)
    print(f"kernel B device time per launch (torch.profiler): 180-row band "
          f"{dev_band:.4f} ms, full frame {dev_full:.4f} ms (by CUDA graph "
          f"replay: {graph_band:.4f} ms, {graph_full:.4f} ms) [{card}]",
          flush=True)
    # kernel A at the sharded loop's launches: the bands of the 4-band
    # split, each against its plain version
    sub = H // 4
    a_band_err, work_band = 0.0, dict.fromkeys(cuda_rt.WORK_KEYS, 0)
    for r0 in range(0, H, sub):
        kb = cuda_rt.raytrace_planes_batch(coef[None], params[None], sub, W,
                                           nt, ns, row0=r0, total_h=H,
                                           cull=cull)
        pb, ms = timed(lambda r0=r0: cuda_rt.raytrace_planes_batch_torch(
            coef[None], params[None], sub, W, nt, ns, row0=r0, total_h=H))
        a_band_err = max([a_band_err] + [float((a - b).abs().max())
                                         for a, b in zip(kb, pb)])
        if r0 == sub:
            ms_a_band_plain = ms
    cuda_rt.raytrace_planes_batch_torch(
        coef[None], params[None], sub, W, nt, ns, row0=sub, total_h=H,
        work=work_band, cull=cull)
    require(a_band_err == 0.0, f"kernel A bands of the 4-band split (row0 "
            f"0, {sub}, {2 * sub}, {3 * sub}) vs plain max|diff| "
            f"{a_band_err}")
    ms_a_band = cuda_ms(lambda: cuda_rt.raytrace_planes_batch(
        coef[None], params[None], sub, W, nt, ns, row0=sub, total_h=H,
        cull=cull), 20)
    bound_a_band = raytrace_bound(work_band, coef[None], params[None], 1,
                                  sub, W)
    # events around back-to-back launches of a launch this short time the
    # host's launch rate; a CUDA graph's replay times the device alone
    graph_a_band = graph_device_ms(lambda: cuda_rt.raytrace_planes_batch(
        coef[None], params[None], sub, W, nt, ns, row0=sub, total_h=H,
        cull=cull), 20)
    graph_a = graph_device_ms(lambda: cuda_rt.raytrace_planes(
        coef, params, H, W, nt, ns, cull=cull), 20)
    print(f"kernel A, {sub}-row band at row0 {sub} of 720p island_morning: "
          f"{ms_a_band:.4f} ms (plain {ms_a_band_plain:.4f} ms, bound "
          f"{bound_a_band[0]:.6f} ms, {bound_a_band[1]}) vs full frame "
          f"{ms_a:.4f} ms (CUDA events); device time by CUDA graph replay: "
          f"band {graph_a_band:.4f} ms, full frame {graph_a:.4f} ms "
          f"[{card}]", flush=True)

    # render_frame_sharded against the Engine frame, FXAA on and off
    mismatch = []
    for name, kw in CASES.items():
        for aa in (True, False):
            st = make_state(**dict(kw, aa=aa))
            eng.set_state(st)
            ref = eng.frame()
            for n, il in ((2, 1), (4, 1), (8, 1), (4, 2)):
                img = render_frame_sharded(
                    scene, st, replicate(sky_pack, [dev]), *SKY_SHAPE,
                    mesh=[DEVICE] * n, height=H, width=W, interleave=il,
                    tri_clusters=ISLAND_TRI_CLUSTERS,
                    sph_clusters=ISLAND_SPH_CLUSTERS, t_subs=ISLAND_TRI_SUBS)
                if not torch.equal(img, ref):
                    mismatch.append((name, aa, n, il))
    require(not mismatch, f"render_frame_sharded (n 2/4/8, interleave 2 at "
            f"n 4; 4 golden states, FXAA on and off) equals the Engine frame "
            f"bit for bit; mismatches {mismatch}")

    # the main path of this slice: a sharded Engine's loop
    cfg = RenderConfig(width=W, height=H, procedural_sky_shape=SKY_SHAPE)
    eng_sh = Engine(cfg, DEVICE, sharded=[DEVICE] * 4,
                    share_assets_from=eng)
    par_fps = {}
    for label, e in (("single", eng), ("sharded4", eng_sh),
                     ("sharded4", eng_sh), ("single", eng)):
        e.set_state(make_state(6.0))
        reset_counts()
        st = e.run(30)
        counts = read_counts()
        if e is eng_sh:
            band_counts = counts
        par_fps.setdefault(label, []).append(st.fps)
        ms = sorted(st.frame_ms)
        print(f"Engine{'(sharded=[cuda:0] * 4)' if e is eng_sh else ''}"
              f".run(30) 1280x720 island: {st.fps:.2f} fps, frame ms "
              f"median {ms[len(ms) // 2]:.4f} (CUDA events; bands "
              f"serialised on one card) [{card}]", flush=True)
    print(f"launch counts in Engine(sharded=4 bands).run(30): {band_counts}",
          flush=True)
    require(band_counts["fxaa_band"] > 0
            and band_counts["raytrace_megakernel_k8"] > 0,
            "the sharded loop launched kernel A and kernel B's band form")
    require(band_counts["fxaa"] == 0 and band_counts["raytrace_megakernel"]
            == 0, "the sharded loop ran no full-frame launch")

    # frame DP and the hybrid against step_and_frame
    acts = varied_actions(16)
    st0 = make_state(9.5)
    eng.set_state(st0)
    seq = torch.stack([eng.step_and_frame(a, 1 / 30) for a in acts])
    end = eng.state
    eng_dp = Engine(dataclasses.replace(cfg, shard_interleave=2), DEVICE,
                    share_assets_from=eng)
    script_counts = {}
    for label, kw in (("frame DP over [cuda:0] * 2",
                       dict(mesh=[DEVICE] * 2)),
                      ("hybrid 2 x 2, interleave 2",
                       dict(n_rows=2, mesh=[[DEVICE] * 2] * 2))):
        eng_dp.set_state(st0)
        reset_counts()
        imgs = eng_dp.render_script_dp(acts, dt=1 / 30, **kw)
        torch.cuda.synchronize()
        script_counts[label] = read_counts()
        require(torch.equal(imgs, seq) and states_equal(eng_dp.state, end),
                f"Engine.render_script_dp, {label}: 16 frames and end state "
                f"equal 16 step_and_frame calls")
    print(f"launch counts in render_script_dp: {script_counts}", flush=True)

    # the CLI: --dp needs distinct cards; --dp 1 --dp-rows 1 is plain record
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--frames", "4", "--size", f"{W}x{H}", "--path", "cuda"]
        if torch.cuda.device_count() == 1:
            try:
                rc, msg = cli.main(["record", f"{tmp}/dp", "--dp", "2",
                                    *argv]), ""
            except SystemExit as e:
                rc, msg = e.code, str(e)
            require(rc not in (0, None) and "available" in msg
                    and not os.path.exists(f"{tmp}/dp"),
                    f"cli record --dp 2 on one card exits {rc} before any "
                    f"frame: {msg}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["record", f"{tmp}/dp1", "--dp", "1", "--dp-rows",
                           "1", *argv])
        require(rc == 0 and len(os.listdir(f"{tmp}/dp1")) == 4,
                "cli record --dp 1 --dp-rows 1 writes its 4 frames")
    report["parallel"] = {"fxaa_band_ms": ms_band, "fxaa_full_ms": ms_full,
                          "fxaa_band_device_ms": dev_band,
                          "raytrace_band_ms": ms_a_band,
                          "raytrace_band_graph_ms": graph_a_band,
                          "raytrace_full_graph_ms": graph_a,
                          "raytrace_band_max_abs_err": a_band_err,
                          "fxaa_full_device_ms": dev_full,
                          "fps": par_fps, "counts": band_counts,
                          "script_counts": script_counts}

    # --- 9. the fast and oracle paths, the preview and the readback ---
    phase(9)
    from raytracing_cuda_tpu_torch.app.window import Readback
    from raytracing_cuda_tpu_torch.utils.images import box_downsample

    eng_path = {"oracle": Engine(dataclasses.replace(cfg, path="oracle"),
                                 DEVICE)}
    eng_path["fast"] = Engine(dataclasses.replace(cfg, path="fast"), DEVICE,
                              share_assets_from=eng_path["oracle"])
    path_stats, path_ms = {}, {}
    for name, kw in CASES.items():
        st = make_state(**kw)
        eng.set_state(st)
        kernel_img = eng.frame_np()
        gold = load_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
        for path, e in eng_path.items():
            e.set_state(st)
            img = e.frame_np()
            require(img.shape == (H, W, 3) and img.dtype == np.uint8,
                    f"{name}: {path} frame shape {img.shape} {img.dtype}")
            vs_gold, vs_kernel = (golden_stats(img, gold),
                                  golden_stats(img, kernel_img))
            path_stats[f"{path}_{name}"] = {"golden": vs_gold,
                                            "kernel_path": vs_kernel}
            require(all(rm < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC
                        for rm, off in (vs_gold, vs_kernel)),
                    f"{name}: Engine(path={path}) vs golden rmse "
                    f"{vs_gold[0]:.5f} off>2 {vs_gold[1]:.4%}; vs the "
                    f"megakernel path rmse {vs_kernel[0]:.5f} off>2 "
                    f"{vs_kernel[1]:.4%}")
    classic_cfg = dataclasses.replace(cfg, scene="classic",
                                      procedural_sky_shape=(1024, 2048))
    classic_frames = {}
    for path in ("auto", "oracle", "fast"):
        e = Engine(dataclasses.replace(classic_cfg, path=path), DEVICE)
        e.set_state(classic_st)
        classic_frames[path] = e.frame_np()
        del e
    for path in ("oracle", "fast"):
        rm, off = golden_stats(classic_frames[path], classic_frames["auto"])
        path_stats[f"{path}_classic"] = {"kernel_path": (rm, off)}
        require(rm < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC,
                f"classic: Engine(path={path}) vs the megakernel path rmse "
                f"{rm:.5f} off>2 {off:.4%}")
    torch.cuda.empty_cache()

    # frame times of both paths (the frame of island_morning, FXAA on):
    # one frame each after the warm-up one, as a frame takes 0.2-1.3 s
    for path, e in eng_path.items():
        e.set_state(make_state(6.0))
        path_ms[path] = cuda_ms(e.frame, 1)
    print(f"Engine.frame() 1280x720 island_morning: path oracle "
          f"{path_ms['oracle']:.4f} ms (chunk {cfg.chunk}), path fast "
          f"{path_ms['fast']:.4f} ms (chunk {cfg.chunk}, a host decision "
          f"per early exit) (CUDA events) [{card}]", flush=True)

    # fast: chunk size never changes a pixel
    st = make_state(**CASES["mountains_day"])
    chunked, chunks = [], (16384, 65536)
    for chunk in chunks:
        e = Engine(dataclasses.replace(cfg, path="fast", chunk=chunk), DEVICE,
                   share_assets_from=eng_path["fast"])
        e.set_state(st)
        chunked.append(e.frame())
        path_ms[f"fast_chunk{chunk}"] = cuda_ms(e.frame, 1)
    require(torch.equal(*chunked), f"Engine(path=fast) at chunks {chunks}: "
            f"frames equal bit for bit")
    print("Engine(path=fast).frame() 1280x720 mountains_day: "
          + ", ".join(f"chunk {c} {path_ms[f'fast_chunk{c}']:.4f} ms"
                      for c in chunks) + f" (CUDA events) [{card}]",
          flush=True)

    # a row-sharded fast Engine against the unsharded one
    eng_fast_sh = Engine(dataclasses.replace(cfg, path="fast"), DEVICE,
                         sharded=[DEVICE] * 4,
                         share_assets_from=eng_path["fast"])
    mismatch = []
    for name, kw in CASES.items():
        st = make_state(**kw)
        eng_path["fast"].set_state(st)
        eng_fast_sh.set_state(st)
        if not torch.equal(eng_fast_sh.frame(), eng_path["fast"].frame()):
            mismatch.append(name)
    require(not mismatch, f"Engine(path=fast, sharded=[cuda:0] * 4) equals "
            f"the unsharded Engine bit for bit; mismatches {mismatch}")

    # sky_cache=False: blend + pack per frame against the static stack
    eng_one_shot = Engine(dataclasses.replace(cfg, sky_cache=False), DEVICE,
                          share_assets_from=eng_path["fast"])
    mismatch = []
    for name, kw in [*CASES.items(), ("crossfade", dict(day=9.5))]:
        st = make_state(**kw)
        eng.set_state(st)
        eng_one_shot.set_state(st)
        if not torch.equal(eng_one_shot.frame(), eng.frame()):
            mismatch.append(name)
    require(not mismatch, f"Engine(sky_cache=False) equals the default "
            f"Engine's frame bit for bit; mismatches {mismatch}")
    del eng_one_shot, eng_fast_sh, chunked

    # the CLI on these paths, and the window where pygame is absent
    with tempfile.TemporaryDirectory() as tmp:
        sky_flags = ["--sky-shape", f"{SKY_SHAPE[1]}x{SKY_SHAPE[0]}"]
        for path, e in eng_path.items():
            flags = ["--size", f"{W}x{H}", "--path", path, "--day", "14",
                     "--cam", "1", *sky_flags]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["render", f"{tmp}/{path}.png", *flags])
            e.set_state(cli.build_state(cli._parser().parse_args(
                ["render", *flags]), make_state(6.0)))
            require(rc == 0 and np.array_equal(load_png(f"{tmp}/{path}.png"),
                                               e.frame_np()),
                    f"cli render --path {path} equals the Engine(path="
                    f"{path}) frame of the same state")
        if importlib.util.find_spec("pygame") is None:
            err = io.StringIO()
            try:
                with contextlib.redirect_stderr(err):
                    rc = cli.main(["window", "--size", f"{W}x{H}"])
            except SystemExit as e:
                rc = e.code
            require(rc not in (0, None) and "pygame" in err.getvalue(),
                    f"cli window without pygame exits {rc} naming it")
        else:
            print("pygame is installed here: cli window's refusal without "
                  "it is not checked", flush=True)

    # the viewer's frame without a display: the preview downsample on the
    # device, then the loop through the readback ring; these are this
    # phase's main path, so the counters are read around them
    eng_pre = {p: Engine(dataclasses.replace(cfg, preview=p), DEVICE,
                         share_assets_from=eng) for p in (2, 4)}
    for p, e in eng_pre.items():
        st = make_state(**CASES["island_night"])
        e.set_state(st)
        eng.set_state(st)
        reset_counts()
        small = e.step_and_frame_preview()
        torch.cuda.synchronize()
        counts = read_counts()
        require(counts["raytrace_megakernel"] == 1 and counts["fxaa"] == 1,
                f"step_and_frame_preview (preview {p}) launched kernel A "
                f"and kernel B once each: {counts}")
        require(small.shape == (H // p, W // p, 3)
                and np.array_equal(small.cpu().numpy(),
                                   box_downsample(eng.step_and_frame(), p)),
                f"step_and_frame_preview (preview {p}) equals "
                f"box_downsample of the full frame bit for bit")

    def ring_loop(e, step, keep: bool, n=30):
        """n frames of the window's loop body without pygame: render,
        submit to the ring, take the previous frame's host copy and copy
        it out (the viewer blits it). keep=True keeps every frame rendered
        (on the card) and every frame handed back, to compare them;
        keep=False keeps none, as the viewer, and is the loop to time.
        → (rendered, shown, host ms per frame: in all, and of that in the
        render call, in submit (copy enqueued, previous copy awaited) and
        in the copy out)."""
        ring, rendered, shown, blit = Readback(), [], [], None
        e.set_state(make_state(6.0))
        torch.cuda.synchronize()
        t_step = t_submit = t_blit = 0.0
        t0 = time.perf_counter()
        for _ in range(n):
            ta = time.perf_counter()
            frame = step()
            tb = time.perf_counter()
            host = ring.submit(frame)
            tc = time.perf_counter()
            if keep:
                rendered.append(frame)
                if host is not None:
                    shown.append(host.clone())
            elif host is not None:
                blit = host.clone() if blit is None else blit.copy_(host)
            t_step, t_submit, t_blit = (t_step + tb - ta, t_submit + tc - tb,
                                        t_blit + time.perf_counter() - tc)
        last = ring.flush()        # waits for the last frame's copy
        if keep:
            shown.append(last.clone())
        total = time.perf_counter() - t0
        return rendered, shown, [round(t * 1e3 / n, 4)
                                 for t in (total, t_step, t_submit, t_blit)]

    reset_counts()
    rendered, shown, _ = ring_loop(eng, eng.step_and_frame, keep=True)
    ring_counts = read_counts()
    require(len(shown) == 30 and all(
        torch.equal(s, r.cpu()) for s, r in zip(shown, rendered)),
        "the readback ring hands back each of 30 loop frames unchanged, one "
        "iteration late")
    require(ring_counts["raytrace_megakernel"] == 30
            and ring_counts["fxaa"] == 30,
            f"the window's loop launched kernel A and kernel B once per "
            f"frame: {ring_counts}")
    _, shown4, _ = ring_loop(eng_pre[4], eng_pre[4].step_and_frame_preview,
                             keep=True)
    require(all(torch.equal(s, torch.from_numpy(box_downsample(r.cpu(), 4)))
                for s, r in zip(shown4, rendered)),
            "the ring's preview-4 frames equal box_downsample of the "
            "full-size loop frames")
    del rendered, shown, shown4
    loop_ms = {"ring": [], "ring_preview4": [], "run": []}
    for _ in range(2):               # in turns: the host's rate drifts
        loop_ms["ring"].append(
            ring_loop(eng, eng.step_and_frame, keep=False)[2])
        eng.set_state(make_state(6.0))
        loop_ms["run"].append(1e3 / eng.run(30).fps)
        loop_ms["ring_preview4"].append(ring_loop(
            eng_pre[4], eng_pre[4].step_and_frame_preview, keep=False)[2])
    print(f"window loop without a display, 30 frames 1280x720 island, host "
          f"ms per frame [in all, render call, ring submit, copy out], two "
          f"turns each: through the readback ring {loop_ms['ring']} (2.76 "
          f"MB per frame to pinned memory), at preview 4 "
          f"{loop_ms['ring_preview4']}, beside Engine.run(30) "
          f"{loop_ms['run']} in all with no readback [{card}]", flush=True)
    report["paths"] = {"stats": path_stats, "frame_ms": path_ms,
                       "loop_ms": loop_ms, "ring_counts": ring_counts}

    # --- 10. other sizes: 1920x1080 against its goldens, 640x480 ---
    phase(10)

    def base_from(planes, st):
        """Kernel A's planes of state st → the (..., 3) uint8 frame before
        FXAA (the sky lookup and quantize, torch ops)."""
        r, g, b, mw, mdx, mdy, mdz = planes
        sk = sample_sky_packed_pair(
            eng.sky_pack, *SKY_SHAPE, torch.stack([mdx, mdy, mdz], -1),
            st.day_time / 24.0, st.sky_vars)
        return quantize(torch.stack([r, g, b], -1) + mw[..., None] * sk)

    def held_frame(label, h, w, st):
        """Both kernels' full-frame wrappers against their plain versions,
        bit for bit, on the h x w frame of state st → (kernel A's launch,
        its planes, the frame before FXAA)."""
        coef_h, params_h, nt_, ns_, cull_h = host_packs(scene, st, h, w,
                                                        None, *clusters)
        coef_d, params_d, cull_d = (t.to(dev) for t in (coef_h, params_h,
                                                        cull_h))

        def run_a():
            return cuda_rt.raytrace_planes(coef_d, params_d, h, w, nt_, ns_,
                                           cull=cull_d)

        planes = run_a()
        plain = cuda_rt.raytrace_planes_torch(coef_d, params_d, h, w, nt_,
                                              ns_)
        base = base_from(planes, st)
        a_ok = all(torch.equal(a, b) for a, b in zip(planes, plain))
        b_ok = torch.equal(fx.fxaa(base), fx.fxaa_torch(base))
        require(a_ok and b_ok, f"{label}: kernel A and kernel B at {w}x{h} "
                f"equal their plain versions bit for bit (A {a_ok}, B "
                f"{b_ok})")
        return run_a, planes, base

    def held_bands(label, h, w, states, n):
        """The launches parallel/ makes for K = len(states) frames of h x w:
        both kernels' K-frame forms on whole frames, then on each of n row
        bands (kernel A at row0 of total_h, kernel B with its halo rows),
        against their plain versions bit for bit; the bands assembled must
        equal the whole-frame launches."""
        packs = [host_packs(scene, st, h, w, None, *clusters)
                 for st in states]
        coefs = torch.stack([p[0] for p in packs]).to(dev)
        params_ = torch.stack([p[1] for p in packs]).to(dev)
        nt_, ns_, cull_d = packs[0][2], packs[0][3], packs[0][4].to(dev)
        full = cuda_rt.raytrace_planes_batch(coefs, params_, h, w, nt_, ns_,
                                             cull=cull_d)
        a_ok = all(torch.equal(a, b) for a, b in zip(
            full, cuda_rt.raytrace_planes_batch_torch(coefs, params_, h, w,
                                                      nt_, ns_)))
        bases = torch.stack([base_from([p[k] for p in full], st)
                             for k, st in enumerate(states)])
        whole = fx.fxaa_batch(bases)
        b_ok = torch.equal(whole, fx.fxaa_batch_torch(bases))
        sub = h // n
        exts = [list(halo_bands(b, n)) for b in bases]
        for c in range(n):
            r0 = c * sub
            kb = cuda_rt.raytrace_planes_batch(
                coefs, params_, sub, w, nt_, ns_, row0=r0, total_h=h,
                cull=cull_d)
            pb = cuda_rt.raytrace_planes_batch_torch(
                coefs, params_, sub, w, nt_, ns_, row0=r0, total_h=h)
            a_ok &= all(torch.equal(a, b) and torch.equal(
                a, f[:, r0:r0 + sub]) for a, b, f in zip(kb, pb, full))
            ext = torch.stack([e[c][1] for e in exts])
            out = fx.fxaa_ext(ext, r0, h)
            b_ok &= (torch.equal(out, fx.fxaa_ext_torch(ext, r0, h))
                     and torch.equal(out, whole[:, r0:r0 + sub]))
        require(a_ok and b_ok, f"{label}: K={len(states)} frames of {w}x{h} "
                f"and their {n} bands of {sub} rows: kernel A and kernel B "
                f"equal their plain versions and the whole-frame launches "
                f"bit for bit (A {a_ok}, B {b_ok})")

    def stage_ms(h, w, st):
        """held_frame on the h x w frame of state st, then the device ms of
        kernel A (CUDA graph replay), of the sky lookup + quantize between
        the kernels (CUDA events: torch ops, which read the state's host
        scalars) and of kernel B (graph replay)."""
        run_a, planes, base = held_frame(f"{w}x{h}", h, w, st)
        return {"raytrace": graph_device_ms(run_a, 20),
                "sky_quantize": cuda_ms(lambda: base_from(planes, st), 50),
                "fxaa": graph_device_ms(lambda: fx.fxaa(base), 50)}

    eng_1080 = eng.resized(1920, 1080)
    sizes = {}
    reset_counts()
    for name, kw in CASES.items():
        eng_1080.set_state(make_state(**kw))
        img = eng_1080.frame_np()
        require(img.shape == (1080, 1920, 3) and img.dtype == np.uint8,
                f"{name}: 1080p frame shape {img.shape} {img.dtype}")
        rm, off = golden_stats(img, load_png(os.path.join(
            GOLDEN_DIR, "1920x1080", f"{name}.png")))
        sizes[f"golden_1080p_{name}"] = {"rmse": rm, "off_frac": off}
        require(rm < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC,
                f"{name}: 1920x1080 Engine frame vs golden rmse {rm:.5f} "
                f"off>2 {off:.4%}")
    counts = read_counts()
    require(counts["raytrace_megakernel"] == 4 and counts["fxaa"] == 3,
            f"the 1080p frames launched kernel A 4 times and kernel B 3 "
            f"times (one state has FXAA off): {counts}")
    for name, kw in CASES.items():
        if name != "island_morning":        # that one: stage_ms below
            held_frame(name, 1080, 1920, make_state(**kw))
    sizes["1920x1080"] = stage_ms(1080, 1920, make_state(**CASES[
        "island_morning"]))
    eng_1080.set_state(make_state(6.0))
    st1080 = eng_1080.run(60)
    ms = sorted(st1080.frame_ms)
    print(f"1920x1080 island_morning device ms: kernel A "
          f"{sizes['1920x1080']['raytrace']:.4f} (CUDA graph replay), sky + "
          f"quantize {sizes['1920x1080']['sky_quantize']:.4f} (CUDA "
          f"events), kernel B {sizes['1920x1080']['fxaa']:.4f} (graph "
          f"replay); Engine.run(60) {st1080.fps:.2f} fps, frame ms median "
          f"{ms[len(ms) // 2]:.4f} [{card}]", flush=True)
    del eng_1080

    st480 = bench_torch.preset_state(day=14.0, cam_preset=1, aa=False)
    eng_480 = eng.resized(640, 480)
    eng_480.set_state(st480)
    reset_counts()
    img = eng_480.frame_np()
    counts = read_counts()
    require(counts["raytrace_megakernel"] == 1 and counts["fxaa"] == 0,
            f"the 640x480 frame (FXAA off) launched kernel A once and "
            f"kernel B never: {counts}")
    eng_cpu = Engine(RenderConfig(width=640, height=480,
                                  procedural_sky_shape=SKY_SHAPE),
                     device="cpu")
    eng_cpu.set_state(st480)
    rm, off = golden_stats(img, eng_cpu.frame_np())
    del eng_cpu, eng_480
    sizes["640x480_vs_cpu"] = {"rmse": rm, "off_frac": off}
    require(img.shape == (480, 640, 3) and rm < GOLDEN_RMSE
            and off < GOLDEN_OFF_FRAC,
            f"640x480 mountains, FXAA off: Engine frame on the card vs the "
            f"CPU Engine's rmse {rm:.5f} off>2 {off:.4%}")
    sizes["640x480"] = stage_ms(480, 640, st480)
    print(f"640x480 mountains (day 14, camera preset 1) device ms: kernel A "
          f"{sizes['640x480']['raytrace']:.4f} (CUDA graph replay), sky + "
          f"quantize {sizes['640x480']['sky_quantize']:.4f} (CUDA events), "
          f"kernel B {sizes['640x480']['fxaa']:.4f} (graph replay; the "
          f"state has FXAA off, so its frames do not launch it) [{card}]",
          flush=True)

    # the shapes the root scripts of phase 11 hand the kernels:
    # __torch_entry__.entry()'s 144x256 frame, and dryrun_multichip(8)'s
    # 128x128 frames whole (frame DP), in 8 bands of 16 rows (the sharded
    # frame, and the hybrid's 2 frames per launch) and in 16 of 8 rows
    # (interleave=2)
    st_e = sim.settle(sim.init_state())
    held_frame("entry()", 144, 256, st_e)
    step = Action.idle()._replace(move_forward=np.int32(1),
                                  mouse_dx=np.float32(1.0))
    st_d = [sim.animate(st_e, step, 1 / 60)]
    st_d.append(sim.animate(st_d[0], step, 1 / 60))
    held_bands("dryrun_multichip(8)", 128, 128, st_d[:1], 8)
    held_bands("dryrun_multichip(8), hybrid", 128, 128, st_d, 8)
    held_bands("dryrun_multichip(8), interleave=2", 128, 128, st_d[:1], 16)
    report["sizes"] = sizes

    # --- 11. the root scripts, in-process on the card ---
    phase(11)
    import __torch_entry__ as torch_entry
    from experiments import soak_torch, worst_state_probe_torch

    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = bench_torch.main(["--size", f"{W}x{H}", "--frames", "60"])
    counts = read_counts()
    lines = out.getvalue().strip().splitlines()
    require(len(lines) == 1, f"bench_torch prints one line on stdout "
            f"({len(lines)})")
    print(lines[0], flush=True)
    bench = json.loads(lines[0])
    require(rc == 0 and bench.get("parity_ok") is True
            and bench["parity_rmse_max"] < GOLDEN_RMSE,
            f"bench_torch.main at {W}x{H}, 60 frames, every configuration: "
            f"exit {rc}, parity_ok {bench.get('parity_ok')}, worst rmse "
            f"{bench.get('parity_rmse_max')}")
    require({"metric", "value", "unit", "vs_baseline", "crossfade_fps",
             "parity_rmse_max", "parity_ok"} <= set(bench)
            and bench["value"] > 0 and bench["crossfade_fps"] > 0,
            f"bench_torch's line has bench.py's keys: {sorted(bench)}")
    require(counts["raytrace_megakernel"] > 400 and counts["fxaa"] > 300,
            f"bench_torch's configurations went through both kernels: "
            f"{counts}")
    report["bench_torch"] = bench

    reset_counts()
    torch_entry.dryrun_multichip(8, DEVICE)
    counts = read_counts()
    require(counts["fxaa_band"] > 0 and counts["raytrace_megakernel_k8"] > 0
            and counts["raytrace_megakernel"] > 0,
            f"dryrun_multichip(8) on eight entries of the card launched "
            f"kernel A (frame and band launches) and kernel B's band form: "
            f"{counts}")
    frames = {}
    for d in (DEVICE, "cpu"):
        fn, fn_args = torch_entry.entry(d)
        frames[d] = fn(*fn_args).cpu().numpy()
    rm, off = golden_stats(frames[DEVICE], frames["cpu"])
    print(f"entry: ok {frames[DEVICE].shape} {frames[DEVICE].dtype}",
          flush=True)
    require(frames[DEVICE].shape == (144, 256, 3) and rm < GOLDEN_RMSE
            and off < GOLDEN_OFF_FRAC,
            f"entry() on the card vs on the CPU: rmse {rm:.5f} off>2 "
            f"{off:.4%}")

    reset_counts()
    worst_ms, worst_pose, readings = worst_state_probe_torch.probe(
        eng, days=(14.0, 17.6, 1.0), yaws=(45, 135, 225, 315),
        out=lambda line: print(line, flush=True))
    counts = read_counts()
    print(f"worst-state probe, 3 x 4 sub-grid at {W}x{H}: kernel A "
          f"{worst_ms:.4f} ms of device time at day {worst_pose[0]} yaw "
          f"{worst_pose[1]} (each pose: kernel A device ms by CUDA graph "
          f"replay / host-clock frame ms) [{card}]", flush=True)
    require(len(readings) == 12 and all(k > 0 and f > 0
                                        for k, f in readings.values())
            and counts["raytrace_megakernel"] >= 12 * 9,
            f"the probe read 12 poses through kernel A: {counts}")
    report["probe"] = {"worst_ms": worst_ms, "worst_pose": worst_pose,
                       "readings": {f"{d}_{y}": v
                                    for (d, y), v in readings.items()}}

    reset_counts()
    soak = soak_torch.soak(eng, 1, 120, 12.0,
                           out=lambda line: print(line, flush=True))
    counts = read_counts()
    require(len(soak) == 1 and soak[0]["fps"] > 0
            and soak[0]["device_peak_bytes"] > 0
            and counts["raytrace_megakernel"] >= 120,
            f"one soak segment of 120 frames: {soak[0]['fps']:.2f} fps, "
            f"device peak {soak[0]['device_peak_bytes'] / 1e6:.1f} MB, host "
            f"RSS {soak[0]['rss_gb']:.2f} GB [{card}]")
    report["soak"] = soak

    # --- 12. report ---
    phase(12)
    kernels = [
        {"name": "raytrace_megakernel", "route": "cuda",
         "source": "raytracing_cuda_tpu_torch/csrc/raytrace.cu",
         "replaces": "raytracing_cuda_tpu/render/pallas_rt.py:1151",
         "launches": launches["raytrace"], "max_abs_err": a_err,
         "ms": ms_a, "plain_ms": ms_a_plain, "bound_ms": bound_a[0],
         "bound_by": bound_a[1], "library_ms": None},
        {"name": "raytrace_megakernel_k8", "route": "cuda",
         "source": "raytracing_cuda_tpu_torch/csrc/raytrace.cu",
         "replaces": "raytracing_cuda_tpu/render/pallas_rt.py:1151",
         "launches": batch_counts["raytrace_megakernel_k8"],
         "max_abs_err": a8_err, "ms": ms_a8, "plain_ms": ms_a8_plain,
         "bound_ms": bound_a8[0], "bound_by": bound_a8[1],
         "library_ms": None},
        {"name": "fxaa", "route": "cuda",
         "source": "raytracing_cuda_tpu_torch/csrc/fxaa.cu",
         "replaces": "raytracing_cuda_tpu/render/fxaa.py:265",
         "launches": launches["fxaa"], "max_abs_err": b_err,
         "ms": ms_b, "plain_ms": ms_b_plain, "bound_ms": bound_b[0],
         "bound_by": bound_b[1], "library_ms": None},
        {"name": "fxaa_k8", "route": "cuda",
         "source": "raytracing_cuda_tpu_torch/csrc/fxaa.cu",
         "replaces": "raytracing_cuda_tpu/render/fxaa.py:265",
         "launches": batch_counts["fxaa_k8"], "max_abs_err": fb8_err,
         "ms": ms_b8, "plain_ms": ms_b8_plain, "bound_ms": bound_b8[0],
         "bound_by": bound_b8[1], "library_ms": None},
        {"name": "raytrace_megakernel_band", "route": "cuda",
         "source": "raytracing_cuda_tpu_torch/csrc/raytrace.cu",
         "replaces": "raytracing_cuda_tpu/render/pallas_rt.py:1151",
         "launches": band_counts["raytrace_megakernel_k8"],
         "max_abs_err": a_band_err, "ms": ms_a_band,
         "plain_ms": ms_a_band_plain, "bound_ms": bound_a_band[0],
         "bound_by": bound_a_band[1], "library_ms": None},
        {"name": "fxaa_band", "route": "cuda",
         "source": "raytracing_cuda_tpu_torch/csrc/fxaa.cu",
         "replaces": "raytracing_cuda_tpu/render/fxaa.py:265",
         "launches": band_counts["fxaa_band"], "max_abs_err": band_err,
         "ms": ms_band, "plain_ms": ms_band_plain,
         "bound_ms": bound_band[0], "bound_by": bound_band[1],
         "library_ms": None},
    ]
    report["kernels"] = kernels
    report["kernel_a_hit_miss_mismatch_max"] = a_mismatch
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s",
          flush=True)
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
