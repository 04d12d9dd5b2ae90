"""GPU smoke test of the PyTorch/CUDA port: build, check, drive, time.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--frames 120] [--out report.json]

Phases (any failure exits non-zero):
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build both kernels (csrc/raytrace.cu, csrc/fxaa.cu), kernel A's
     diagnostic arms (csrc/raytrace_arms.cu), the packs kernel
     (csrc/packs.cu) and the sky kernel (csrc/sky.cu) with nvcc, in
     parallel; ptxas must report no spills, and each kernel's registers
     are printed;
  3. each kernel against its plain PyTorch version on the card at
     1280x720, bit for bit, for the four golden states, the worst pose, the
     seven degenerate states (EXTREME) and the classic scene, with times,
     on packs built on the card (the packs kernel's, equal bit for bit to
     the torch packs on the card, and each held against the same state's
     packs built on the CPU: equal but for the trig-inherited entries, and
     the rays kernel A renders apart between the two counted); the packs
     kernel's and the torch packs' device times by CUDA graph replay; the
     sky kernel (csrc/sky.cu) on kernel A's planes of every pose against
     its plain version (the torch sky lookup + quantize), and both their
     device times by CUDA graph replay beside the kernel's byte bound;
     kernel A at a size whose warp tiles hang over the frame's edges
     (ODD_SIZE), one frame and 3 frames per launch; kernel A's counting
     launch and its lane-efficiency line;
  4. the slice: Engine(device="cuda") renders the four golden states
     against tests/golden/tpu/*.png, then runs the idle animated loop;
     the four kernels' launch counters (A, B, the packs, the sky) must
     have moved in this phase;
  5. the batch path: kernel A's, kernel B's and the sky kernel's K-frame
     forms against their plain versions and single-frame launches (the
     sky kernel's K = 8 times by graph replay), step_and_frame_batch against
     step_and_frame, Engine.run(batch=8) against Engine.run; the batch
     forms' counters must have moved in run(batch=8);
  6. the CLI (render, record, record --resume, render --state, bench)
     in-process in a temporary directory, against Engine frames;
  7. a torch.profiler trace of 30 loop frames: the top device ops and the
     device-busy share of the window;
  8. parallel/ at 1280x720 on meshes that repeat the one card: kernel B's
     halo'd band form against its plain version (bands of 2, 4 and 8) and
     the full-frame kernel, kernel A's launches for the halo'd bands of a
     4-band split (a chunk and one row above and below) against its plain
     version and the full frame's rows, render_frame_sharded against
     Engine frames (FXAA on and off); Engine(sharded=[cuda:0] * 4), one
     CUDA graph per mesh entry per call, driven with its band counter, in
     turns with the single-device loop; at interleave 1 and 2, 60 frames,
     60 preview-2 frames and 8 batches of K = 8 against the single-device
     graph Engine, frames, states and every replica bit for bit; the
     golden states through the sharded graphs; the sharded frame() (one
     graph per entry rendering its rows of its replica, unstepped) against
     the single-device frame() at the golden states and the worst pose; Engine.render_script_dp frame DP and
     hybrid (eager, capture, replay) against step_and_frame; the replays
     under sync debug mode "error"; each entry's graph by replay, host ms
     per call, the host's API calls per call (profiler: 4 graph launches,
     at most 9 copies, no kernel; a frame() call 4 graph launches and no
     kernel), each graph pool's memory, the gather,
     render_script_dp fps against run(batch=8), and `record --dp` on a
     one-card machine;
  9. the `fast` and `oracle` render paths and the window's pieces at
     1280x720: each path's frame() by CUDA graph replay (every early exit
     of `fast` masked) against _frame_eager() (the early exits decided on
     the host) bit for bit at the golden states, the worst pose and the
     classic scene, and against the 720p goldens and the megakernel
     path's frames; step_and_frame, preview 2 and a batch of 2 (two
     replays of the step_and_frame graph) against the eager device step;
     the replays under sync debug mode "error"; kernel B's launches on
     each path's step_and_frame graph (counters set to 0 just before);
     the API calls per call (profiler: a graph launch per frame, no
     kernel), frame() eager and by replay in turns, host ms per call,
     capture seconds, graph nodes and pools; `fast` at two chunk sizes; a
     row-sharded `fast` Engine on [cuda:0] * 4 at interleave 1 and 2, one
     graph per entry per call (entry_bands_plain), against the unsharded
     Engine, frames and states; sky_cache=False (its
     frame() graph against the eager frame, its step, preview 2 and batch
     of 3 graphs against the eager device step, the replays under sync
     debug mode "error", device ms by replay, host ms per call, API calls
     per call, pools), and the CLI's `--path fast|oracle` and `window`;
     then the viewer's loop without a display: step_and_frame_preview
     against the box downsample of the full frame, and 30 frames through
     the readback ring, with both kernels' launch counters read around
     them;
 10. other sizes: Engine(device="cuda") at 1920x1080 against the four
     goldens in tests/golden/tpu/1920x1080/ under the golden contract, and
     at 640x480 (mountains, FXAA off: bench_torch.py's configuration 1)
     against the CPU Engine's frame under the same contract; at each size
     kernel A, the sky kernel and kernel B against their plain versions
     bit for bit (at 1080p for every golden state), then their device
     times (CUDA graph replay) and the sky kernel's bound; the three
     kernels bit for bit at the shapes phase 11's scripts hand them:
     entry()'s 144x256 frame, dryrun_multichip(8)'s 128x128 frames whole
     and in bands of 16 and 8 rows, one and two frames per launch;
 11. the root scripts, in-process on the card: bench_torch.main at 1280x720
     with 60 frames and every configuration (its JSON line is printed, and
     its parity gate must pass), __torch_entry__.dryrun_multichip(8) on
     eight entries of the card and entry(), the worst-state probe over a
     3 x 4 sub-grid, one soak segment of 120 frames; the kernels' launch
     counters are read around each, and its frozen configurations are
     printed beside the frame() graph's replay at the worst pose;
 12. the arms at 1280x720: at the worst pose and island_morning every arm
     of kernel A (csrc/raytrace_arms.cu) against the same arm of its plain
     version bit for bit, and the arms that compute the shipped function
     (nocull, no_tbound, nohcull, depth4) against the shipped kernel; then
     the probes in-process: experiments/megakernel_ablation_torch.py at
     both poses (each arm's device time by CUDA graph replay; the arms'
     counter read around the first), worst_pose_decompose_torch.py (the
     stage split, procedural sky, then the reference-sky source on
     synthetic panoramas), and one short tail_probe_torch.py and
     readback_fps_torch.py run;
 13. the frame step on the card: Engine(device="cuda") holds its scene,
     cull table and state there; the golden states and the worst pose at
     1280x720 and 1920x1080 through step_and_frame's and frame()'s CUDA
     graphs against the goldens and the eager frame; 60 frames (K = 1), 8
     batches of K = 8 and 60 preview-2 frames by graph replay against the
     eager device step, frames and states bit for bit; step() by its
     graph against the eager step; fast_forward over 1,000 vectors (a
     step() replay per vector) against the eager step once per vector,
     in turns with it, and a cold one against 256-step chunk graphs (the
     JAX Engine's scan form), capture included; the eager step and every replay under sync debug mode
     "error"; the step + packs' and the whole graph's device time by
     replay, host ms per call, Engine.run fps with p50/p99, the
     device-busy share and the host-to-device copies per frame by
     profiler, the CPU Engine's host half; frame() by replay, in turns
     with bench_torch's worst-pose timer, and its FXAA A/B;
 14. a JSON line per kernel form (each with its bound, from this run's
     inputs; kernel B's full-frame and band forms also with their
     launches on each path's main-path run), the card line, and the final
     status line.
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
import resource
import statistics
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


def toggling_actions(n: int, seed: int):
    """random_actions(n, seed) with the camera's second preset at frame
    n // 8, FXAA off at n // 4 and on again at n // 2."""
    acts = random_actions(n, seed)
    for i, kw in ((n // 8, dict(cam_preset=np.int32(1))),
                  (n // 4, dict(set_aa_off=np.bool_(True),
                                set_aa_on=np.bool_(False))),
                  (n // 2, dict(set_aa_on=np.bool_(True),
                                set_aa_off=np.bool_(False)))):
        acts[i] = acts[i]._replace(**kw)
    return acts


def random_actions(n: int, seed: int):
    """n Actions from a seed that move (with and without run), turn, scrub
    the clock both ways, pause and play, move the sea, pick time and camera
    presets (some out of range) and toggle FXAA."""
    from raytracing_cuda_tpu_torch.sim.actions import Action

    rng = np.random.default_rng(seed)

    def axis(p=1.0):
        return np.int32(rng.integers(-1, 2) if rng.random() < p else 0)

    def preset(top):
        return np.int32(rng.integers(0, top) if rng.random() < 0.1 else -1)

    return [Action.idle()._replace(
        move_side=axis(), move_forward=axis(), move_up=axis(),
        run=np.bool_(rng.random() < 0.3),
        mouse_dx=np.float32(rng.normal() * 20),
        mouse_dy=np.float32(rng.normal() * 10), time_control=axis(0.5),
        set_play=np.bool_(rng.random() < 0.1),
        set_pause=np.bool_(rng.random() < 0.1), sea_control=axis(0.3),
        time_preset=preset(6), cam_preset=preset(3),
        set_aa_on=np.bool_(rng.random() < 0.2),
        set_aa_off=np.bool_(rng.random() < 0.2)) for _ in range(n)]


# Packs built on the card against packs built on the CPU from the same
# state: every entry equal but those that pass through sin/cos/tan (the
# frustum corners, the lights' positions and colours, the light proxy
# spheres' rows and the bound of the sphere cluster that holds them), which
# CUDA's and the CPU's trig round differently; those within PACK_TRIG_ULP
# units in the last place of the largest magnitude of their vector.
PACK_TRIG_ULP = 16


def pack_differences(cpu, dev):
    """frame_packs built on the CPU and on the card for one state → (the
    count of entries that differ outside the trig-inherited ones, the
    largest difference of a trig-inherited entry in the units of
    PACK_TRIG_ULP)."""
    from raytracing_cuda_tpu_torch.render import cuda_rt as rt

    coef_c, params_c, _, _, cull_c = cpu
    coef_d, params_d, cull_d = (t.cpu() for t in (dev[0], dev[1], dev[4]))
    # the light proxy spheres' rows (flags: is_light * 2 + is_sphere)
    light = coef_c[:, rt.C_FLAGS] == 3.0
    trig = [(rt.P_LD, 3), (rt.P_RD, 3), (rt.P_LU, 3), (rt.P_RU, 3),
            (rt.P_LPOS0, 3), (rt.P_LPOS1, 3), (rt.P_LCOL0, 3),
            (rt.P_LCOL1, 3), (rt.P_CLUSTERS + 4 * (len(cull_c) - 1), 4)]
    exact = torch.ones(params_c.shape, dtype=torch.bool)
    vectors = []
    for off, n in trig:
        exact[off:off + n] = False
        vectors.append((params_c[off:off + n], params_d[off:off + n]))
    for ch, n in ((rt.C_CENTER, 3), (rt.C_NORMAL, 3), (rt.C_POS2, 1)):
        for row in torch.nonzero(light).flatten().tolist():
            vectors.append((coef_c[row, ch:ch + n], coef_d[row, ch:ch + n]))
    rest = torch.ones(coef_c.shape, dtype=torch.bool)
    rest[light, rt.C_CENTER:rt.C_POS2 + 1] = False
    bad = (int((coef_c[rest] != coef_d[rest]).sum())
           + int((params_c[exact] != params_d[exact]).sum())
           + int((cull_c != cull_d).sum()))
    worst = max(float(((a - b).abs().max() / np.spacing(np.float32(max(
        1.0, float(a.abs().max())))))) for a, b in vectors)
    return bad, worst


def rays_apart(planes_a, planes_b) -> int:
    """Pixels where two sets of kernel A's 7 planes differ in any plane."""
    a, b = torch.stack(list(planes_a)), torch.stack(list(planes_b))
    return int((a != b).any(0).sum())


def sky_inputs(states, dev) -> tuple:
    """The K states' clocks (K,) and sky weights (K, 4) on dev, as
    render/sky.py sky_quantize reads them."""
    return (torch.stack([st.day_time for st in states]).to(dev),
            torch.stack([st.sky_vars for st in states]).to(dev))


def sky_bases(planes, states, sky_pack, label: str) -> torch.Tensor:
    """K frames before FXAA from kernel A's planes ((K, H, W) each) and
    their K states: sky_quantize, the main path's launch, required equal
    bit for bit to sky_quantize_torch on the same inputs."""
    from raytracing_cuda_tpu_torch.render.sky import (sky_quantize,
                                                      sky_quantize_torch)

    planes = [p.contiguous() for p in planes]
    args = (sky_pack, *SKY_SHAPE, *sky_inputs(states, planes[0].device))
    out = sky_quantize(planes, *args)
    require(torch.equal(out, sky_quantize_torch(planes, *args)),
            f"{label}: the sky kernel equals its plain version bit for bit")
    return out


def sky_bound(planes):
    """sky_quantize's bound on kernel A's planes ((K, H, W) each): r, g, b
    and mw read at every pixel, the direction and two int32 texels where
    the sky shows (mw != 0), 3 bytes written. Its arithmetic, a few dozen
    operations a sky pixel, is far below those bytes at the card's peaks
    and is not counted."""
    n, n_sky = planes[0].numel(), int((planes[3] != 0).sum())
    return bound(n * (4 * 4 + 3) + n_sky * (3 * 4 + 2 * 4), 0)


def reset_counts():
    from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa as fx

    from raytracing_cuda_tpu_torch.render.packs import pack_frame
    from raytracing_cuda_tpu_torch.render.sky import sky_quantize

    for fn in (cuda_rt.raytrace_planes, cuda_rt.raytrace_planes_batch,
               fx.fxaa, fx.fxaa_batch, fx.fxaa_ext, pack_frame, sky_quantize):
        fn.launches = 0
    cuda_rt.raytrace_planes.arm_launches = 0
    cuda_rt.raytrace_planes_batch.arm_launches = 0
    cuda_rt.raytrace_planes_batch.frames = 0
    fx.fxaa_batch.frames = 0
    fx.fxaa_ext.frames = 0
    sky_quantize.frames = 0


def read_counts() -> dict:
    from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa as fx
    from raytracing_cuda_tpu_torch.render.packs import pack_frame
    from raytracing_cuda_tpu_torch.render.sky import sky_quantize

    return {"packs": pack_frame.launches,
            "sky": sky_quantize.launches, "sky_frames": sky_quantize.frames,
            "raytrace_megakernel": cuda_rt.raytrace_planes.launches,
            "raytrace_megakernel_k8": cuda_rt.raytrace_planes_batch.launches,
            "raytrace_megakernel_k8_frames":
                cuda_rt.raytrace_planes_batch.frames,
            "fxaa": fx.fxaa.launches, "fxaa_k8": fx.fxaa_batch.launches,
            "fxaa_k8_frames": fx.fxaa_batch.frames,
            "fxaa_band": fx.fxaa_ext.launches,
            "fxaa_band_frames": fx.fxaa_ext.frames,
            "raytrace_megakernel_arms": (
                cuda_rt.raytrace_planes.arm_launches
                + cuda_rt.raytrace_planes_batch.arm_launches)}


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


def warm(fn):
    """One call of fn(), then one under a throwaway torch.profiler session,
    each drained: an Engine frame call's first call while a profiler
    records captures the marked variant of its graph (app/loop.py), which
    must not fall inside a counted trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()


def profiled(fn, reps: int, knames):
    """device_activity of a torch.profiler trace of reps calls of fn(),
    traced again (up to PROFILE_TRIES traces) while the trace holds no
    device event of a kernel named in knames: now and then a trace comes
    back without its device events. None if no trace holds them."""
    from raytracing_cuda_tpu_torch.utils import profiling

    for attempt in range(1, PROFILE_TRIES + 1):
        warm(fn)
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


def profiled_calls(fn, reps: int, need: str = "GraphLaunch"):
    """({CUDA runtime or driver call: count}, {device copy: count}) of a
    torch.profiler trace of reps calls of fn(): what the host issued, and
    the copies the device ran. Traced again (up to PROFILE_TRIES traces)
    while the trace holds no call named with `need` (a CUDA graph launch by
    default); None if none does."""
    from raytracing_cuda_tpu_torch.utils import profiling

    for attempt in range(1, PROFILE_TRIES + 1):
        warm(fn)
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            with open(os.path.join(tmp, profiling.TRACE_FILE)) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X"]
        api, copies = {}, {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                api[e["name"]] = api.get(e["name"], 0) + 1
            elif e.get("cat") == "gpu_memcpy":
                copies[e["name"]] = copies.get(e["name"], 0) + 1
        if any(need in name for name in api):
            return api, copies
        print(f"torch.profiler trace {attempt} of {PROFILE_TRIES} holds no "
              f"{need} call ({len(api)} API call names)", flush=True)
    return None


def calls_per(fn, reps: int, need: str = "GraphLaunch"):
    """Per call of fn(), from profiled_calls over reps calls: {"GraphLaunch",
    "Memcpy", "LaunchKernel": host API calls whose name holds it} → (that
    dict, the API counts), or None where no trace holds a `need` call."""
    got = profiled_calls(fn, reps, need)
    if got is None:
        return None
    api = got[0]
    return {what: sum(v for k, v in api.items() if what in k) / reps
            for what in ("GraphLaunch", "Memcpy", "LaunchKernel")}, api


def pool_mb(graphs) -> list:
    """(allocated, reserved) MB each captured graph of a key kept."""
    return [tuple(round(b / 2 ** 20, 1) for b in g.memory) for g in graphs]


def graph_vs_eager(e, kind, n, k, seed):
    """n frames of seeded actions through e's single-device graph, k per
    call, each call against e._step_render from the same state (on the
    `fast` path with its early exits decided on the host) → (frames and
    states bit for bit, snapshots unchanged, no frame overwritten and the
    graph captured: on the `fast` and `oracle` paths a batch replays the
    step_and_frame graph k times)."""
    from raytracing_cuda_tpu_torch.render.pipeline import pack_actions
    from raytracing_cuda_tpu_torch.sim import state as sim

    acts = random_actions(n, seed)
    dts = [1 / 60 + 0.01 * (i % 4) for i in range(n)]
    call = {"frame": lambda a, d: e.step_and_frame(a[0], d[0]),
            "preview": lambda a, d: e.step_and_frame_preview(a[0], d[0]),
            "batch": e.step_and_frame_batch}[kind]
    e.set_state(make_state(9.5))
    st = sim.clone_state(e.state)
    same = kept_same = True
    kept = []
    for i in range(0, n, k):
        a, d = acts[i:i + k], dts[i:i + k]
        before = e.state
        before_copy = sim.clone_state(before)
        got = call(a, d)
        st, want = e._step_render(kind, st, e._upload(pack_actions(a, d)),
                                  early_exit=True)
        same &= (torch.equal(got, want) and states_equal(e.state, st))
        kept_same &= states_equal(before, before_copy)
        kept.append((got, want.clone()))
    key = ("frame", 1) if kind == "batch" and e.path != "auto" else (kind, k)
    return (same, kept_same,
            all(torch.equal(g, w) for g, w in kept) and key in e._graphs)


def from_idle(fn, n: int) -> float:
    """Host ms per call of n calls of fn() enqueued from an idle device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


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


def ptxas_registers(log: str) -> dict:
    """ptxas -v output → {entry function: registers it uses}."""
    regs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


def synthetic_skies(root: str, h: int, w: int) -> str:
    """Four reference-sky PNGs {morning,day,evening,night}.png of h x w
    under root, random texels from a seed → root."""
    from raytracing_cuda_tpu_torch.scene.textures import SKY_NAMES
    from raytracing_cuda_tpu_torch.utils.images import save_png

    rng = np.random.default_rng(11)
    os.makedirs(root, exist_ok=True)
    for name in SKY_NAMES:
        save_png(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                 os.path.join(root, f"{name}.png"), level=1)
    return root


def card_line(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True,
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
        """Say where the run's time goes: seconds in when phase n starts,
        and the process's peak resident host memory so far."""
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        print(f"phase {n} starts {time.perf_counter() - t_start:.1f} s in "
              f"(peak host RSS {peak:.2f} GiB)", flush=True)

    # --- 1. environment ---
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from raytracing_cuda_tpu_torch import _build
    from raytracing_cuda_tpu_torch.app.loop import Engine
    from raytracing_cuda_tpu_torch.core.types import to_device
    from raytracing_cuda_tpu_torch.render import cuda_rt, fxaa as fx
    from raytracing_cuda_tpu_torch.render.packs import pack_base, pack_frame
    from raytracing_cuda_tpu_torch.render.pipeline import (frame_packs,
                                                           frame_packs_torch)
    from raytracing_cuda_tpu_torch.render.sky import (sky_quantize,
                                                      sky_quantize_torch)
    from raytracing_cuda_tpu_torch.scene.builders import (
        ISLAND_SPH_CLUSTERS, ISLAND_TRI_CLUSTERS, ISLAND_TRI_SUBS,
        build_scene)
    from raytracing_cuda_tpu_torch.scene.textures import (pack_sky_all,
                                                          procedural_skies)
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
    libs = ("raytrace", "raytrace_arms", "fxaa", "packs", "sky")
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(_build.load, libs))
    print(f"built both kernels, kernel A's arms, the packs and the sky "
          f"kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    for name in libs:
        log = _build.BUILD_LOG[name]
        print(f"built {name}: nvcc {log['seconds']:.2f} s\n{log['ptxas']}",
              flush=True)
        report[f"build_{name}_s"] = log["seconds"]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill",
                                             log["ptxas"])]
        require(bool(spills) and not any(spills),
                f"ptxas reports no spills for {name} ({spills})")
        regs = ptxas_registers(log["ptxas"])
        print(f"registers {name}: {regs}", flush=True)
        report[f"registers_{name}"] = regs

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
    # the packs as the Engine builds them, on the card, against the same
    # state's packs built on the CPU
    on_card = {id(sc): to_device(sc, dev) for sc in (scene, classic_scene)}
    trig_ulp, apart = 0.0, {}
    for name, kw in [*POSES.items(), ("classic", None)]:
        sc, st, cl = ((classic_scene, classic_st, (None,) * 3) if kw is None
                      else (scene, make_state(**kw), clusters))
        cpu_packs = frame_packs(sc, st, H, W, None, *cl)
        packs = frame_packs(on_card[id(sc)], sim.state_to(st, dev), H, W,
                            None, *cl)
        torch_packs = frame_packs_torch(on_card[id(sc)],
                                        sim.state_to(st, dev), H, W, None,
                                        *cl)
        require(all(torch.equal(a, b) for a, b in zip(packs, torch_packs)
                    if isinstance(a, torch.Tensor))
                and packs[2:4] == torch_packs[2:4],
                f"{name}: the packs kernel's packs equal the torch packs on "
                f"the card bit for bit")
        coef, params, nt, ns, cu = packs
        bad, worst = pack_differences(cpu_packs, packs)
        trig_ulp = max(trig_ulp, worst)
        require(bad == 0 and worst <= PACK_TRIG_ULP,
                f"{name}: packs built on the card equal the CPU's but for "
                f"the trig-inherited entries ({bad} others differ; those "
                f"within {worst:.2f} ulp of {PACK_TRIG_ULP})")
        kern = torch.stack(cuda_rt.raytrace_planes(coef, params, H, W, nt, ns,
                                                   cull=cu))
        on_cpu_packs = cuda_rt.raytrace_planes(
            cpu_packs[0].to(dev), cpu_packs[1].to(dev), H, W, nt, ns,
            cull=cu)
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

        def base_of(planes, label, st=st):
            return sky_bases([p[None] for p in planes], [st], sky_pack,
                             f"{name} at 720p, {label}")[0]

        bk = base_of(kern, "the kernel's packs")
        # rays whose planes differ, and pixels of the frame before FXAA
        apart[name] = (rays_apart(kern, on_cpu_packs), int(
            (base_of(on_cpu_packs, "the CPU's packs") != bk).any(-1).sum()))
        if name in CASES:
            golden_bases.append(bk)
        fk, fp = fx.fxaa(bk), fx.fxaa_torch(bk)
        d = int((fk.int() - fp.int()).abs().max())
        b_err = max(b_err, d)
        require(d == 0, f"{name}: kernel B vs plain at 720p: max|diff| {d}")
        inputs[name] = (coef, params, nt, ns, cu, bk, kern, st)
        if work is not None:
            works[name] = work

    # the packs: one launch of the kernel against the torch ops it
    # replaces, by CUDA graph replay at the worst pose
    island = on_card[id(scene)]
    island_base = pack_base(island, *clusters)
    worst_st = sim.state_to(make_state(**POSES["worst_pose"]), dev)
    ms_packs = graph_device_ms(lambda: frame_packs(
        island, worst_st, H, W, None, *clusters, inputs["worst_pose"][4],
        island_base), 50)
    ms_packs_torch = graph_device_ms(lambda: frame_packs_torch(
        island, worst_st, H, W, None, *clusters, inputs["worst_pose"][4]), 5)
    # the base read once and the table and params written once
    bound_packs = bound(2 * 4 * (island_base.coef.numel()
                                 + island_base.params.numel()), 0)
    print(f"packs: kernel {ms_packs:.4f} ms, torch ops {ms_packs_torch:.4f} "
          f"ms a frame (CUDA graph replay); bound {bound_packs[0]:.6f} ms "
          f"({bound_packs[1]}) [{card}]", flush=True)
    report["packs_ms"] = {"kernel": ms_packs, "torch": ms_packs_torch,
                          "bound": bound_packs[0]}

    # kernel A where the last warp tiles hang over the right and bottom
    # edges: one frame per launch, and 3 frames per launch
    oh, ow = ODD_SIZE
    odd = [frame_packs(scene, make_state(**POSES[n]), oh, ow, None, *clusters)
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

    print(f"packs built on the card vs on the CPU at 720p, 13 poses: trig-"
          f"inherited entries within {trig_ulp:.2f} ulp; between the two "
          f"packs (kernel A's rays apart, pixels apart before FXAA): "
          f"{apart} of {H * W} [{card}]", flush=True)
    report["device_packs"] = {"trig_ulp": trig_ulp, "rays_apart": apart}
    coef, params, nt, ns, cull, bk, kern, st_morning = inputs[
        "island_morning"]
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
        frame_packs(scene, sim.animate(st0, Action.idle(), 1 / 60), H, W,
                   None, *clusters)
    host_ms = (time.perf_counter() - t0) * 1e3 / 50
    # the sky lookup + quantize: one launch of the sky kernel against its
    # plain version (the torch composition it replaces), by CUDA graph
    # replay on kernel A's planes, as the main path hands them over
    sky_planes = [p[None] for p in kern]
    sky_args = (sky_pack, *SKY_SHAPE, *sky_inputs([st_morning], dev))
    ms_sky = graph_device_ms(lambda: sky_quantize(sky_planes, *sky_args), 50)
    ms_sky_plain = graph_device_ms(
        lambda: sky_quantize_torch(sky_planes, *sky_args), 10)
    bound_sky = sky_bound(sky_planes)
    print(f"sky kernel 720p island_morning: {ms_sky:.4f} ms, plain version "
          f"{ms_sky_plain:.4f} ms (CUDA graph replay); bound "
          f"{bound_sky[0]:.6f} ms ({bound_sky[1]}) [{card}]", flush=True)
    print(f"breakdown 720p island_morning: host step+packs {host_ms:.4f} ms "
          f"(host clock), sky+quantize {ms_sky:.4f} ms (graph replay), "
          f"kernel A {ms_a:.4f} ms, kernel B {ms_b:.4f} ms (CUDA events) "
          f"[{card}]", flush=True)
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
    pack_frame.launches = 0
    sky_quantize.launches = 0
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
                "fxaa": fx.fxaa.launches, "packs": pack_frame.launches,
                "sky": sky_quantize.launches}
    ms = sorted(stats.frame_ms)
    print(f"slice: Engine.run({args.frames}) idle animated loop 1280x720 "
          f"island: {stats.fps:.2f} fps, frame ms median "
          f"{ms[len(ms) // 2]:.4f} min {ms[0]:.4f} max {ms[-1]:.4f} "
          f"(CUDA events) [{card}]", flush=True)
    print(f"launch counts in the slice phase: {launches}", flush=True)
    require(all(v > 0 for v in launches.values()),
            "the four kernels launched by the main path")
    report.update(slice=stats.as_dict(), launches=launches,
                  golden_rmse_max=worst)

    # --- 5. the batch path ---
    phase(5)
    def stacked_packs(states):
        packs = [frame_packs(scene, st, H, W, None, *clusters)
                 for st in states]
        return (torch.stack([p[0] for p in packs]).to(dev),
                torch.stack([p[1] for p in packs]).to(dev))

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

    base8 = sky_bases(k8, states8, sky_pack, "K=8 at 720p")
    require(all(torch.equal(base8[k], sky_bases(
        [p[k:k + 1] for p in k8], [st], sky_pack, f"frame {k} of K=8")[0])
        for k, st in enumerate(states8)),
        "the sky kernel K=8 equals per-frame launches bit for bit")
    sky8_args = (sky_pack, *SKY_SHAPE, *sky_inputs(states8, dev))
    ms_sky8 = graph_device_ms(lambda: sky_quantize(k8, *sky8_args), 50)
    ms_sky8_plain = graph_device_ms(
        lambda: sky_quantize_torch(k8, *sky8_args), 5)
    bound_sky8 = sky_bound(k8)
    print(f"sky kernel 720p: K=8 {ms_sky8:.4f} ms per launch = "
          f"{ms_sky8 / BATCH:.4f} ms per frame vs K=1 {ms_sky:.4f} ms "
          f"(plain K=8 {ms_sky8_plain:.4f} ms; CUDA graph replay); bound "
          f"{bound_sky8[0]:.6f} ms ({bound_sky8[1]}) [{card}]", flush=True)
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
            and counts["raytrace_megakernel_k8_frames"] == BATCH
            and counts["sky"] == 1 and counts["sky_frames"] == BATCH,
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
            and batch_counts["fxaa_k8"] > 0
            and batch_counts["sky"] > 0,
            "the batch kernel forms (A, B, the sky) launched by "
            "run(batch=8)")
    report.update(batch={"fps": fps, "counts": batch_counts,
                         "kernel_a_k8_ms": ms_a8, "fxaa_k8_ms": ms_b8,
                         "sky_k8_ms": ms_sky8})

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
    # split with their halo rows (a chunk and one row above and below,
    # within the frame), each against its plain version and the full
    # frame's rows
    sub = H // 4
    halo_launches = [(max(c * sub - 1, 0), min((c + 1) * sub + 1, H))
                     for c in range(4)]
    a_band_err, a_band_rows = 0.0, True
    work_band = dict.fromkeys(cuda_rt.WORK_KEYS, 0)
    r0_band, rows_band = halo_launches[1][0], sub + 2
    for lo, hi in halo_launches:
        kb = cuda_rt.raytrace_planes_batch(coef[None], params[None], hi - lo,
                                           W, nt, ns, row0=lo, total_h=H,
                                           cull=cull)
        pb, ms = timed(lambda lo=lo, hi=hi:
                       cuda_rt.raytrace_planes_batch_torch(
                           coef[None], params[None], hi - lo, W, nt, ns,
                           row0=lo, total_h=H))
        a_band_err = max([a_band_err] + [float((a - b).abs().max())
                                         for a, b in zip(kb, pb)])
        a_band_rows &= torch.equal(torch.stack(kb)[:, 0], kern[:, lo:hi])
        if lo == r0_band:
            ms_a_band_plain = ms
    cuda_rt.raytrace_planes_batch_torch(
        coef[None], params[None], rows_band, W, nt, ns, row0=r0_band,
        total_h=H, work=work_band, cull=cull)
    require(a_band_err == 0.0, f"kernel A halo'd bands of the 4-band split "
            f"(row0, rows: {[(lo, hi - lo) for lo, hi in halo_launches]}) "
            f"vs plain max|diff| {a_band_err}")
    require(a_band_rows, "kernel A halo'd bands equal the full frame's rows "
            "bit for bit")

    def band_launch():
        return cuda_rt.raytrace_planes_batch(
            coef[None], params[None], rows_band, W, nt, ns, row0=r0_band,
            total_h=H, cull=cull)

    ms_a_band = cuda_ms(band_launch, 20)
    bound_a_band = raytrace_bound(work_band, coef[None], params[None], 1,
                                  rows_band, W)
    # events around back-to-back launches of a launch this short time the
    # host's launch rate; a CUDA graph's replay times the device alone
    graph_a_band = graph_device_ms(band_launch, 20)
    graph_a = graph_device_ms(lambda: cuda_rt.raytrace_planes(
        coef, params, H, W, nt, ns, cull=cull), 20)
    print(f"kernel A, {rows_band}-row band (a {sub}-row chunk and its halo "
          f"rows) at row0 {r0_band} of 720p island_morning: "
          f"{ms_a_band:.4f} ms (plain {ms_a_band_plain:.4f} ms, bound "
          f"{bound_a_band[0]:.6f} ms, {bound_a_band[1]}) vs full frame "
          f"{ms_a:.4f} ms (CUDA events); device time by CUDA graph replay: "
          f"band {graph_a_band:.4f} ms, full frame {graph_a:.4f} ms "
          f"[{card}]", flush=True)

    # render_frame_sharded against the Engine frame, FXAA on and off, from
    # the Engine's scene on the card (packs built there, as the Engine's)
    mismatch = []
    for name, kw in CASES.items():
        for aa in (True, False):
            st = make_state(**dict(kw, aa=aa))
            eng.set_state(st)
            ref = eng._frame_eager()
            for n, il in ((2, 1), (4, 1), (8, 1), (4, 2)):
                img = render_frame_sharded(
                    eng.scene, st, replicate(sky_pack, [dev]), *SKY_SHAPE,
                    mesh=[DEVICE] * n, height=H, width=W, interleave=il,
                    tri_clusters=ISLAND_TRI_CLUSTERS,
                    sph_clusters=ISLAND_SPH_CLUSTERS, t_subs=ISLAND_TRI_SUBS)
                if not torch.equal(img, ref):
                    mismatch.append((name, aa, n, il))
    require(not mismatch, f"render_frame_sharded (n 2/4/8, interleave 2 at "
            f"n 4; 4 golden states, FXAA on and off) equals the Engine frame "
            f"bit for bit; mismatches {mismatch}")

    # the main path of this slice: a sharded Engine's loop, one CUDA graph
    # per mesh entry per call, in turns with the single-device loop
    from raytracing_cuda_tpu_torch.parallel.mesh import place_bands
    from raytracing_cuda_tpu_torch.render.pipeline import pack_actions
    from raytracing_cuda_tpu_torch.utils.timing import (FrameTimer,
                                                        graph_nodes,
                                                        replay_ms)

    cfg = RenderConfig(width=W, height=H, procedural_sky_shape=SKY_SHAPE)
    mesh4 = [DEVICE] * 4
    idle = Action.idle()
    eng_sh = {il: Engine(dataclasses.replace(cfg, shard_interleave=il),
                         DEVICE, sharded=mesh4, share_assets_from=eng)
              for il in (1, 2)}

    loop_ms = {}
    arms = (("single graph", eng), ("sharded graph il1", eng_sh[1]),
            ("sharded graph il2", eng_sh[2]))
    for label, e in (*arms, *arms[::-1]):
        e.set_state(make_state(6.0))
        reset_counts()
        st = e.run(60)
        counts = read_counts()
        if label == "sharded graph il1":
            band_counts = counts
        ms = statistics.median(st.frame_ms)
        loop_ms.setdefault(label, []).append(ms)
        print(f"{label} loop, 60 frames 1280x720 island day 6: "
              f"{st.fps:.2f} fps, frame ms median {ms:.4f} (CUDA events; "
              f"[cuda:0] * 4 serialises the entries on one card) [{card}]",
              flush=True)
    print(f"launch counts in Engine(sharded=[cuda:0] * 4).run(60): "
          f"{band_counts}", flush=True)
    require(band_counts["fxaa_band"] > 0
            and band_counts["raytrace_megakernel_k8"] > 0,
            "the sharded loop launched kernel A and kernel B's band form")
    require(band_counts["fxaa"] == 0 and band_counts["raytrace_megakernel"]
            == 0, "the sharded loop ran no full-frame launch")

    # the graph path against the single-device graph Engine, frames and
    # states bit for bit, and every replica against that state after every
    # call
    pv = {il: Engine(dataclasses.replace(cfg, preview=2, shard_interleave=il),
                     DEVICE, sharded=mesh4, share_assets_from=eng)
          for il in (1, 2)}
    eng_pv = Engine(dataclasses.replace(cfg, preview=2), DEVICE,
                    share_assets_from=eng)

    def sharded_vs_single(e, one, kind, n, k):
        acts = toggling_actions(n, seed=23)
        dts = [1 / 60 + 0.01 * (i % 4) for i in range(n)]
        call = {"frame": lambda x, a, d: x.step_and_frame(a[0], d[0]),
                "preview": lambda x, a, d: x.step_and_frame_preview(a[0],
                                                                    d[0]),
                "batch": lambda x, a, d: x.step_and_frame_batch(a, d)}[kind]
        for x in (e, one):
            x.set_state(make_state(9.5))
        ok = dict.fromkeys(("single", "replicas"), True)
        for i in range(0, n, k):
            a, d = acts[i:i + k], dts[i:i + k]
            got = call(e, a, d)
            ok["single"] &= (torch.equal(got, call(one, a, d))
                             and states_equal(e.state, one.state))
            ok["replicas"] &= all(
                states_equal(live, one.state)
                for live in e._replicas[tuple(e.mesh)].live)
        return ok

    for il in (1, 2):
        for kind, n, k, e, one in (("frame", 60, 1, eng_sh[il], eng),
                                   ("preview", 60, 1, pv[il], eng_pv),
                                   ("batch", 64, BATCH, eng_sh[il], eng)):
            ok = sharded_vs_single(e, one, kind, n, k)
            require(all(ok.values()),
                    f"sharded {kind} (K={k}, [cuda:0] * 4, interleave {il}): "
                    f"{n} frames with a preset change and an FXAA toggle by "
                    f"one CUDA graph per entry equal the single-device graph "
                    f"Engine ({ok['single']}), frames and states bit for "
                    f"bit; every replica equals that state after every "
                    f"call ({ok['replicas']})")
    golden_sh = {}
    for name, kw in CASES.items():
        eng.set_state(make_state(**kw))
        ref = eng.step_and_frame(idle, 0.0)
        for il in (1, 2):
            eng_sh[il].set_state(make_state(**kw))
            img = eng_sh[il].step_and_frame(idle, 0.0)
            rm, off = golden_stats(img.cpu().numpy(), load_png(
                os.path.join(GOLDEN_DIR, f"{name}.png")))
            golden_sh[f"{name}_il{il}"] = {"rmse": rm, "off_frac": off}
            require(torch.equal(img, ref) and rm < GOLDEN_RMSE
                    and off < GOLDEN_OFF_FRAC,
                    f"{name}: the sharded graph frame (interleave {il}) "
                    f"equals the single-device graph frame "
                    f"({torch.equal(img, ref)}) and the golden: rmse "
                    f"{rm:.5f} off>2 {off:.4%}")

    # the sharded frame(): one CUDA graph per entry rendering its rows of
    # its replica, unstepped, against the single-device frame graph; a
    # replay launches each band form once per entry and nothing else
    frame_sh = {}
    for il in (1, 2):
        e = eng_sh[il]
        ok, counts_ok = True, True
        for name, kw in [*CASES.items(), ("worst_pose", POSES["worst_pose"])]:
            for x in (e, eng):
                x.set_state(make_state(**kw))
            for _ in range(2):
                reset_counts()
                img = e.frame()
                torch.cuda.synchronize()
                counts = read_counts()
                if ("render", 1) in e._replicas[tuple(e.mesh)].graphs:
                    counts_ok &= (
                        counts["raytrace_megakernel_k8"] == 4 * il
                        and counts["fxaa_band"] == 4 * il
                        and counts["raytrace_megakernel"] == 0
                        and counts["fxaa"] == 0)
                ok &= torch.equal(img, eng.frame())
        frame_sh[il] = e._replicas[tuple(e.mesh)].graphs["render", 1]
        require(ok and counts_ok and len(frame_sh[il]) == 4,
                f"sharded frame() ([cuda:0] * 4, interleave {il}), the 4 "
                f"golden states and the worst pose, twice each: by one CUDA "
                f"graph per entry once warm ({len(frame_sh[il])} graphs), "
                f"equal to the single-device frame() bit for bit ({ok}); "
                f"a replay launched kernel A's "
                f"and kernel B's band forms {4 * il} times each (once per "
                f"chunk) and nothing else ({counts_ok})")

    # frame DP and the hybrid against step_and_frame: three calls (eager,
    # the capture, a replay), frames, end state and every replica
    acts = toggling_actions(16, seed=24)
    st0 = make_state(9.5)
    eng.set_state(st0)
    seq = torch.stack([eng.step_and_frame(a, 1 / 30) for a in acts])
    end = eng.state
    eng_dp = Engine(dataclasses.replace(cfg, shard_interleave=2), DEVICE,
                    share_assets_from=eng)
    script_counts = {}
    layouts = (("frame DP over [cuda:0] * 2", dict(mesh=[DEVICE] * 2)),
               ("hybrid 2 x 2, interleave 2",
                dict(n_rows=2, mesh=[[DEVICE] * 2] * 2)))
    for label, kw in layouts:
        for call in range(3):
            eng_dp.set_state(st0)
            reset_counts()
            imgs = eng_dp.render_script_dp(acts, dt=1 / 30, **kw)
            torch.cuda.synchronize()
            script_counts[label] = read_counts()
            reps = next(r for r in eng_dp._replicas.values() if r.current)
            require(torch.equal(imgs, seq) and states_equal(eng_dp.state, end)
                    and all(states_equal(live, end) for live in reps.live),
                    f"Engine.render_script_dp, {label}, call {call + 1} of "
                    f"3 ({'eager' if call == 0 else 'by CUDA graphs'}): 16 "
                    f"frames, end state and each of {len(reps.live)} "
                    f"replicas equal 16 step_and_frame calls")
    print(f"launch counts in render_script_dp (a replay): {script_counts}",
          flush=True)

    # the replays read nothing back and copy from no pageable memory
    vecs8 = [idle] * BATCH
    for label, kw in layouts:
        for _ in range(2):
            eng_dp.render_script_dp(vecs8, **kw)
    eng_sh[2].step_and_frame_batch(vecs8)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng_sh[2].step_and_frame(idle)
        eng_sh[2].step_and_frame_batch(vecs8)
        pv[2].step_and_frame_preview(idle)
        eng_sh[1].frame()
        eng_sh[2].frame()
        for label, kw in layouts:
            eng_dp.render_script_dp(vecs8, **kw)
        synced = None
    except RuntimeError as e:
        synced = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    require(synced is None, f"the sharded and script graph paths' replays "
            f"(step calls and frame()) run under "
            f"torch.cuda.set_sync_debug_mode('error'): {synced}")

    # the numbers: each entry's graph by replay, host ms per call, the
    # host's API calls per call, each graph pool's memory, script fps
    entry_ms = {il: [] for il in (1, 2)}
    for _ in range(3):                     # in turns
        for il in (1, 2):
            eng_sh[il].set_state(make_state(6.0))
            eng_sh[il].step_and_frame(idle)
            graphs = eng_sh[il]._replicas[tuple(eng_sh[il].mesh)].graphs
            entry_ms[il].append([replay_ms(g.graph, 1, 20)
                                 for g in graphs["bands", 1]])
    host_ms = {}
    for il in (1, 2):
        e = eng_sh[il]

        def call():
            e.step_and_frame(idle)

        e.set_state(make_state(6.0))
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(60):
            call()
        t_host = (time.perf_counter() - t0) * 1e3 / 60
        torch.cuda.synchronize()
        drained = (time.perf_counter() - t0) * 1e3 / 60
        # a call's own host time, which a full launch queue does not
        # throttle: 8 calls enqueued from an idle device, 5 times
        host_ms[f"graph il{il}"] = (
            t_host, drained, statistics.median(
                from_idle(call, 8) for _ in range(5)))
    replay_host = {}
    for il in (1, 2):
        graphs = eng_sh[il]._replicas[tuple(eng_sh[il].mesh)].graphs
        replay_host[il] = [statistics.median(
            from_idle(g.graph.replay, 8) for _ in range(5))
            for g in graphs["bands", 1]]
    # device-bound: the Engine's loop against its entries' graphs replayed
    # back to back with nothing between them, 30 frames each, in turns
    # (the card's speed moves between two modes over a run, PERF.md §7)
    bound_pairs = {il: [] for il in (1, 2)}
    for _ in range(3):
        for il in (1, 2):
            e = eng_sh[il]
            graphs = e._replicas[tuple(e.mesh)].graphs["bands", 1]
            e.set_state(make_state(6.0))
            loop = statistics.median(e.run(30).frame_ms)
            timer = FrameTimer(W, H, dev).start()
            for _ in range(30):
                for g in graphs:
                    g.graph.replay()
                timer.tick()
            bound_pairs[il].append(
                (loop, statistics.median(timer.stop().frame_ms)))
    calls = {}
    for il in (1, 2):
        got = profiled_calls(lambda: eng_sh[il].step_and_frame(idle), 30)
        require(got is not None, f"a torch.profiler trace of 30 sharded "
                f"calls (interleave {il}) holds the host's CUDA graph "
                f"launches")
        api, memcpy = got
        calls[il] = {"api": api, "memcpy": memcpy}
        print(f"sharded graph path, interleave {il}, 30 step_and_frame "
              f"calls (torch.profiler): host API calls {api}; device "
              f"copies {memcpy} [{card}]", flush=True)
        per = {what: sum(v for k, v in api.items() if what in k) / 30
               for what in ("GraphLaunch", "Memcpy", "LaunchKernel")}
        require(per["GraphLaunch"] == 4 and per["Memcpy"] <= 2 * 4 + 1
                and per["LaunchKernel"] == 0,
                f"a sharded call (interleave {il}) launches 4 graphs "
                f"({per['GraphLaunch']}), at most 9 copies "
                f"({per['Memcpy']}) and no kernel of its own "
                f"({per['LaunchKernel']}) per call")
    # the sharded frame(): each entry's render graph by replay, host ms per
    # call from an idle device, the host's API calls per call
    frame_sh_ms = {}
    for il in (1, 2):
        e = eng_sh[il]
        e.set_state(make_state(6.0))
        got = calls_per(e.frame, 10)
        require(got is not None and got[0]["GraphLaunch"] == 4
                and got[0]["LaunchKernel"] == 0,
                f"a sharded frame() call (interleave {il}) launches 4 CUDA "
                f"graphs and no kernel (torch.profiler, 10 calls): "
                f"{got and got[0]}")
        frame_sh_ms[il] = {
            "entries": [replay_ms(g.graph, 1, 20) for g in frame_sh[il]],
            "host_from_idle": statistics.median(from_idle(e.frame, 8)
                                                for _ in range(5)),
            "per_call": got[0]}
        print(f"sharded frame() graphs, interleave {il}, 1280x720 island "
              f"day 6: each entry's graph by replay "
              f"{frame_sh_ms[il]['entries']} ms (sum "
              f"{sum(frame_sh_ms[il]['entries']):.4f}); host ms per call "
              f"(8 from an idle device, median of 5) "
              f"{frame_sh_ms[il]['host_from_idle']:.4f}; per call "
              f"{got[0]} (torch.profiler) [{card}]", flush=True)
    pools = {}
    for label, e in (("single", eng), ("sharded il1", eng_sh[1]),
                     ("sharded il2", eng_sh[2]), ("preview il2", pv[2]),
                     ("script", eng_dp)):
        for reps in e._holders():
            for key, graphs in reps.graphs.items():
                pools[f"{label} {key}"] = [
                    tuple(round(b / 2 ** 20, 1) for b in g.memory)
                    for g in graphs]
    print(f"CUDA graph pools, (allocated, reserved) MB per entry kept by "
          f"each capture: {pools} [{card}]", flush=True)
    # one entry's rows gathered into the frame, by graph replay
    frame = torch.empty((1, H, W, 3), dtype=torch.uint8, device=dev)
    gather_ms = {}
    for il in (1, 2):
        reps = eng_sh[il]._replicas[tuple(eng_sh[il].mesh)]
        out = reps.graphs["bands", 1][0].out
        gather_ms[il] = graph_device_ms(
            lambda out=out: place_bands(frame, out, 0, 4), 20)
    script_fps = {}
    vecs8 = pack_actions(vecs8, [1 / 60] * BATCH)
    for label, kw in (("run(batch=8)", None), *layouts, *layouts[::-1],
                      ("run(batch=8)", None)):
        if kw is None:
            eng.set_state(make_state(6.0))
            st = eng.run(64, batch=BATCH)
        else:
            eng_dp.set_state(make_state(6.0))
            timer = FrameTimer(W, H, dev).start()
            for _ in range(64 // BATCH):
                eng_dp.render_script_dp(vecs8, **kw)
                timer.tick(BATCH)
            st = timer.stop()
        script_fps.setdefault(label, []).append((st.fps, st.host_fps))
    sums = {il: [sum(r) for r in entry_ms[il]] for il in (1, 2)}
    for il in (1, 2):
        dev_ms = statistics.median(sums[il])
        over = statistics.median(a / b - 1 for a, b in bound_pairs[il])
        print(f"sharded graph path, interleave {il}: entries' graphs by "
              f"replay (3 rounds) {entry_ms[il]} ms, sum median "
              f"{dev_ms:.4f} ms; loop frame ms (CUDA events) "
              f"{loop_ms[f'sharded graph il{il}']}, single graph "
              f"{loop_ms['single graph']}; in turns, the loop's frame ms "
              f"against its entries' graphs replayed back to back (CUDA "
              f"events, medians of 30) {bound_pairs[il]}; host ms per call "
              f"(60 enqueued ahead of the device, drained, 8 from an idle "
              f"device) graph {host_ms[f'graph il{il}']}; host ms per entry "
              f"replay (8 "
              f"from an idle device) {replay_host[il]}; one entry's gather "
              f"{gather_ms[il]:.4f} ms by replay [{card}]", flush=True)
        slowest = max(statistics.median(r[e] for r in entry_ms[il])
                      for e in range(4))
        print(f"projection, not a measurement: on 4 distinct cards a "
              f"sharded frame (interleave {il}) would take the larger of "
              f"the slowest entry's graph plus a gather, "
              f"{slowest + gather_ms[il]:.4f} ms, and a call's host time, "
              f"{host_ms[f'graph il{il}'][2]:.4f} ms [{card}]", flush=True)
        require(host_ms[f"graph il{il}"][0] < dev_ms,
                f"host ms per sharded call (interleave {il}) "
                f"{host_ms[f'graph il{il}'][0]:.4f} below its device ms "
                f"{dev_ms:.4f}")
        require(abs(over) <= 0.15,
                f"the sharded loop's frame time (interleave {il}) is within "
                f"15 % of its entries' graphs replayed back to back in the "
                f"same turn ({over:+.2%}, median of 3 turns): the loop is "
                f"device-bound")
    print(f"render_script_dp fps (CUDA events, host clock), 64 frames in "
          f"calls of K = {BATCH}, against Engine.run(64, batch={BATCH}): "
          f"{script_fps} [{card}]", flush=True)

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
                          "loop_ms": loop_ms, "counts": band_counts,
                          "script_counts": script_counts,
                          "golden_sharded": golden_sh,
                          "entry_graph_ms": entry_ms, "host_ms": host_ms,
                          "replay_host_ms": replay_host,
                          "loop_vs_graphs_ms": bound_pairs,
                          "api_calls": calls, "pools_mb": pools,
                          "gather_ms": gather_ms, "script_fps": script_fps,
                          "frame_graphs": frame_sh_ms}

    # --- 9. the fast and oracle paths, the preview and the readback ---
    phase(9)
    from raytracing_cuda_tpu_torch.app.window import Readback
    from raytracing_cuda_tpu_torch.utils.images import box_downsample

    eng_path = {"oracle": Engine(dataclasses.replace(cfg, path="oracle"),
                                 DEVICE)}
    eng_path["fast"] = Engine(dataclasses.replace(cfg, path="fast"), DEVICE,
                              share_assets_from=eng_path["oracle"])
    path_stats, path_ms = {}, {}
    # each path's frame() graph (the first call eager, the second captures),
    # then held against _frame_eager() (the `fast` early exits decided on
    # the host) at the goldens and the worst pose
    for e in eng_path.values():
        e.set_state(make_state(6.0))
        for _ in range(2):
            e.frame()
    mismatch = []
    for name, kw in [*CASES.items(), ("worst_pose", POSES["worst_pose"])]:
        st = make_state(**kw)
        eng.set_state(st)
        kernel_img = eng.frame_np()
        gold = (load_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
                if name in CASES else None)
        for path, e in eng_path.items():
            e.set_state(st)
            frame = e.frame()
            if not torch.equal(frame, e._frame_eager()):
                mismatch.append(f"{path} {name}")
            img = frame.cpu().numpy()
            require(img.shape == (H, W, 3) and img.dtype == np.uint8,
                    f"{name}: {path} frame shape {img.shape} {img.dtype}")
            vs_kernel = golden_stats(img, kernel_img)
            path_stats[f"{path}_{name}"] = {"kernel_path": vs_kernel}
            if gold is None:
                continue
            vs_gold = golden_stats(img, gold)
            path_stats[f"{path}_{name}"]["golden"] = vs_gold
            require(all(rm < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC
                        for rm, off in (vs_gold, vs_kernel)),
                    f"{name}: Engine(path={path}) vs golden rmse "
                    f"{vs_gold[0]:.5f} off>2 {vs_gold[1]:.4%}; vs the "
                    f"megakernel path rmse {vs_kernel[0]:.5f} off>2 "
                    f"{vs_kernel[1]:.4%}")
    require(not mismatch and all(set(e._graphs) == {("render", 1)}
                                 for e in eng_path.values()),
            f"frame() of Engine(path=fast|oracle) by CUDA graph replay "
            f"equals _frame_eager() bit for bit at the four goldens and the "
            f"worst pose; mismatches {mismatch}")
    print(f"Engine(path=fast|oracle) at the worst pose against the "
          f"megakernel path (rmse, share off by more than 2): "
          f"{[path_stats[f'{p}_worst_pose'] for p in eng_path]}", flush=True)
    classic_cfg = dataclasses.replace(cfg, scene="classic",
                                      procedural_sky_shape=(1024, 2048))
    classic_frames, mismatch = {}, []
    for path in ("auto", "oracle", "fast"):
        e = Engine(dataclasses.replace(classic_cfg, path=path), DEVICE)
        e.set_state(classic_st)
        for _ in range(3 if path != "auto" else 1):
            frame = e.frame()             # eager, capture, replay
        if path != "auto" and not (torch.equal(frame, e._frame_eager())
                                   and ("render", 1) in e._graphs):
            mismatch.append(path)
        classic_frames[path] = frame.cpu().numpy()
        del e, frame
    require(not mismatch, f"classic: frame() by CUDA graph replay equals "
            f"_frame_eager() bit for bit on the fast and oracle paths; "
            f"mismatches {mismatch}")
    for path in ("oracle", "fast"):
        rm, off = golden_stats(classic_frames[path], classic_frames["auto"])
        path_stats[f"{path}_classic"] = {"kernel_path": (rm, off)}
        require(rm < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC,
                f"classic: Engine(path={path}) vs the megakernel path rmse "
                f"{rm:.5f} off>2 {off:.4%}")
    torch.cuda.empty_cache()

    # each path's step calls as CUDA graphs against the eager device step:
    # step_and_frame, its preview (an Engine at preview 2) and a batch of 2
    # (two replays of the step_and_frame graph)
    eng_path_pv = {p: Engine(dataclasses.replace(cfg, path=p, preview=2),
                             DEVICE, share_assets_from=e)
                   for p, e in eng_path.items()}
    for path, e in eng_path.items():
        for kind, n, k, ek in (("frame", 3, 1, e),
                               ("preview", 2, 1, eng_path_pv[path]),
                               ("batch", 4, 2, e)):
            same, snap, kept = graph_vs_eager(ek, kind, n, k, seed=31)
            require(same and snap and kept,
                    f"Engine(path={path}) {kind} (K={k}"
                    f"{', preview 2' if kind == 'preview' else ''}): {n} "
                    f"frames by CUDA graph replay equal the eager device "
                    f"step bit for bit, frames and states ({same}); states "
                    f"read before a call unchanged ({snap}); no frame "
                    f"overwritten ({kept})")
    two = [Action.idle()] * 2
    plain_calls = {p: (("frame()", 1, e.frame),
                       ("step_and_frame", 1, e.step_and_frame),
                       ("preview", 1, eng_path_pv[p].step_and_frame_preview),
                       ("batch of 2", 2,
                        lambda e=e: e.step_and_frame_batch(two)))
                   for p, e in eng_path.items()}
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for calls in plain_calls.values():
            for _, _, call in calls:
                call()
        synced = None
    except RuntimeError as err:
        synced = str(err)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    require(synced is None, f"the fast and oracle paths' replays (frame(), "
            f"step_and_frame, preview 2, a batch of 2) run under "
            f"torch.cuda.set_sync_debug_mode('error'): {synced}")
    # this slice's main path: each path's step_and_frame graph, with the
    # counters set to 0 just before and read just after
    plain_counts = {}
    for path, e in eng_path.items():
        e.set_state(make_state(6.0))
        reset_counts()
        for _ in range(2):
            e.step_and_frame()
        torch.cuda.synchronize()
        plain_counts[path] = read_counts()
        require(plain_counts[path]["fxaa"] == 2
                and plain_counts[path]["raytrace_megakernel"] == 0,
                f"2 step_and_frame replays of Engine(path={path}) launched "
                f"kernel B twice and kernel A never: {plain_counts[path]}")
    # the times: eager and replay in turns, host ms per call, capture,
    # nodes and pools; then the API calls per call (torch.profiler), and
    # the host ms per call again after it
    for path, calls in plain_calls.items():
        e = eng_path[path]
        e.set_state(make_state(6.0))
        st = e.state
        g = e._graphs[("render", 1)]
        turns = {"eager_ms": [], "replay_ms": []}
        for turn in ("eager_ms", "replay_ms", "replay_ms", "eager_ms"):
            turns[turn].append(timed(e._frame_eager)[1] if turn == "eager_ms"
                               else replay_ms(g.graph, 1, 2))
        path_ms[path] = dict(
            turns, host_ms=from_idle(e.frame, 3), capture_s=g.seconds,
            nodes=graph_nodes(lambda: e._step_render("render", st, None)),
            pools_mb={
                f"{label} {key}": pool_mb([gr])
                for label, en in (("frame", e), ("preview", eng_path_pv[path]))
                for key, gr in en._graphs.items()},
            capture_s_by_key={
                f"{label} {key}": round(gr.seconds, 3)
                for label, en in (("frame", e), ("preview", eng_path_pv[path]))
                for key, gr in en._graphs.items()})
        per_call = path_ms[path]["per_call"] = {}
        for label, k, call in calls:
            got = calls_per(call, 1)
            require(got is not None and got[0]["GraphLaunch"] == k
                    and got[0]["LaunchKernel"] == 0
                    and got[0]["Memcpy"] <= 2 * k,
                    f"Engine(path={path}) {label}: {k} CUDA graph "
                    f"launch{'es' if k > 1 else ''}, no kernel and at most "
                    f"{2 * k} copies a call (torch.profiler): "
                    f"{got and got[0]}")
            per_call[label] = got[0]
        path_ms[path]["host_ms_after_profiler"] = from_idle(e.frame, 3)
        print(f"Engine(path={path}) 1280x720 island_morning, chunk "
              f"{cfg.chunk}: frame() eager (early exits on the host) and by "
              f"graph replay in turns (CUDA events), host ms per call (3 "
              f"from an idle device), capture s, graph nodes, API calls per "
              f"call, pools (allocated, reserved) MB: {path_ms[path]} "
              f"[{card}]", flush=True)
    del eng_path_pv
    torch.cuda.empty_cache()

    # fast: chunk size never changes a pixel (eager, early exits on the host)
    st = make_state(**CASES["mountains_day"])
    chunked, chunks = [], (16384, 65536)
    for chunk in chunks:
        e = Engine(dataclasses.replace(cfg, path="fast", chunk=chunk), DEVICE,
                   share_assets_from=eng_path["fast"])
        e.set_state(st)
        chunked.append(e._frame_eager())
        path_ms[f"fast_chunk{chunk}"] = timed(e._frame_eager)[1]
    require(torch.equal(*chunked), f"Engine(path=fast) at chunks {chunks}: "
            f"frames equal bit for bit")
    print("Engine(path=fast)._frame_eager() 1280x720 mountains_day: "
          + ", ".join(f"chunk {c} {path_ms[f'fast_chunk{c}']:.4f} ms"
                      for c in chunks) + f" (CUDA events) [{card}]",
          flush=True)

    # a row-sharded fast Engine: one CUDA graph per mesh entry per call
    # (entry_bands_plain) against the unsharded Engine's graphs
    sharded_plain = {}
    for il, names in ((1, sorted(CASES)), (2, sorted(CASES)[:2])):
        sh = Engine(dataclasses.replace(cfg, path="fast",
                                        shard_interleave=il), DEVICE,
                    sharded=[DEVICE] * 4, share_assets_from=eng_path["fast"])
        one = eng_path["fast"]
        mismatch = []
        for name in names:
            st = make_state(**CASES[name])
            sh.set_state(st)
            one.set_state(st)
            if not torch.equal(sh.frame(), one.frame()):
                mismatch.append(name)
        for i, a in enumerate(random_actions(3, seed=32 + il)):
            got = sh.step_and_frame(a, 0.05)
            if not (torch.equal(got, one.step_and_frame(a, 0.05))
                    and states_equal(sh.state, one.state)):
                mismatch.append(f"step {i}")
        graphs = sh._replicas[tuple(sh.mesh)].graphs
        require(not mismatch and len(graphs[("render", 1)]) == 4
                and len(graphs[("bands", 1)]) == 4,
                f"Engine(path=fast, sharded=[cuda:0] * 4, interleave {il}): "
                f"frame() at {names} and 3 step_and_frame calls by one CUDA "
                f"graph per entry equal the unsharded Engine, frames and "
                f"states bit for bit; mismatches "
                f"{mismatch}")
        reset_counts()
        sh.step_and_frame()
        torch.cuda.synchronize()
        counts = read_counts()
        require(counts["fxaa_band"] == 4 * il
                and counts["raytrace_megakernel_k8"] == 0,
                f"a sharded fast step_and_frame (interleave {il}) launched "
                f"kernel B's band form once per chunk and kernel A never: "
                f"{counts}")
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sh.step_and_frame()
            sh.frame()
            synced = None
        except RuntimeError as err:
            synced = str(err)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        require(synced is None, f"the sharded fast graphs' replays "
                f"(interleave {il}) run under sync debug mode 'error': "
                f"{synced}")
        got = calls_per(sh.step_and_frame, 1)
        require(got is not None and got[0]["GraphLaunch"] == 4
                and got[0]["LaunchKernel"] == 0,
                f"a sharded fast step_and_frame call (interleave {il}) "
                f"launches 4 CUDA graphs and no kernel (torch.profiler): "
                f"{got and got[0]}")
        sharded_plain[il] = {
            "counts": counts, "per_call": got[0],
            "entry_replay_ms": [replay_ms(g.graph, 1, 2)
                                for g in graphs[("bands", 1)]],
            "host_ms": from_idle(sh.step_and_frame, 2),
            "capture_s": [round(g.seconds, 3) for g in graphs[("bands", 1)]],
            "pools_mb": {str(key): pool_mb(gs) for key, gs in graphs.items()}}
        print(f"Engine(path=fast, sharded=[cuda:0] * 4, interleave {il}) "
              f"1280x720: each entry's step_and_frame graph by replay, host "
              f"ms per call (2 from an idle device), capture s, API calls "
              f"per call, pools (allocated, reserved) MB: "
              f"{sharded_plain[il]} [{card}]", flush=True)
        del sh, graphs
        torch.cuda.empty_cache()
    path_ms["sharded_fast"] = sharded_plain
    fast_band_counts = sharded_plain[1]["counts"]

    # sky_cache=False: blend + pack per frame against the static stack,
    # eagerly and by its frame() graph
    eng_one_shot = Engine(dataclasses.replace(cfg, sky_cache=False), DEVICE,
                          share_assets_from=eng_path["fast"])
    mismatch = []
    for name, kw in [*CASES.items(), ("crossfade", dict(day=9.5))]:
        st = make_state(**kw)
        eng.set_state(st)
        eng_one_shot.set_state(st)
        ref = eng._frame_eager()
        for _ in range(2):
            if not (torch.equal(eng_one_shot._frame_eager(), ref)
                    and torch.equal(eng_one_shot.frame(), ref)):
                mismatch.append(name)
    require(not mismatch and ("render", 1) in eng_one_shot._graphs,
            f"Engine(sky_cache=False) equals the default Engine's eager "
            f"frame bit for bit, eagerly and by its frame() graph (each "
            f"state twice); mismatches {mismatch}")
    # its step calls as CUDA graphs: step + the one-shot render_frame
    one_shot_pv = Engine(dataclasses.replace(cfg, sky_cache=False, preview=2),
                         DEVICE, share_assets_from=eng_path["fast"])
    for kind, n, k, e in (("frame", 12, 1, eng_one_shot),
                          ("preview", 12, 1, one_shot_pv),
                          ("batch", 12, 3, eng_one_shot)):
        same, snap, kept = graph_vs_eager(e, kind, n, k, seed=26)
        require(same and snap and kept,
                f"sky_cache=False {kind} (K={k}"
                f"{', preview 2' if kind == 'preview' else ''}): {n} frames "
                f"by CUDA graph replay equal the eager device step bit for "
                f"bit, frames and states ({same}); states read before a "
                f"call unchanged ({snap}); no frame overwritten ({kept})")
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng_one_shot.step_and_frame()
        eng_one_shot.step_and_frame_batch([Action.idle()] * 3)
        one_shot_pv.step_and_frame_preview()
        eng_one_shot.frame()
        synced = None
    except RuntimeError as e:
        synced = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    require(synced is None, f"the sky_cache=False graphs' replays run under "
            f"torch.cuda.set_sync_debug_mode('error'): {synced}")
    eng_one_shot.set_state(make_state(6.0))
    one_shot = {}
    for label, key, call in (
            ("frame()", ("render", 1), eng_one_shot.frame),
            ("step_and_frame", ("frame", 1), eng_one_shot.step_and_frame)):
        got = calls_per(call, 10)
        require(got is not None and got[0]["GraphLaunch"] == 1
                and got[0]["LaunchKernel"] == 0,
                f"a sky_cache=False {label} call launches one CUDA graph and "
                f"no kernel (torch.profiler, 10 calls): {got and got[0]}")
        one_shot[label] = {
            "replay_ms": replay_ms(eng_one_shot._graphs[key].graph, 1, 20),
            "host_from_idle": statistics.median(from_idle(call, 8)
                                                for _ in range(5)),
            "per_call": got[0]}
    one_shot["pools_mb"] = {
        f"{label} {key}": pool_mb([g])
        for label, e in (("one-shot", eng_one_shot),
                         ("one-shot preview", one_shot_pv))
        for key, g in e._graphs.items()}
    print(f"sky_cache=False graphs 1280x720 island day 6: frame() and "
          f"step_and_frame by replay, host ms per call (8 from an idle "
          f"device, median of 5), API calls per call; each pool "
          f"(allocated, reserved) MB: {one_shot} [{card}]", flush=True)
    del eng_one_shot, one_shot_pv, chunked

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
                       "loop_ms": loop_ms, "ring_counts": ring_counts,
                       "one_shot": one_shot}

    # --- 10. other sizes: 1920x1080 against its goldens, 640x480 ---
    phase(10)

    def held_frame(label, h, w, st):
        """Both kernels' full-frame wrappers against their plain versions,
        bit for bit, on the h x w frame of state st → (kernel A's launch,
        its planes, the frame before FXAA)."""
        coef_h, params_h, nt_, ns_, cull_h = frame_packs(scene, st, h, w,
                                                        None, *clusters)
        coef_d, params_d, cull_d = (t.to(dev) for t in (coef_h, params_h,
                                                        cull_h))

        def run_a():
            return cuda_rt.raytrace_planes(coef_d, params_d, h, w, nt_, ns_,
                                           cull=cull_d)

        planes = run_a()
        plain = cuda_rt.raytrace_planes_torch(coef_d, params_d, h, w, nt_,
                                              ns_)
        base = sky_bases([p[None] for p in planes], [st], eng.sky_pack,
                         f"{label} at {w}x{h}")[0]
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
        packs = [frame_packs(scene, st, h, w, None, *clusters)
                 for st in states]
        coefs = torch.stack([p[0] for p in packs]).to(dev)
        params_ = torch.stack([p[1] for p in packs]).to(dev)
        nt_, ns_, cull_d = packs[0][2], packs[0][3], packs[0][4].to(dev)
        full = cuda_rt.raytrace_planes_batch(coefs, params_, h, w, nt_, ns_,
                                             cull=cull_d)
        a_ok = all(torch.equal(a, b) for a, b in zip(
            full, cuda_rt.raytrace_planes_batch_torch(coefs, params_, h, w,
                                                      nt_, ns_)))
        bases = sky_bases(full, states, eng.sky_pack,
                          f"{label}: K={len(states)} frames of {w}x{h}")
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
        kernel A, of the sky kernel between the kernels and of kernel B,
        each by CUDA graph replay, and the sky kernel's bound."""
        run_a, planes, base = held_frame(f"{w}x{h}", h, w, st)
        sky_planes = [p[None] for p in planes]
        sky_args = (eng.sky_pack, *SKY_SHAPE, *sky_inputs([st], dev))
        return {"raytrace": graph_device_ms(run_a, 20),
                "sky_quantize": graph_device_ms(
                    lambda: sky_quantize(sky_planes, *sky_args), 50),
                "sky_bound": sky_bound(sky_planes)[0],
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
    require(counts["raytrace_megakernel"] == 4 and counts["fxaa"] == 4
            and counts["sky"] == 4,
            f"the 1080p frames launched kernel A, the sky kernel and kernel "
            f"B 4 times each "
            f"(the state with FXAA off keeps its base frame by a select on "
            f"the card): {counts}")
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
          f"quantize {sizes['1920x1080']['sky_quantize']:.4f} (graph "
          f"replay; bound {sizes['1920x1080']['sky_bound']:.6f}), kernel B "
          f"{sizes['1920x1080']['fxaa']:.4f} (graph replay); Engine.run(60) "
          f"{st1080.fps:.2f} fps, frame ms median "
          f"{ms[len(ms) // 2]:.4f} [{card}]", flush=True)
    del eng_1080

    st480 = bench_torch.preset_state(day=14.0, cam_preset=1, aa=False)
    eng_480 = eng.resized(640, 480)
    eng_480.set_state(st480)
    reset_counts()
    img = eng_480.frame_np()
    counts = read_counts()
    require(counts["raytrace_megakernel"] == 1 and counts["fxaa"] == 1
            and counts["sky"] == 1,
            f"the 640x480 frame (FXAA off, selected on the card) launched "
            f"kernel A, the sky kernel and kernel B once each: {counts}")
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
          f"quantize {sizes['640x480']['sky_quantize']:.4f} (graph replay), "
          f"kernel B {sizes['640x480']['fxaa']:.4f} (graph replay; the "
          f"state has FXAA off, so its frames keep the base) [{card}]",
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

    out, err = io.StringIO(), io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_torch.main(["--size", f"{W}x{H}", "--frames", "60"])
    counts = read_counts()
    sys.stderr.write(err.getvalue())
    # its details, the last JSON object it logs, against the frame() graph
    # by replay at the worst pose right after it: the frozen
    # configurations time frame() calls, each now one graph replay
    text = err.getvalue()
    bench_details = json.loads(text[text.rindex("\n{\n") + 1:])
    eng.set_state(bench_torch.preset_state(day=17.6, yaw=315.0))
    eng.frame()
    worst_replay = replay_ms(eng._graphs[("render", 1)].graph, 1, 10)
    frozen = {k: bench_details.get(k) for k in (
        "mountains_640x480_noaa_ms_events", "island_sea_sweep_ms_events",
        "fxaa_on_ms_events", "fxaa_off_ms_events", "fxaa_cost_ms_events",
        "time_of_day_ms_events", "low_sun_worst_ms_events")}
    print(f"bench_torch.main's frozen configurations (CUDA events, ms per "
          f"frame() call): {frozen}; the frame() graph by replay at the "
          f"worst pose right after: {worst_replay:.4f} ms, so "
          f"low_sun_worst_ms_events reads "
          f"{frozen['low_sun_worst_ms_events'] / worst_replay - 1:+.2%} of "
          f"it [{card}]", flush=True)
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
    report["bench_torch_frozen"] = dict(frozen, worst_replay_ms=worst_replay)

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

    # --- 12. the arms: kernel A's diagnostic variants, and the probes ---
    phase(12)
    from experiments import (megakernel_ablation_torch as ablation,
                             readback_fps_torch, tail_probe_torch,
                             worst_pose_decompose_torch as decompose)

    # every arm against the same arm of the plain version; the arms that
    # compute the shipped function against the shipped kernel, which
    # phase 3 held against its plain version
    identity = ("nocull", "no_tbound", "nohcull", "depth4")
    arms = {k: v for k, v in ablation.ARMS.items() if v}
    arms["depth4"] = ("depth4",)
    # at the worst pose the plain version also counts each arm's work, for
    # its bound (an arm that computes the shipped function has its bound)
    arm_err, arm_bounds, arm_plain_ms = 0.0, {}, {}
    for pose in ("worst_pose", "island_morning"):
        coef, params, nt, ns, cu, _, full, _ = inputs[pose]
        for arm, ablate in arms.items():
            kern = torch.stack(cuda_rt.raytrace_planes(
                coef, params, H, W, nt, ns, cull=cu, ablate=ablate))
            if arm in identity:
                want, what = full, "the shipped kernel"
            else:
                work = (dict.fromkeys(cuda_rt.WORK_KEYS, 0)
                        if pose == "worst_pose" else None)
                want, ms = timed(lambda: torch.stack(
                    cuda_rt.raytrace_planes_torch(coef, params, H, W, nt,
                                                  ns, work=work, cull=cu,
                                                  ablate=ablate)))
                what = "its plain version"
                if work is not None:
                    arm_plain_ms[arm] = ms
                    arm_bounds[arm] = raytrace_bound(work, coef, params, 1,
                                                     H, W)
            err = float((kern - want).abs().max())
            arm_err = max(arm_err, err)
            require(bool(torch.isfinite(kern).all()) and err == 0.0
                    and (arm != "noshade" or not kern[:3].any()),
                    f"{pose}: kernel A arm {arm} vs {what} at 720p: "
                    f"max|diff| {err}")

    # the probes, as a user runs them; the arms' counter is read around the
    # first, the path of this phase
    reset_counts()
    abl = {}
    rc = ablation.main(["--reps", "5", "--n", "10"], abl)
    counts = read_counts()
    arm_launches = counts["raytrace_megakernel_arms"]
    require(rc == 0 and set(abl["arms"]) == set(ablation.ARMS)
            and arm_launches > 0 and counts["raytrace_megakernel"] > 0,
            f"megakernel_ablation_torch at the worst pose launched every arm "
            f"(csrc/raytrace_arms.cu) and the shipped kernel: {counts}")
    abl_morning = {}
    rc = ablation.main(["--day", "6", "--yaw", "309", "--reps", "5", "--n",
                        "10"], abl_morning)
    require(rc == 0 and set(abl_morning["arms"]) == set(ablation.ARMS),
            "megakernel_ablation_torch at island_morning ran every arm")
    for label, r in (("worst_pose", abl), ("island_morning", abl_morning)):
        print(f"kernel A arms 720p {label} (device ms, CUDA graph replay, "
              f"median of 5): " + ", ".join(
                  f"{a} {v['median_ms']:.4f}" for a, v in r["arms"].items())
              + f" [{card}]", flush=True)
    print("kernel A arms 720p worst_pose, bound (ms, by) / plain version "
          "(ms, CUDA events, one call): " + ", ".join(
              f"{a} {b[0]:.6f} {b[1]} / {arm_plain_ms[a]:.1f}"
              for a, b in arm_bounds.items())
          + f"; the other arms compute the shipped function, bound "
          f"{bounds_a['worst_pose'][0]:.6f} [{card}]", flush=True)

    dec = {}
    rc = decompose.main(["--reps", "5", "--n", "10"], dec)
    dmed = {k: statistics.median(v) for k, v in dec["device_ms"].items()}
    hmed = {k: statistics.median(v) for k, v in dec["host_ms"].items()}
    require(rc == 0 and all(v > 0 for v in dmed.values())
            and dmed["kernel+sky+fxaa"] > dmed["kernel_only"],
            f"worst_pose_decompose_torch: device stages {dmed}")
    print(f"stage split 720p worst pose: step + packs "
          f"{dmed['step+packs']:.4f}, kernel A {dmed['kernel_only']:.4f}, "
          f"+ sky lookup + quantize {dmed['kernel+sky']:.4f}, + kernel B "
          f"{dmed['kernel+sky+fxaa']:.4f}, the whole frame "
          f"{dmed['whole_frame']:.4f} ms (device time, CUDA graph replay); "
          f"host " + ", ".join(f"{k} {v:.4f}" for k, v in hmed.items())
          + f" ms (host clock; cpu_* the CPU Engine's host half) [{card}]",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        sky_dir = synthetic_skies(os.path.join(tmp, "sky"), 512, 1024)
        ref = {}
        rc = decompose.main(["--reps", "1", "--n", "2", "--sky", "reference",
                             "--sky-dir", sky_dir, "--sky-downsample", "2"],
                            ref)
        rc_missing = decompose.main(["--reps", "1", "--n", "1", "--sky",
                                     "reference", "--sky-dir",
                                     os.path.join(tmp, "none")])
    require(rc == 0 and ref["sky"] == ("reference", 256, 512)
            and rc_missing == 2,
            f"the reference-sky source on synthetic 512x1024 panoramas, "
            f"point-sampled by 2: exit {rc}, sky {ref.get('sky')}; missing "
            f"panoramas exit {rc_missing}")

    tail = {}
    rc = tail_probe_torch.main(["--blocks", "10", "--frames", "10", "--sky",
                                "procedural"], tail)
    require(rc == 0 and tail["frame"]["p50"] > 0,
            f"tail_probe_torch, 10 blocks of 10 frames: per frame "
            f"{tail.get('frame')} [{card}]")
    rb = {}
    rc = readback_fps_torch.main(["--frames", "30", "--reps", "2"], rb)
    require(rc == 0 and all(min(rb[m]["host_fps"]) > 0
                            for m in readback_fps_torch.MODES),
            f"readback_fps_torch, 2 reps of 30 frames: "
            f"{ {m: rb[m]['host_fps'] for m in readback_fps_torch.MODES} } "
            f"fps [{card}]")
    bound_arm = arm_bounds["noshadow"]
    report["arms"] = {"worst_pose": abl, "island_morning": abl_morning,
                      "decompose": dec, "tail": tail, "readback": rb,
                      "bounds_ms": {a: b[0] for a, b in arm_bounds.items()},
                      "plain_ms": arm_plain_ms}

    # --- 13. the frame step on the card: one CUDA graph per call ---
    phase(13)
    from raytracing_cuda_tpu_torch.render.pipeline import pack_actions
    from raytracing_cuda_tpu_torch.utils.timing import (capture_graph,
                                                        replay_ms)

    geng = Engine(cfg, DEVICE, share_assets_from=eng)
    require(all(t.is_cuda for t in (*geng.scene, geng.cull,
                                    *sim.state_tensors(geng.state))),
            "Engine(device='cuda') holds its scene, cull table and state on "
            "the card")
    idle = Action.idle()
    graph_stats = {}
    for label, e, gold_dir in (
            ("1280x720", geng, GOLDEN_DIR),
            ("1920x1080", geng.resized(1920, 1080),
             os.path.join(GOLDEN_DIR, "1920x1080"))):
        e.set_state(make_state(6.0))
        for _ in range(2):                # eager (the warm-up), the capture
            e.step_and_frame(idle, 0.0)
            e.frame()
        for name, kw in [*CASES.items(), ("worst_pose", POSES["worst_pose"])]:
            # an idle step of dt 0 keeps each golden state's clock, sea and
            # toggles; its yaw is re-wrapped by fmod(yaw + 360, 360)
            e.set_state(make_state(**kw))
            reset_counts()
            img = e.step_and_frame(idle, 0.0)
            counts = read_counts()
            eager = e._frame_eager()
            # frame(): the render-only graph, from the state set and from
            # the state the step left
            frames_ok, frame_counts = torch.equal(img, eager), []
            for st in (None, make_state(**kw)):
                if st is not None:
                    e.set_state(st)
                    ref = e._frame_eager()
                reset_counts()
                got = e.frame()
                frame_counts.append(read_counts())
                frames_ok &= torch.equal(got, eager if st is None else ref)
            launched = all(c["raytrace_megakernel"] == 1 and c["fxaa"] == 1
                           and c["packs"] == 1
                           for c in (counts, *frame_counts))
            if name == "worst_pose":
                require(launched and frames_ok,
                        f"worst pose: {label} frames by the step_and_frame "
                        f"and frame() graphs (one launch of each kernel per "
                        f"replay: {launched}) equal the eager frame "
                        f"({frames_ok})")
                continue
            rm, off = golden_stats(img.cpu().numpy(), load_png(
                os.path.join(gold_dir, f"{name}.png")))
            graph_stats[f"golden_{label}_{name}"] = {"rmse": rm,
                                                     "off_frac": off}
            require(launched and frames_ok
                    and rm < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC,
                    f"{name}: {label} frames by the step_and_frame and "
                    f"frame() graphs (one launch of each kernel per replay: "
                    f"{launched}) equal the eager frame of their state "
                    f"({frames_ok}) and the golden: rmse {rm:.5f} off>2 "
                    f"{off:.4%}")

    for kind, n, k, e in (
            ("frame", 60, 1, geng),
            ("batch", 64, BATCH, geng),
            ("preview", 60, 1, Engine(dataclasses.replace(cfg, preview=2),
                                      DEVICE, share_assets_from=eng))):
        same, snap, kept = graph_vs_eager(e, kind, n, k, seed=21)
        require(same and snap and kept,
                f"{kind} (K={k}{', preview 2' if kind == 'preview' else ''})"
                f": {n} frames by CUDA graph replay equal the eager device "
                f"step bit for bit, frames and states ({same}); states read "
                f"before a call unchanged ({snap}); no frame overwritten "
                f"({kept})")

    # step(): one graph of the state step alone (the JAX `_animate`)
    geng.set_state(make_state(9.5))
    st = sim.clone_state(geng.state)
    step_ok = True
    for a in random_actions(12, 27):
        got = geng.step(a, 1 / 30)
        st = sim.animate_packed(st, geng._upload(a.pack(1 / 30)[None])[0])
        step_ok &= states_equal(got, st)
    step_calls = calls_per(lambda: geng.step(idle), 10)
    require(step_ok and ("step", 1) in geng._graphs
            and step_calls is not None and step_calls[0]["GraphLaunch"] == 1
            and step_calls[0]["LaunchKernel"] == 0,
            f"step(): 12 calls (eager, the capture, replays) equal the eager "
            f"device step bit for bit ({step_ok}); a call launches one CUDA "
            f"graph and no kernel (torch.profiler, 10 calls): "
            f"{step_calls and step_calls[0]}")

    # fast_forward at N = 1,000 (record --resume): one step() graph replay
    # per vector once warm, against the device step run eagerly once per
    # vector; in turns, the first graph call warming and capturing
    from raytracing_cuda_tpu_torch.app.loop import _state_copy, _write_state
    from raytracing_cuda_tpu_torch.render.pipeline import step_states

    n_ff, ff_k = 1000, 256
    ff_vecs = pack_actions(random_actions(n_ff, 28), [1 / 30] * n_ff)
    st_ff = make_state(7.9)

    def eager_ff(vecs=ff_vecs):
        st = sim.state_to(st_ff, dev)
        for av in geng._upload(vecs):
            st = sim.animate_packed(st, av)
        return st

    def host_timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    want, _ = host_timed(eager_ff)
    ff_eng = Engine(cfg, DEVICE, share_assets_from=eng)
    ff_ms, ff_ok = {"eager": [], "graph": []}, True
    for _ in range(3):
        got, ms = host_timed(eager_ff)
        ff_ms["eager"].append(ms)
        ff_ok &= states_equal(got, want)
        ff_eng.set_state(st_ff)
        got, ms = host_timed(lambda: ff_eng.fast_forward(ff_vecs))
        ff_ms["graph"].append(ms)
        ff_ok &= states_equal(got, want)
    ff_calls = calls_per(lambda: ff_eng.fast_forward(ff_vecs), 1)
    require(ff_ok and ff_calls is not None
            and ff_calls[0]["GraphLaunch"] == n_ff
            and ff_calls[0]["LaunchKernel"] == 0,
            f"fast_forward over {n_ff} vectors, 3 calls (the first warms "
            f"and captures): the state equals the eager device step once "
            f"per vector bit for bit ({ff_ok}); a warm call launches "
            f"{n_ff} step graphs and no kernel (torch.profiler): "
            f"{ff_calls and ff_calls[0]}")

    # a cold resume of N = 1,000 both ways, each on a fresh Engine made
    # before its clock starts: the Engine's (the step graph's warm-up,
    # capture and 998 replays), against the JAX Engine's _ff_scan form:
    # one graph of 256 steps from a static (256, 16) buffer, warmed by one
    # eager step, captured (its instantiation included) and replayed per
    # full chunk, the 232 left by the fresh Engine's step graph
    def chunk_form(rest_eng):
        live = _state_copy(sim.state_to(st_ff, dev), dev)
        actions = torch.zeros((ff_k, 16), dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        sim.animate_packed(live, geng._upload(ff_vecs[:1])[0])
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _write_state(live, step_states(live, actions, dev)[-1])
        torch.cuda.synchronize()
        capture = (time.perf_counter() - t0) * 1e3
        i = 0
        while n_ff - i >= ff_k:
            geng._upload(ff_vecs[i:i + ff_k], out=actions)
            graph.replay()
            i += ff_k
        rest_eng.set_state(live)
        return rest_eng.fast_forward(ff_vecs[i:]), capture, graph

    cold = {"step_graph": [], "chunk_graph": [], "chunk_capture": []}
    cold_ok = True
    for _ in range(2):
        fresh = Engine(cfg, DEVICE, share_assets_from=eng)
        fresh.set_state(st_ff)
        got, ms = host_timed(lambda: fresh.fast_forward(ff_vecs))
        cold["step_graph"].append(ms)
        cold_ok &= states_equal(got, want)
        fresh = Engine(cfg, DEVICE, share_assets_from=eng)
        (got, capture, chunk), ms = host_timed(lambda: chunk_form(fresh))
        cold["chunk_graph"].append(ms)
        cold["chunk_capture"].append(capture)
        cold_ok &= states_equal(got, want)
    del fresh
    require(cold_ok, "a cold fast_forward over 1,000 vectors, by the step "
            "graph and by 256-step chunk graphs, equals the eager device "
            "step bit for bit")
    ms_chunk = replay_ms(chunk, 1, 5)
    ms_step = replay_ms(ff_eng._graphs[("step", 1)].graph, 1, 20)
    st_d = sim.state_to(st_ff, dev)
    av_d = geng._upload(ff_vecs[:1])[0]
    one_step = calls_per(lambda: sim.animate_packed(st_d, av_d), 1,
                         need="LaunchKernel")
    require(one_step is not None, "a torch.profiler trace of one eager "
            "state step holds its kernel launches")
    step_nodes = one_step[0]["LaunchKernel"] + one_step[0]["Memcpy"]
    ff_report = {
        "n": n_ff, "eager_ms": ff_ms["eager"], "graph_ms": ff_ms["graph"],
        "eager_ms_per_frame": [m / n_ff for m in ff_ms["eager"]],
        "graph_ms_per_frame": [m / n_ff for m in ff_ms["graph"]],
        "cold_ms": cold, "chunk_replay_ms": ms_chunk,
        "step_replay_ms": ms_step, "nodes_per_step": step_nodes,
        "pool_mb": pool_mb([ff_eng._graphs[("step", 1)]])}
    print(f"fast_forward, {n_ff} vectors, host ms per call with its drain "
          f"in turns (eager device step once per vector; the Engine's, the "
          f"first call warming and capturing): eager {ff_ms['eager']}, "
          f"graph {ff_ms['graph']} = ms per skipped frame "
          f"{[round(m / n_ff, 4) for m in ff_ms['eager']]} against "
          f"{[round(m / n_ff, 4) for m in ff_ms['graph']]}; cold, on a "
          f"fresh Engine, in turns: by the step graph {cold['step_graph']}, "
          f"by 256-step chunk graphs {cold['chunk_graph']} (of which the "
          f"chunk's warm-up, capture and instantiation of about "
          f"{ff_k * step_nodes:.0f} nodes {cold['chunk_capture']}); by "
          f"replay: the chunk {ms_chunk:.4f} ms ({ms_chunk / ff_k:.4f} per "
          f"step), the step graph {ms_step:.4f} ms; one eager step's "
          f"launches {one_step[0]}; the step graph's pool (allocated, "
          f"reserved) MB {ff_report['pool_mb']} [{card}]", flush=True)
    del chunk

    # the eager step reads nothing back and copies from no pageable
    # memory, nor do the replays of every single-device graph
    vecs = geng._upload(pack_actions(random_actions(BATCH, 22),
                                     [1 / 60] * BATCH))
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = geng.state
        for kind in ("frame", "batch"):
            st, _ = geng._step_render(kind, st,
                                      vecs if kind == "batch" else vecs[:1])
        geng._frame_eager()
        geng.step(idle)
        geng.step_and_frame(idle)
        geng.frame()
        ff_eng.fast_forward(ff_vecs[:300])
        synced = None
    except RuntimeError as e:
        synced = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    require(synced is None, f"the eager device step and frame, and the "
            f"replays of step_and_frame, frame(), step() and fast_forward "
            f"(300 step replays) run under "
            f"torch.cuda.set_sync_debug_mode('error'): {synced}")

    # the numbers: device time of the step + packs and of the whole graph
    # (graph replay), host ms per call, the loop, the device-busy share
    st6 = make_state(6.0)
    geng.set_state(st6)
    av = geng._upload(idle.pack(1 / 60)[None])
    st6_d = geng.state
    step_packs = capture_graph(
        lambda: geng._packs(sim.animate_packed(st6_d, av[0])), 10)
    frame_graph = geng._graphs[("frame", 1)].graph
    frame_graph.replay()
    graph_ms = {"step_packs": [], "whole_graph": []}
    for _ in range(5):                     # in turns
        graph_ms["step_packs"].append(replay_ms(step_packs, 10))
        graph_ms["whole_graph"].append(replay_ms(frame_graph, 1, 20))
    # the SM clock beside the replays: device times move with it
    clocks = card_line("clocks.sm,clocks.max.sm,power.draw")
    del step_packs
    geng.set_state(st6)
    for _ in range(3):
        geng.step_and_frame()
    torch.cuda.synchronize()
    n_calls = 120
    t0 = time.perf_counter()
    for _ in range(n_calls):
        geng.step_and_frame()
    t_host = (time.perf_counter() - t0) * 1e3 / n_calls
    torch.cuda.synchronize()
    t_all = (time.perf_counter() - t0) * 1e3 / n_calls
    run_stats = []
    for _ in range(2):
        geng.set_state(st6)
        run_stats.append(geng.run(300))
    act = profiled(geng.step_and_frame, 30, ("raytrace_kernel",
                                             "fxaa_kernel"))
    require(act is not None, "a torch.profiler trace of 30 graph-path "
            "frames holds the kernels' device events")
    top, busy_g, window_g = act
    htod = sum(n for name, _, n in top if "HtoD" in name)
    require(htod <= 30, f"at most one host-to-device copy per frame: "
            f"{htod} in 30 graph-path frames ({[t for t in top if 'HtoD' in t[0]]})")
    scene_c = build_scene()
    av_c = av[0].cpu()
    cull_c = geng.cull.cpu()
    cpu_half = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(10):
            frame_packs(scene_c, sim.animate_packed(st6, av_c), H, W, None,
                        *clusters, cull_c)
        cpu_half.append((time.perf_counter() - t0) * 1e3 / 10)
    gmed = {k: statistics.median(v) for k, v in graph_ms.items()}
    pct = {}
    for i, s in enumerate(run_stats):
        ms = np.array(s.frame_ms)
        pct[i] = (s.fps, float(np.percentile(ms, 50)),
                  float(np.percentile(ms, 99)))
    print(f"graph path 1280x720 island day 6: device ms by graph replay, "
          f"median of 5: step + packs {gmed['step_packs']:.4f} "
          f"{graph_ms['step_packs']}, the whole frame graph "
          f"{gmed['whole_graph']:.4f} {graph_ms['whole_graph']}; SM clock, "
          f"its max, power draw after them: {clocks} [{card}]", flush=True)
    print(f"graph path: host ms per step_and_frame call {t_host:.4f} "
          f"(enqueue, {n_calls} calls), {t_all:.4f} with the device's drain; "
          f"Engine.run(300) " + "; ".join(
              f"{f:.2f} fps, frame ms p50 {p50:.4f} p99 {p99:.4f}"
              for f, p50, p99 in pct.values())
          + f" (CUDA events) [{card}]", flush=True)
    print(f"graph path profile of 30 frames: device busy {busy_g:.4f} ms of "
          f"{window_g:.4f} ms = {busy_g / max(window_g, 1e-9):.2%} "
          f"(torch.profiler); {htod} host-to-device copies; the CPU "
          f"Engine's host half (state step + frame_packs, host clock) "
          f"{statistics.median(cpu_half):.4f} ms {cpu_half} [{card}]",
          flush=True)
    for rank, (name, ms_tot, n) in enumerate(top[:8], 1):
        print(f"  top {rank}: {ms_tot:.4f} ms in {n} calls: {name[:100]}",
              flush=True)
    report["graph"] = {"stats": graph_stats, "device_ms": graph_ms,
                       "host_call_ms": t_host, "host_call_drained_ms": t_all,
                       "run": pct, "busy_ms": busy_g, "window_ms": window_g,
                       "htod": htod, "cpu_host_half_ms": cpu_half,
                       "clocks": clocks}

    # frame(): the render-only graph by replay, host ms per call and the
    # host's API calls per call; in turns with the frozen bench
    # configurations' own timers (bench_torch.time_frames, configuration
    # 4c at the worst pose, and ab_frames, configuration 3), which time
    # frame() calls and so now read the graph
    render_graph = geng._graphs[("render", 1)]
    worst_st = bench_torch.preset_state(day=17.6, yaw=315.0)
    turns = []
    for _ in range(3):
        geng.set_state(worst_st)
        geng.frame()
        replay = replay_ms(render_graph.graph, 1, 10)
        turns.append((replay, bench_torch.time_frames(
            geng, worst_st, n=10, warmup=1).events))
    over = statistics.median(b / r - 1 for r, b in turns)
    on, off = bench_torch.ab_frames(
        geng, bench_torch.preset_state(cam_preset=0, aa=True),
        bench_torch.preset_state(cam_preset=0, aa=False), n=10, reps=15)
    geng.set_state(st6)
    geng.frame()
    day6 = replay_ms(render_graph.graph, 1, 20)
    frame_calls = calls_per(geng.frame, 10)
    require(frame_calls is not None and frame_calls[0]["GraphLaunch"] == 1
            and frame_calls[0]["LaunchKernel"] == 0,
            f"a frame() call launches one CUDA graph and no kernel "
            f"(torch.profiler, 10 calls): {frame_calls and frame_calls[0]}")
    frame_host = statistics.median(from_idle(geng.frame, 8)
                                   for _ in range(5))
    render_pool = pool_mb([render_graph])
    print(f"frame() graph 1280x720 island: device ms by replay at day 6 "
          f"{day6:.4f}; at the worst pose, in turns with bench_torch's "
          f"configuration 4c timer (replay, time_frames by CUDA events) "
          f"{turns}, the timer {over:+.2%} of the replay (median); "
          f"configuration 3's A/B in the same Engine: FXAA on "
          f"{on.events:.4f}, off {off.events:.4f}, cost "
          f"{on.events - off.events:+.4f} ms (CUDA events); host ms per "
          f"call (8 from an idle device, median of 5) {frame_host:.4f}; "
          f"per call {frame_calls[0]}; pool (allocated, reserved) MB "
          f"{render_pool} [{card}]", flush=True)
    require(abs(over) <= 0.10,
            f"bench_torch's worst-pose timer reads the frame() graph: "
            f"within 10 % of its replay in the same turns ({over:+.2%})")
    # kernel B runs in the graph whatever the toggle, so the two arms do
    # the same work: the difference of their medians over 15 interleaved
    # blocks each
    cost = on.events - off.events
    require(-0.05 <= cost <= 0.1,
            f"bench_torch's FXAA A/B (configuration 3's timer, 15 blocks "
            f"an arm) reads the graph, where kernel B always runs: a cost "
            f"of {cost:+.4f} ms, within [-0.05, +0.1]")
    report["graph"].update(
        frame={"day6_ms": day6, "worst_turns": turns, "timer_over": over,
               "fxaa_on_ms": on.events, "fxaa_off_ms": off.events,
               "host_from_idle_ms": frame_host, "per_call": frame_calls[0],
               "pool_mb": render_pool},
        step={"per_call": step_calls[0]}, fast_forward=ff_report)

    # --- 14. report ---
    phase(14)
    kernels = [
        {"name": "sky_quantize", "route": "cuda",
         "source": "raytracing_cuda_tpu_torch/csrc/sky.cu",
         "replaces": None, "launches": launches["sky"],
         "max_abs_err": 0.0, "ms": ms_sky, "plain_ms": ms_sky_plain,
         "bound_ms": bound_sky[0], "bound_by": bound_sky[1],
         "library_ms": None},
        {"name": "sky_quantize_k8", "route": "cuda",
         "source": "raytracing_cuda_tpu_torch/csrc/sky.cu",
         "replaces": None, "launches": batch_counts["sky"],
         "max_abs_err": 0.0, "ms": ms_sky8, "plain_ms": ms_sky8_plain,
         "bound_ms": bound_sky8[0], "bound_by": bound_sky8[1],
         "library_ms": None},
        {"name": "packs", "route": "cuda",
         "source": "raytracing_cuda_tpu_torch/csrc/packs.cu",
         "replaces": None, "launches": launches["packs"],
         "max_abs_err": 0.0, "ms": ms_packs, "plain_ms": ms_packs_torch,
         "bound_ms": bound_packs[0], "bound_by": bound_packs[1],
         "library_ms": None},
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
         "bound_by": bound_b[1], "library_ms": None,
         "launches_by_path": {"auto": launches["fxaa"],
                              "fast": plain_counts["fast"]["fxaa"],
                              "oracle": plain_counts["oracle"]["fxaa"]}},
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
         "library_ms": None,
         "launches_by_path": {"auto_sharded": band_counts["fxaa_band"],
                              "fast_sharded": fast_band_counts["fxaa_band"]}},
        {"name": "raytrace_megakernel_arms", "route": "cuda",
         "source": "raytracing_cuda_tpu_torch/csrc/raytrace_arms.cu",
         "replaces": "raytracing_cuda_tpu/render/pallas_rt.py:1151",
         "launches": arm_launches, "max_abs_err": arm_err,
         "ms": abl["arms"]["noshadow"]["median_ms"],
         "plain_ms": arm_plain_ms["noshadow"], "bound_ms": bound_arm[0],
         "bound_by": bound_arm[1], "library_ms": None, "arm": "noshadow",
         "pose": "worst_pose"},
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
