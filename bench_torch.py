#!/usr/bin/env python
"""Benchmark script of the PyTorch/CUDA port (port of bench.py).

Prints ONE JSON line on stdout with the headline metric: sustained frames
per second of the animated 1280x720 real-time loop (configuration 5;
`vs_baseline` is fps / 60, the source's real-time claim), the crossfade
loop's fps, and a parity gate: the four golden states rendered through the
Engine against the oracle goldens in tests/golden/tpu/ at the same size,
under the golden contract (RMSE < 2e-3 and < 0.3 % of pixels off by more
than 2 levels, tests/test_golden.py:82-86). Per-configuration details go to
stderr as JSON.

Every reading is taken twice: by the host clock around n frames enqueued
and one end sync, as bench.py reads it, and by CUDA events recorded on the
stream around the same frames (`*_events` keys; absent on the CPU). On a
card every call timed here is a CUDA graph replay once warm: the loop's
`step_and_frame` and `step_and_frame_batch`, and the `frame()` calls that
the frozen configurations (1, 2, 3, 4 and 4c) time, which render the
state set without stepping it. The host enqueues a replay in far less
time than the device runs it, so the CUDA events read the device's time
per frame; the card moves between two speeds within a run, so the A/B
configurations interleave their arms and report medians.

Runs on the first CUDA card unless `--device cpu` is given, and raises
where the card asked for is not there: nothing falls back. The kernels
build from raytracing_cuda_tpu_torch/csrc/ at first use.

Usage:
  python bench_torch.py                       # 1280x720, 200 frames
  python bench_torch.py --quick               # 480x272, 30 frames, no gate
  python bench_torch.py --size 1920x1080 --frames 120 --batch 8
  python bench_torch.py --device cpu --quick  # plain kernel versions

Goldens exist for 1280x720 and 1920x1080. At another size the gate cannot
run (the goldens are the JAX oracle's frames): the script says so and exits
2 unless --skip-parity or --quick is given. Exit code 1: the gate failed.

`--sky reference` (with `--sky-downsample k`) runs on the reference
panoramas under assets/backgrounds/; the goldens are procedural-sky
frames, so it needs --skip-parity (or --quick), like a size without
goldens.

Not ported from bench.py, as they exist only for the TPU: the lock file
and backend probes, --tune and --tune-sky with autotune.json, the batch=16
arm with the dispatch-quantum estimate, and the reference-sky golden suite
(its goldens need the reference panoramas, which are not shipped).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_ROOT = os.path.join(ROOT, "tests", "golden", "tpu")
GOLDEN_SIZE = (1280, 720)    # the size of the goldens in GOLDEN_ROOT itself
# golden contract (tests/test_golden.py:82-86)
GOLDEN_RMSE = 2e-3
GOLDEN_OFF_FRAC = 0.003
# golden states of tests/test_golden.py:39-44
CASES = {
    "island_morning": dict(day=6.0),
    "mountains_day": dict(day=14.0, cp=1),
    "island_night": dict(day=1.0),
    "evening_flood_noaa": dict(day=18.0, sea=2.0, aa=False),
}

# One reading by both clocks, ms per frame; events is None on the CPU.
Reading = collections.namedtuple("Reading", "host events")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def camera_path(i):
    """Configuration 5's deterministic camera script (smooth pan + slow
    forward drift). Module-level so the soak and other harnesses drive
    exactly this workload by importing it."""
    from raytracing_cuda_tpu_torch.sim.actions import Action

    return Action.idle()._replace(
        mouse_dx=np.float32(2.0 * np.sin(i * 0.02)),
        move_forward=np.int32(1 if (i // 60) % 2 == 0 else 0),
    )


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def preset_state(day=None, cam_preset=None, sea=None, aa=True, yaw=None):
    """A frozen state of the benchmark: clock, camera preset, sea level,
    FXAA toggle and yaw over the initial state, clock stopped, settled."""
    from raytracing_cuda_tpu_torch.sim import state as sim
    from raytracing_cuda_tpu_torch.sim.actions import Action

    st = sim.init_state()
    if day is not None:
        st = st._replace(day_time=_f32(day))
    if sea is not None:
        st = st._replace(sea_y=_f32(sea))
    if cam_preset is not None:
        st = sim.apply_controls(
            st, Action.idle()._replace(cam_preset=np.int32(cam_preset)), 0.0)
    if yaw is not None:
        st = st._replace(cam=st.cam._replace(hor_angle=_f32(yaw)))
    st = st._replace(aa=torch.tensor(bool(aa)), play=torch.tensor(False))
    return sim.settle(st)


def golden_state(day, cp=None, sea=None, aa=True):
    """The state a golden was rendered from (tests/test_golden.py
    make_state): the gate must reproduce those states, not re-derive
    them."""
    from raytracing_cuda_tpu_torch.sim import state as sim
    from raytracing_cuda_tpu_torch.sim.actions import Action

    st = sim.init_state()._replace(day_time=_f32(day))
    if cp is not None:
        st = sim.apply_controls(
            st, Action.idle()._replace(cam_preset=np.int32(cp)), 0.0)
    if sea is not None:
        st = st._replace(sea_y=_f32(sea))
    return sim.settle(st._replace(aa=torch.tensor(bool(aa))))


def time_frames(eng, state, n=10, warmup=3) -> Reading:
    """Pipelined ms per frame: n frames enqueued, one end sync."""
    from raytracing_cuda_tpu_torch.utils.timing import device_sync

    eng.set_state(state)
    for _ in range(warmup):
        eng.frame()
        device_sync(eng.device)
    cuda = eng.device.type == "cuda"
    if cuda:
        stream = torch.cuda.current_stream(eng.device)
        first = torch.cuda.Event(enable_timing=True)
        last = torch.cuda.Event(enable_timing=True)
        first.record(stream)
    t0 = time.perf_counter()
    for _ in range(n):
        eng.frame()
    if cuda:
        last.record(stream)
    device_sync(eng.device)
    host = (time.perf_counter() - t0) * 1e3 / n
    return Reading(host, first.elapsed_time(last) / n if cuda else None)


def _median(readings) -> Reading:
    """The per-clock median of some readings."""
    events = [r.events for r in readings]
    return Reading(statistics.median(r.host for r in readings),
                   None if None in events else statistics.median(events))


def ab_frames(eng, state_a, state_b, n=10, reps=5):
    """Interleaved A/B of eng.frame() under two states → (Reading a,
    Reading b): alternating timed blocks, medians across reps, so that a
    drift of the host's speed falls on both arms alike."""
    time_frames(eng, state_a, n=2, warmup=2)   # warm both branches
    time_frames(eng, state_b, n=2, warmup=2)
    a, b = [], []
    for _ in range(reps):
        a.append(time_frames(eng, state_a, n=n, warmup=0))
        b.append(time_frames(eng, state_b, n=n, warmup=0))
    return _median(a), _median(b)


def _put(details, key, readings):
    """details[key] = the host-clock value(s), details[key + '_events'] =
    the CUDA events' (on a card); a Reading or a list of them."""
    many = isinstance(readings, list)
    rs = readings if many else [readings]
    for name, vals in ((key, [r.host for r in rs]),
                       (key + "_events", [r.events for r in rs])):
        if None not in vals:
            vals = [round(v, 2) for v in vals]
            details[name] = vals if many else vals[0]


def golden_dir(w: int, h: int, root: str = GOLDEN_ROOT):
    """The directory of the (w, h) goldens, or None where one of the four
    is missing (tests/gen_tpu_golden.py golden_dir's layout)."""
    d = root if (w, h) == GOLDEN_SIZE else os.path.join(root, f"{w}x{h}")
    have = all(os.path.exists(os.path.join(d, f"{name}.png"))
               for name in CASES)
    return d if have else None


def parity_check(eng, details, golden_d):
    """Render the golden states through the Engine `eng` and gate each
    frame against the oracle golden of its size in golden_d under the
    golden contract → (ok, {name: rmse}). Procedural sky suite only."""
    from raytracing_cuda_tpu_torch.utils.images import load_png

    rmses, offs = {}, {}
    for name, kw in CASES.items():
        golden = load_png(os.path.join(golden_d, f"{name}.png"))
        eng.set_state(golden_state(**kw))
        d = np.abs(eng.frame_np().astype(np.float64)
                   - golden.astype(np.float64))
        rmse = float(np.sqrt(np.mean((d / 255.0) ** 2)))
        off = float(np.mean(np.any(d > 2.0, axis=-1)))
        rmses[name], offs[name] = round(rmse, 5), round(off, 6)
        ok = rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC
        log(f"parity {name}: rmse={rmse:.5f} off>2={off:.4%} "
            f"{'OK' if ok else '*** FAIL ***'}")
    details["parity_rmse"] = rmses
    details["parity_off_frac"] = offs
    ok = (all(v < GOLDEN_RMSE for v in rmses.values())
          and all(v < GOLDEN_OFF_FRAC for v in offs.values()))
    if not ok:
        log("*" * 64)
        log("*** PARITY FAILURE: a frame misses the golden contract ***")
        log("*" * 64)
    return ok, rmses


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small smoke run: 480x272, 30 frames, 256x512 sky, "
                         "no parity gate")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames of the sustained loop (default 200)")
    ap.add_argument("--size", default=None, help="WxH, e.g. 1280x720")
    ap.add_argument("--skip-configs", action="store_true",
                    help="only run the headline sustained loop")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--no-sky-cache", action="store_true",
                    help="blend and pack the sky per frame (the one-shot "
                         "render_frame) instead of the static stack")
    ap.add_argument("--batch", type=int, default=1,
                    help="frames per launch of the sustained loop (record "
                         "uses 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), cuda:N or cpu; no fallback "
                         "from a card to the CPU")
    ap.add_argument("--sky", default="procedural",
                    choices=["auto", "reference", "procedural"],
                    help="sky panoramas: procedural (the goldens' sky), "
                         "reference (assets/backgrounds/) or auto "
                         "(reference where that directory exists)")
    ap.add_argument("--sky-downsample", type=int, default=1,
                    help="point-sample every k-th reference sky texel")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.batch < 1:
        ap.error(f"--batch must be >= 1, got {args.batch}")
    if args.sky_downsample < 1:
        ap.error(f"--sky-downsample must be >= 1, got {args.sky_downsample}")
    device = args.device

    from raytracing_cuda_tpu_torch.app.loop import Engine
    from raytracing_cuda_tpu_torch.sim import state as sim
    from raytracing_cuda_tpu_torch.utils.config import RenderConfig

    if args.size:
        try:
            w, h = (int(v) for v in args.size.lower().split("x"))
        except ValueError:
            ap.error(f"--size must be WxH (e.g. 1280x720), got {args.size!r}")
    elif args.quick:
        w, h = 480, 272
    else:
        w, h = 1280, 720
    frames = args.frames or (30 if args.quick else 200)
    sky_shape = (256, 512) if args.quick else (2048, 4096)

    gate = not args.skip_parity and not args.quick
    from raytracing_cuda_tpu_torch.scene.textures import REFERENCE_BACKGROUNDS

    sky = args.sky
    if sky == "auto":
        sky = ("reference" if os.path.exists(REFERENCE_BACKGROUNDS)
               else "procedural")
    if gate and sky != "procedural":
        log(f"--sky {args.sky} renders the reference panoramas; the goldens "
            f"under {GOLDEN_ROOT} are procedural-sky frames, so the parity "
            f"gate cannot run. Pass --skip-parity to bench without it.")
        return 2
    golden_d = golden_dir(w, h) if gate else None
    if gate and golden_d is None:
        log(f"no goldens for {w}x{h} under {GOLDEN_ROOT}: they are the JAX "
            f"oracle's frames (tests/gen_tpu_golden.py) and exist for "
            f"1280x720 and 1920x1080. The parity gate cannot run at this "
            f"size; pass --skip-parity to bench without it.")
        return 2

    cfg = RenderConfig(width=w, height=h, procedural_sky_shape=sky_shape,
                       sky_cache=not args.no_sky_cache, sky_source=sky,
                       sky_downsample=args.sky_downsample)
    eng = Engine(cfg, device)          # raises where the card is not there
    cuda = eng.device.type == "cuda"
    name = torch.cuda.get_device_name(eng.device) if cuda else "cpu"
    log(f"device={eng.device} ({name}) torch={torch.__version__} "
        f"size={w}x{h} frames={frames} batch={args.batch} sky={sky}")
    details = {"device": str(eng.device), "device_name": name}

    def fresh(day=None):
        st = sim.init_state()
        if day is not None:
            st = st._replace(day_time=_f32(day))
        return sim.settle(st)

    if not args.skip_configs:
        # 1. Mountains, fixed camera, 640x480, no FXAA: pipelined per-frame
        # render time, on an Engine that shares the scene and the sky stack
        eng_small = eng.resized(640, 480)
        _put(details, "mountains_640x480_noaa_ms", time_frames(
            eng_small, preset_state(day=14.0, cam_preset=1, aa=False),
            n=10, warmup=3))
        del eng_small

        # 2. Frozen island sea-level sweep, interleaved reps with a median
        # per level. Levels need not be flat: the culls make the exposed
        # island costlier than the flooded one.
        levels = (-4.5, -2.0, 0.0, 2.0)
        states = [preset_state(cam_preset=0, sea=s) for s in levels]
        for st in states:                       # warm every level once
            time_frames(eng, st, n=2, warmup=2)
        sweep = [[] for _ in levels]
        for _ in range(3):
            for i, st in enumerate(states):
                sweep[i].append(time_frames(eng, st, n=10, warmup=0))
        _put(details, "island_sea_sweep_ms", [_median(v) for v in sweep])

        # 3. FXAA on/off at full size, interleaved A/B
        on, off = ab_frames(eng, preset_state(cam_preset=0, aa=True),
                            preset_state(cam_preset=0, aa=False),
                            n=10, reps=5)
        _put(details, "fxaa_on_ms", on)
        _put(details, "fxaa_off_ms", off)
        _put(details, "fxaa_cost_ms", Reading(
            on.host - off.host,
            None if on.events is None else on.events - off.events))

        # 4. Time-of-day sweep (morning/day/evening/night presets)
        _put(details, "time_of_day_ms", [
            time_frames(eng, preset_state(day=d, cam_preset=1), n=10)
            for d in (6.0, 14.0, 18.0, 1.0)])

        # 4b. Crossfade sustained window: the playing clock crosses the
        # 8-10 h morning-to-day fade, so every frame blends two panoramas
        # (the pair lookup's two-fetch branch)
        eng.set_state(fresh(8.05))
        fade = eng.run(min(frames, 200), action_fn=camera_path, dt=1 / 60)
        details["crossfade_sustained_fps"] = round(fade.host_fps, 2)
        if cuda:
            details["crossfade_sustained_fps_events"] = round(fade.fps, 2)

        # 4c. The reference's pinned worst case: day 17.6, yaw 315, where
        # the most geometry and sea reflections fill the frame and
        # near-horizontal shadow rays sweep the mountain ring
        # (experiments/worst_state_probe_torch.py searches for the card's)
        worst = time_frames(eng, preset_state(day=17.6, yaw=315.0), n=10,
                            warmup=3)
        _put(details, "low_sun_worst_ms", worst)
        _put(details, "low_sun_worst_fps", Reading(
            1e3 / worst.host,
            None if worst.events is None else 1e3 / worst.events))

    # 5. Sustained real-time loop: animated camera + automatic time (headline)
    eng.set_state(fresh())
    stats = eng.run(frames, action_fn=camera_path, dt=1 / 60,
                    batch=args.batch)
    details["sustained"] = stats.as_dict()

    # 6. parity gate against the oracle goldens at the invoked size
    parity_ok, rmses = True, {}
    if gate:
        parity_ok, rmses = parity_check(eng, details, golden_d)

    log(json.dumps(details, indent=2))

    # value: by the host clock, end sync included, as bench.py reads it;
    # value_events: by the Engine's frame timer's CUDA events, on a card
    out = {
        "metric": f"sustained_fps_{w}x{h}_animated",
        "value": round(stats.host_fps, 2),
        "unit": "fps",
        "vs_baseline": round(stats.host_fps / 60.0, 3),
    }
    if cuda:
        out["value_events"] = round(stats.fps, 2)
    if "crossfade_sustained_fps" in details:
        out["crossfade_fps"] = details["crossfade_sustained_fps"]
    if rmses:
        out["parity_rmse_max"] = max(rmses.values())
        out["parity_ok"] = parity_ok
    print(json.dumps(out), flush=True)
    return 0 if parity_ok else 1


if __name__ == "__main__":
    sys.exit(main())
