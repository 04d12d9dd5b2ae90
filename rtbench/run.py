"""Run one cell of the benchmark of the PyTorch / CUDA port.

    python3 rtbench/run.py --workload island_720p.fly --seed 7 \
        --seconds 10 --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for. The cell (BENCHMARK.json `workloads`) names a configuration (a
`RenderConfig` and the scene's sizes, rtbench/configs/) and a traffic mix
(rtbench/traffic/, read by rtbench/generator.py). Set-up builds the Engine
on the card, warms its one shape and resets the start; the window then
flies the seeded user through `Engine.step_and_frame` and
`app.window.Readback` (one frame behind, as the viewer reads frames back)
for --seconds, in a closed loop. Once the window has closed the frames it
handed back (a seeded sample, and the last) and the final state are held
against the plain reference (rtbench/correct.py). That is the `fly`
driver; a traffic file that names `"driver": "record"` is played by the
offline record job's instead (rtbench/record.py: K-frame batches, frame
DP over the cell's cards, each batch to host memory).

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics, read (rtbench/metrics/) from a torch.profiler slice of the window.
The last line of standard output is one JSON object; the lines before it
on standard error name the card, its clocks, the launch counters per frame
and the memory held, and last every number compared beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rtbench import correct, generator, spec  # noqa: E402
from rtbench import trace as tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracing_cuda_tpu")
PROFILE_FRAMES = 60         # frames in a traced slice
PROFILE_TRIES = 4
KERNELS = ("raytrace_kernel", "fxaa_kernel")
EVENT_FRAMES = 3000         # frames timed by CUDA events in a traced run
EVENT_SKIP = 10             # the window's first frames, not timed
EXTEND_FRAMES = 1000        # actions drawn at a time, should a window outrun


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class CardQuery:
    """nvidia-smi's reading of every card (name, power limit, SM clock and
    its max, power draw, temperature), started when made and read by
    `lines()`: the set-up goes on while it runs."""

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                 "clocks.max.sm,power.draw,temperature.gpu",
                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            self.error = None
        except OSError as e:
            self.proc, self.error = None, e

    def lines(self) -> list:
        if self.proc is None:
            return [f"nvidia-smi: {self.error}"]
        try:
            out, err = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            return ["nvidia-smi: no answer in 30 s"]
        return out.strip().splitlines() or [err.strip()]


class FrameEvents:
    """CUDA events recorded on the card's stream around frames EVENT_SKIP
    to EVENT_SKIP + n - 1 of a traced run's window, before its traced
    slice (a trace slows every later graph launch): each frame's start,
    before its action is read, and its end, behind its readback copy.
    `reading()` → the frames timed, the device's milliseconds from the
    first start to the last end, and the milliseconds of it in which the
    card had nothing enqueued (from a frame's end to the next one's
    start)."""

    def __init__(self, n: int):
        self.pairs = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(n)]
        self.used = 0

    def at(self, i: int):
        """The pair of frame i, where it is one of the timed frames."""
        j = i - EVENT_SKIP
        if 0 <= j < len(self.pairs) and j == self.used:
            self.used += 1
            return self.pairs[j]
        return None

    def reading(self):
        if self.used < 2:
            return None
        torch.cuda.synchronize()
        pairs = self.pairs[:self.used]
        idle = sum(a[1].elapsed_time(b[0]) for a, b in zip(pairs, pairs[1:]))
        return {"frames": self.used, "idle_ms": idle,
                "span_ms": pairs[0][0].elapsed_time(pairs[-1][1])}


class Reservoir:
    """A seeded uniform sample of k of the frames handed back, whatever
    their number: frame j replaces a kept one with probability k / (j+1)."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.kept = k, rng, {}

    def offer(self, j: int, frame) -> None:
        if j < self.k:
            self.kept[j] = frame.numpy().copy()
            return
        slot = int(self.rng.integers(j + 1))
        if slot < self.k:
            del self.kept[sorted(self.kept)[slot]]
            self.kept[j] = frame.numpy().copy()


def window(eng, vecs, flight, seconds: float, sample, traced, events=None):
    """The closed loop for `seconds`: frame i reads its action (an Action
    from its packed vector, as the viewer builds one from its input each
    frame; more are drawn from `flight` should the window outrun `vecs`),
    calls step_and_frame, and submits the frame to the readback ring, which hands
    back frame i - 1. → records: the host times of each frame's action,
    the end of its call and its delivery, the frames kept by `sample`, the
    last frame, and the profiler of a traced slice (traced: a slice of
    PROFILE_FRAMES frames from the window's middle, traced again after the
    window, up to PROFILE_TRIES slices, while a slice holds no kernel).
    events: a FrameEvents, whose frames are timed while no slice has
    begun."""
    from raytracing_cuda_tpu_torch.app.window import Readback
    from raytracing_cuda_tpu_torch.sim.actions import Action

    dt = float(flight.dt)
    readback = Readback()
    t_act, t_call, t_done = [], [], []
    slices, prof, slice_end = [], None, None
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        i = 0
        while True:
            if prof is None:
                elapsed = time.perf_counter() - t0
                if elapsed >= seconds and (not traced or slices_done(slices)):
                    break
                if traced and (elapsed >= seconds or (
                        not slices and elapsed >= seconds / 2)):
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    prof.__enter__()
                    slice_end = i + PROFILE_FRAMES
            if i == len(vecs):
                vecs = np.concatenate([vecs, flight.take(EXTEND_FRAMES)])
            pair = (events.at(i) if events is not None and prof is None
                    and not slices else None)
            if pair is not None:
                pair[0].record()
            span = spanned(tracing.FRAME_SPAN, prof)
            span.__enter__()
            t = time.perf_counter()
            action = Action.unpack(vecs[i])
            t_c = time.perf_counter()
            with spanned("rtbench.call", prof):
                out = eng.step_and_frame(action, dt)
            t_call.append(time.perf_counter() - t_c)
            t_act.append(t)
            with spanned("rtbench.readback", prof):
                shown = readback.submit(out)
            if pair is not None:
                pair[1].record()
            if shown is not None:
                t_done.append(time.perf_counter())
                with spanned("rtbench.sample", prof):
                    sample.offer(i - 1, shown)
            span.__exit__(None, None, None)
            i += 1
            if prof is not None and i == slice_end:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                slices.append(Slice(prof, i - PROFILE_FRAMES))
                prof = None
        shown = readback.flush()
        t_done.append(time.perf_counter())
        last = shown.numpy().copy()
    finally:
        gc.enable()
    return {"t0": t0, "t_act": t_act, "t_call": t_call, "t_done": t_done,
            "frames": i, "kept": dict(sample.kept), "last": last,
            "vecs": vecs[:i], "slices": slices}


def spanned(name: str, prof):
    """A host span of the trace while a slice is traced, else nothing."""
    return (torch.profiler.record_function(name) if prof is not None
            else contextlib.nullcontext())


class Slice:
    """A traced slice: its profiler, the frame it starts at, and its parsed
    trace once read."""

    def __init__(self, prof, first: int):
        self.prof, self.first, self.trace = prof, first, None

    def read(self) -> tracing.Trace:
        if self.trace is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                self.trace = tracing.parse(path)
            finally:
                os.remove(path)
            self.prof = None
        return self.trace


def slices_done(slices) -> bool:
    """Whether a traced slice holds both kernels (reading each the first
    time it is asked), or PROFILE_TRIES slices were taken."""
    return (len(slices) >= PROFILE_TRIES
            or any(s.read().has_kernels(KERNELS) for s in slices))


def build_engine(render: dict, device):
    """The Engine of the configuration's `render` settings on `device`,
    warmed at its one shape: the first call eager (it loads the kernels),
    the second captured, then replays; the readback ring too."""
    from raytracing_cuda_tpu_torch.app.loop import Engine
    from raytracing_cuda_tpu_torch.app.window import Readback
    from raytracing_cuda_tpu_torch.sim.actions import Action
    from raytracing_cuda_tpu_torch.utils.config import RenderConfig

    t0 = time.perf_counter()
    eng = Engine(RenderConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in render.items()}), device)
    t1 = time.perf_counter()
    ring = Readback()
    for _ in range(4):
        ring.submit(eng.step_and_frame(Action.idle(), 1 / 60))
    ring.flush()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    log(f"set-up: before the Engine (imports, CUDA, the actions) "
        f"{t0 - T_START:.3f} s, the Engine (scene, sky, "
        f"cull table, upload) {t1 - t0:.3f} s, the first calls (kernels "
        f"loaded or built, the capture) {time.perf_counter() - t1:.3f} s")
    return eng


def program_start(start, antialiasing: bool):
    """The program's state at a run's start (generator.Start): the initial
    globals at the hour with the configuration's FXAA toggle, then the
    camera preset pressed with dt 0, settled."""
    from raytracing_cuda_tpu_torch.sim import state as sim
    from raytracing_cuda_tpu_torch.sim.actions import Action

    st = sim.init_state()._replace(
        day_time=torch.tensor(np.float32(start.hour)),
        aa=torch.tensor(bool(antialiasing)))
    return sim.settle(sim.apply_controls(st, Action.idle()._replace(
        cam_preset=np.int32(start.cam_preset)), 0.0))


def launch_counts() -> dict:
    from raytracing_cuda_tpu_torch.app.loop import _launch_counters

    return {f"{fn.__name__}.{attr}": getattr(fn, attr)
            for fn, attr in _launch_counters()}


DRIVERS = ("fly", "record")


class Cell:
    """A cell as BENCHMARK.json names it: its entry, configuration (render
    settings, with render_over's fields replaced: the CPU tests' small
    sizes), traffic parameters, the driver that plays them (DRIVERS) and
    the limits of `correct`."""

    def __init__(self, workload: str, root: Path = spec.ROOT,
                 render_over=None):
        self.bench = spec.load_benchmark(root)
        self.entry = spec.cell(self.bench, workload)
        self.name = workload
        self.conf = spec.config(self.bench, self.entry["config"], root)
        self.render = {**self.conf["render"], **(render_over or {})}
        self.params = generator.load_traffic(self.entry["traffic"])
        self.driver = generator.driver_of(self.params)
        if self.driver not in DRIVERS:
            raise ValueError(f"traffic {self.entry['traffic']!r} names the "
                             f"driver {self.driver!r}; there are {DRIVERS}")
        self.limits = spec.limits(workload)


def fly(cell: Cell, eng, seed: int, seconds: float, traced: bool,
        setup_t0: float, card=None):
    """One window of the seeded flight on the warmed Engine `eng`, from the
    seed's start → (the result line's object without `correct`, the window's
    records). setup_t0: the host time set-up began; card: the CardQuery
    started with the run, if any."""
    flight = generator.Flight(cell.params, seed)
    on_card = eng.device.type == "cuda"
    events = FrameEvents(EVENT_FRAMES) if traced and on_card else None
    vecs = flight.take(int(cell.params["actions_per_s"] * seconds) + 1)
    eng.set_state(program_start(flight.start, cell.render["antialiasing"]))
    if on_card:
        torch.cuda.synchronize(eng.device)
        torch.cuda.reset_peak_memory_stats(eng.device)
    counts0 = launch_counts()
    sample = Reservoir(int(cell.params["check_frames"]),
                       np.random.default_rng([seed, 1]))
    setup_s = time.perf_counter() - setup_t0
    rec = window(eng, vecs, flight, seconds, sample, traced, events)
    n = rec["frames"]
    rec["start"] = flight.start
    rec["state"] = correct.state_numbers(eng.state)
    counts = {k: (v - counts0[k]) / n for k, v in launch_counts().items()}
    peak = torch.cuda.max_memory_reserved(eng.device) if on_card else 0
    log(f"launches per frame: {json.dumps(counts)}")
    log(f"memory: max_memory_reserved {peak} bytes")
    if card is not None:
        for line in card.lines():
            log(f"card before the window: {line}")
    if on_card:
        for line in CardQuery().lines():
            log(f"card after the window: {line}")

    lat = [(d - a) * 1e3 for a, d in zip(rec["t_act"], rec["t_done"])]
    span = rec["t_done"][-1] - rec["t0"]
    p99 = (statistics.quantiles(lat, n=100, method="inclusive")[98]
           if len(lat) > 1 else lat[0])
    e2e = {"fps": n / span, "frame_latency_ms_p99": p99, "setup_s": setup_s}
    log(f"window: {n} frames in {span:.6f} s; frame latency ms p50 "
        f"{statistics.median(lat):.6f} p99 {e2e['frame_latency_ms_p99']:.6f}"
        f" max {max(lat):.6f}; host ms per call p50 "
        f"{statistics.median(rec['t_call']) * 1e3:.6f}; setup_s {setup_s}")

    result = {"correct": False, "attempted": n, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(eng.device)
                                  if on_card else "cpu"),
                         "count": int(cell.entry["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if traced:
        first = rec["slices"][0].first if rec["slices"] else n
        run = {"width": cell.render["width"], "height": cell.render["height"],
               "objects": cell.conf["objects"],
               "host_call_ms": [t * 1e3 for t in rec["t_call"][:first]],
               "device_frames": events.reading() if events else None}
        log(f"frames timed by CUDA events: {run['device_frames']}")
        good = [s.read() for s in rec["slices"]
                if s.read().has_kernels(KERNELS)]
        tr = good[0] if good else tracing.Trace([], [], 0)
        for m in spec.metrics_of(cell.bench, "per_layer", cell.name):
            v = spec.reader(m["name"])(tr, run)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if good:
            result["device"]["busy_s"] = tr.busy_us() / 1e6
            result["device"]["window_s"] = tr.window_us() / 1e6
            result["breakdown"] = {"device_ops": tr.top_device_ops(),
                                   "idle_gaps": tr.longest_gaps()}
        log(f"traced slices: {len(rec['slices'])}, with both kernels "
            f"{len(good)}")
    else:
        for m in spec.metrics_of(cell.bench, "end_to_end", cell.name):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    return result, rec


def build(cell: Cell, device, mesh=None, setup_t0=None):
    """The cell's system under test, warmed: the fly driver's Engine, or
    the record driver's Recorder (mesh: record.build's override; setup_t0:
    the host time set-up began)."""
    if cell.driver == "record":
        from rtbench import record
        return record.build(cell, device, mesh, setup_t0)
    return build_engine(cell.render, device)


def drive(cell: Cell, sut, seed: int, seconds: float, traced: bool,
          setup_t0: float, card=None):
    """One window of the cell's driver on `sut` (build) → (the result line's
    object without `correct`, the window's records)."""
    if cell.driver == "record":
        from rtbench import record
        return record.drive(cell, sut, seed, seconds, traced, setup_t0, card)
    return fly(cell, sut, seed, seconds, traced, setup_t0, card)


def handed_back(rec) -> dict:
    """The frames of a window that are checked: the seeded sample and the
    last, {index: (H, W, 3) uint8}."""
    return {**rec["kept"], rec["frames"] - 1: rec["last"]}


def check(cell: Cell, rec, device):
    """The window's frames handed back and final state against the plain
    reference → (correct, {name: {"value", "limit"}})."""
    t = time.perf_counter()
    frames = handed_back(rec)
    want_state, want_frames = correct.reference_outputs(
        cell.render, rec["start"], rec["vecs"], set(frames), device)
    readings = correct.compare(rec["state"], frames, want_state, want_frames)
    ok, checks = correct.judge(readings, cell.limits)
    log(f"reference check: frames {sorted(frames)} and the state after "
        f"{rec['frames']} frames, {time.perf_counter() - t:.3f} s")
    return ok, checks


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", root: Path = spec.ROOT, render_over=None,
             mesh=None):
    """One run of cell `workload`, set-up to the check → the result line's
    object. device "cpu", render_over and mesh (a record cell's cards,
    which may repeat) serve the CPU tests at small sizes and a rehearsal
    on fewer cards; the benchmark runs on "cuda" and passes neither."""
    cell = Cell(workload, root, render_over)
    card = CardQuery() if torch.device(device).type == "cuda" else None
    sut = build(cell, device, mesh, T_START)
    result, rec = drive(cell, sut, seed, seconds, traced, T_START, card)
    del sut
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ok, checks = check(cell, rec, device)
    result["correct"] = ok
    result["failed"] = sum(not v["value"] <= v["limit"]
                           for v in checks.values())
    result["checks"] = checks
    for k, v in checks.items():
        log(f"compared {k}: {v['value']!r} limit {v['limit']!r}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    chips = int(spec.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" (torch.cuda.is_available() is "
            f"{torch.cuda.is_available()})")
        return 2
    torch.set_num_threads(4)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        log(f"the run loaded {found}: the benchmark must not")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
