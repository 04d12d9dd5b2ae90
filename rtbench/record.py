"""The benchmark's second driver: the offline `record` job as the CLI runs
it (raytracing_cuda_tpu_torch/__main__.py `_record`), for a traffic file
that names `"driver": "record"`.

Set-up builds the Engine on the first card and warms the one batch shape of
the cell: K = the traffic's `batch` frames a call, through
`Engine.step_and_frame_batch` where the cell asks for one chip, and through
`Engine.render_script_dp` over the first `chips` distinct cards
(`parallel.frames.make_frames_mesh`, as `record --dp n` builds its mesh)
where it asks for more: an eager call, the capture (one CUDA graph per mesh
entry), then replays. The window is a closed loop for --seconds: each batch
reads its K packed actions (generator.Pan, dt in slot 14), renders them and
brings the frames to host memory with `utils.images.to_host`, one batch
after the other, as the job does before it writes them: `imgs =
to_host(render(...))`, so the batch before stays alive until the next is in
host memory. Once the window has closed, the frames it delivered (one whole
batch drawn from the seed, so every slot of the K-frame call, and the last
frame) and the final state are held against the plain reference
(rtbench/correct.py), as for the `fly` driver (rtbench/run.py).

`build(cell, device, mesh)` takes a mesh that overrides the cards (a list of
devices that may repeat: ["cpu"] * 4 in the CPU tests, ["cuda:0"] * 4 for a
rehearsal of a 4-card cell on one card); the benchmark's own runs never
pass one.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from rtbench import correct, generator, run, spec
from rtbench import trace as tracing

WARM_CALLS = 4      # the first eager, the second captured, then replays


class Recorder(NamedTuple):
    """The record job's system under test: the Engine, the batch call
    `render` ((K, 16) packed actions → (K, H, W, 3) uint8 on the first
    card), the frame-DP mesh (None on one card), its distinct cards, and
    K."""

    eng: object
    render: Callable
    mesh: list | None
    cards: list
    batch: int

    @property
    def frames_per_launch(self) -> int:
        """The frames each launch of a kernel renders: the batch on one
        card, a mesh entry's block under frame DP."""
        return self.batch // (len(self.mesh) if self.mesh else 1)


def build(cell, device, mesh=None, setup_t0=None) -> Recorder:
    """The Engine of the cell's configuration on `device` and its batch
    call, warmed at the cell's one shape (K frames, dt = the traffic's).
    setup_t0: the host time set-up began, for the set-up log line."""
    from raytracing_cuda_tpu_torch.app.loop import Engine
    from raytracing_cuda_tpu_torch.parallel.frames import make_frames_mesh
    from raytracing_cuda_tpu_torch.sim.actions import Action
    from raytracing_cuda_tpu_torch.utils.config import RenderConfig
    from raytracing_cuda_tpu_torch.utils.images import to_host

    t0 = time.perf_counter()
    setup_t0 = t0 if setup_t0 is None else setup_t0
    eng = Engine(RenderConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in cell.render.items()}), device)
    t1 = time.perf_counter()
    chips = int(cell.entry["chips"])
    if mesh is None and chips > 1:
        mesh = make_frames_mesh(chips, eng.device.type)
    K = int(cell.params["batch"])
    if mesh is None:
        def render(vecs):
            return eng.step_and_frame_batch(vecs)
    else:
        mesh = [torch.device(d) for d in mesh]

        def render(vecs):
            return eng.render_script_dp(vecs, mesh=mesh)
    cards = list(dict.fromkeys(mesh or [eng.device]))
    idle = np.tile(Action.idle().pack(float(cell.params["frame_dt_s"])),
                   (K, 1))
    for _ in range(WARM_CALLS):
        to_host(render(idle))
    synchronize(cards)
    run.log(f"set-up: before the Engine (imports, CUDA, the actions) "
            f"{t0 - setup_t0:.3f} s, the Engine (scene, sky, cull table, "
            f"upload) {t1 - t0:.3f} s, the first batches of {K} (kernels "
            f"loaded or built, assets on {len(cards)} card(s), the capture "
            f"of {len(mesh or [0])} graph(s)) {time.perf_counter() - t1:.3f}"
            f" s")
    return Recorder(eng, render, mesh, cards, K)


class BatchSample:
    """A seeded uniform sample of one whole batch of the window's: batch b
    replaces the kept one with probability 1 / (b + 1). The batch is
    copied into a buffer made before the window, so sampling allocates no
    host memory in it, and every slot of the K-frame call is checked."""

    def __init__(self, rng, shape):
        self.rng = rng
        self.buffer = np.empty(shape, np.uint8)
        self.batch = None

    def offer(self, b: int, imgs: np.ndarray) -> None:
        if b == 0 or int(self.rng.integers(b + 1)) == 0:
            np.copyto(self.buffer, imgs)
            self.batch = b

    @property
    def kept(self) -> dict:
        """{frame index: (H, W, 3) uint8} of the kept batch."""
        if self.batch is None:
            return {}
        K = len(self.buffer)
        return {self.batch * K + j: self.buffer[j] for j in range(K)}


def p99(values) -> float:
    return (statistics.quantiles(values, n=100, method="inclusive")[98]
            if len(values) > 1 else values[0])


def synchronize(cards) -> None:
    for d in cards:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def window(rec: Recorder, vecs, pan, seconds: float, sample, traced,
           events=None):
    """The closed loop for `seconds`: batch b reads its K actions (more are
    drawn from `pan` should the window outrun `vecs`), renders them and
    brings them to host memory, then offers the batch to `sample` (a
    BatchSample). As in the job, the batch before is let go only once the
    name holding it is bound to the next. →
    records: the host times of each batch's actions, the end of its call and
    its delivery, the frames kept by `sample`, the last frame, and the
    profiler of a traced slice of ceil(run.PROFILE_FRAMES / K) batches from
    the window's middle (traced again after the window, up to
    run.PROFILE_TRIES slices, while a slice holds no kernel). events: a
    run.FrameEvents, whose batches are timed while no slice has begun."""
    from raytracing_cuda_tpu_torch.utils.images import to_host

    K = rec.batch
    per_slice = math.ceil(run.PROFILE_FRAMES / K)
    t_act, t_call, t_done = [], [], []
    slices, prof, slice_end = [], None, None
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        b = 0
        while True:
            if prof is None:
                elapsed = time.perf_counter() - t0
                if b and elapsed >= seconds and (
                        not traced or run.slices_done(slices)):
                    break
                if traced and (elapsed >= seconds or (
                        not slices and elapsed >= seconds / 2)):
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    prof.__enter__()
                    slice_end = b + per_slice
            i = b * K
            if i + K > len(vecs):
                vecs = np.concatenate([vecs, pan.take(run.EXTEND_FRAMES)])
            pair = (events.at(b) if events is not None and prof is None
                    and not slices else None)
            if pair is not None:
                pair[0].record()
            with run.spanned(tracing.FRAME_SPAN, prof):
                t = time.perf_counter()
                batch = vecs[i:i + K]
                t_c = time.perf_counter()
                with run.spanned("rtbench.call", prof):
                    out = rec.render(batch)
                t_call.append(time.perf_counter() - t_c)
                with run.spanned("rtbench.readback", prof):
                    imgs = to_host(out)
                out = None
                t_done.append(time.perf_counter())
                t_act.append(t)
                if pair is not None:
                    pair[1].record()
                with run.spanned("rtbench.sample", prof):
                    sample.offer(b, imgs)
            b += 1
            if prof is not None and b == slice_end:
                synchronize(rec.cards)
                prof.__exit__(None, None, None)
                slices.append(run.Slice(prof, b - per_slice))
                prof = None
        last = imgs[-1].copy()
    finally:
        gc.enable()
    return {"t0": t0, "t_act": t_act, "t_call": t_call, "t_done": t_done,
            "batches": b, "frames": b * K, "kept": dict(sample.kept),
            "last": last, "vecs": vecs[:b * K], "slices": slices}


def drive(cell, rec: Recorder, seed: int, seconds: float, traced: bool,
          setup_t0: float, card=None):
    """One window of the seeded record job on the warmed Recorder `rec`,
    from the seed's start → (the result line's object without `correct`,
    the window's records). setup_t0: the host time set-up began; card: the
    CardQuery started with the run, if any."""
    eng, K = rec.eng, rec.batch
    pan = generator.Pan(cell.params, seed)
    on_card = eng.device.type == "cuda"
    events = (run.FrameEvents(max(run.EVENT_FRAMES // K, 2))
              if traced and on_card else None)
    vecs = pan.take(int(cell.params["actions_per_s"] * seconds) + K)
    eng.set_state(run.program_start(pan.start, cell.render["antialiasing"]))
    if on_card:
        synchronize(rec.cards)
        for d in rec.cards:
            torch.cuda.reset_peak_memory_stats(d)
    counts0 = run.launch_counts()
    sample = BatchSample(np.random.default_rng([seed, 1]),
                         (K, cell.render["height"], cell.render["width"], 3))
    setup_s = time.perf_counter() - setup_t0
    out = window(rec, vecs, pan, seconds, sample, traced, events)
    n = out["frames"]
    out["start"] = pan.start
    out["state"] = correct.state_numbers(eng.state)
    counts = {k: (v - counts0[k]) / n for k, v in run.launch_counts().items()}
    peaks = ([torch.cuda.max_memory_reserved(d) for d in rec.cards]
             if on_card else [0])
    run.log(f"launches per frame: {json.dumps(counts)}")
    run.log(f"memory: max_memory_reserved {peaks} bytes, card by card")
    if card is not None:
        for line in card.lines():
            run.log(f"card before the window: {line}")
    if on_card:
        for line in run.CardQuery().lines():
            run.log(f"card after the window: {line}")

    # a frame waits for its batch: each frame of a batch reads its latency
    lat = [(d - a) * 1e3 for a, d in zip(out["t_act"], out["t_done"])
           for _ in range(K)]
    # from the call's return to the frames in host memory: the device's
    # work on the batch and the copy
    wait = [(d - a - c) * 1e3 for a, c, d in zip(
        out["t_act"], out["t_call"], out["t_done"])]
    span = out["t_done"][-1] - out["t0"]
    e2e = {"fps": n / span, "frame_latency_ms_p99": p99(lat),
           "setup_s": setup_s}
    run.log(f"window: {n} frames in {out['batches']} batches of {K} in "
            f"{span:.6f} s; frame latency ms p50 {statistics.median(lat):.6f}"
            f" p99 {p99(lat):.6f} max {max(lat):.6f}; host ms per call p50 "
            f"{statistics.median(out['t_call']) * 1e3:.6f}; ms from a call's "
            f"return to its frames in host memory p50 "
            f"{statistics.median(wait):.6f} p99 {p99(wait):.6f}; setup_s "
            f"{setup_s}")

    result = {"correct": False, "attempted": n, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(eng.device)
                                  if on_card else "cpu"),
                         "count": len(rec.cards),
                         "memory_peak_bytes": int(max(peaks))}}
    if traced:
        first = out["slices"][0].first if out["slices"] else out["batches"]
        timed = events.reading() if events else None
        if timed:
            timed["frames"] *= K
        info = {"width": cell.render["width"],
                "height": cell.render["height"],
                "objects": cell.conf["objects"],
                "host_call_ms": [t * 1e3 for t in out["t_call"][:first]],
                "device_frames": timed, "frames_per_call": K,
                "frames_per_launch": rec.frames_per_launch,
                "chips": len(rec.cards)}
        run.log(f"frames timed by CUDA events: {timed}")
        good = [s.read() for s in out["slices"]
                if s.read().has_kernels(run.KERNELS)]
        tr = good[0] if good else tracing.Trace([], [], 0)
        for m in spec.metrics_of(cell.bench, "per_layer", cell.name):
            v = spec.reader(m["name"])(tr, info)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if good:
            result["device"]["busy_s"] = tr.busy_us() / 1e6
            result["device"]["window_s"] = tr.window_us() / 1e6
            result["breakdown"] = {"device_ops": tr.top_device_ops(),
                                   "idle_gaps": tr.longest_gaps()}
        run.log(f"traced slices: {len(out['slices'])}, with both kernels "
                f"{len(good)}")
    else:
        for m in spec.metrics_of(cell.bench, "end_to_end", cell.name):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    return result, out
