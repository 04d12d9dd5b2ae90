"""The offline record job's path on the CPU: `to_host` hands back arrays
the caller owns and leaves CPU inputs as they were, every CUDA graph is
captured on a stream of its own card (torch.cuda.graph stood in for), the
frame-DP gather and the copy to host are spans of a trace, frame DP over
4 CPU entries at a small size is correct against the benchmark's plain
reference, and the `host_alloc_mb` reader reads the program's counters."""

import json
import shutil

import numpy as np
import pytest
import torch

from raytracing_cuda_tpu_torch.app import loop
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils import images, profiling
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from rtbench import run, spec, trace

torch.set_num_threads(2)

DP4 = "island_1080p_dp4.record_dp4"
RECORD8 = "island_720p.record8"


def small_engine() -> Engine:
    return Engine(RenderConfig(width=64, height=32,
                               procedural_sky_shape=(32, 64)), device="cpu")


def actions(n):
    return [Action.idle()._replace(mouse_dx=float(2 * i - 3),
                                   move_forward=i % 2)
            for i in range(n)]


def test_to_host_arrays_keep_their_values_through_later_calls():
    """Call 1's array keeps its values after calls 2 and 3, each array
    equals its tensor, and an array passes through as np.asarray."""
    src = torch.arange(2 * 3 * 4 * 3, dtype=torch.int64).to(
        torch.uint8).reshape(2, 3, 4, 3)
    first = images.to_host(src.clone())
    kept = first.copy()
    later = [images.to_host(src.clone() + k) for k in (1, 2)]
    assert np.array_equal(first, kept)
    for k, arr in zip((1, 2), later):
        assert np.array_equal(arr, src.numpy() + k)
    assert first.dtype == np.uint8 and first.shape == (2, 3, 4, 3)
    plain = np.ones((2, 2, 3), np.uint8)
    assert images.to_host(plain) is plain


def test_to_host_of_a_cpu_tensor_is_as_before(tmp_path):
    """A CPU tensor comes back as .cpu().numpy() gives it, its memory
    shared as before, with no span and nothing counted, also while a
    profiler records."""
    src = torch.zeros((4, 5, 3), dtype=torch.uint8)
    before = dict(profiling.COUNTERS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        arr = images.to_host(src)
    assert np.shares_memory(arr, src.numpy())
    assert profiling.COUNTERS == before
    assert not [e for e in prof.events() if e.name.startswith("images.")]


def test_each_capture_is_on_a_stream_of_its_own_card(monkeypatch):
    """_capture hands torch.cuda.graph a stream of the card it captures
    on, made once per card (torch.cuda's graph, stream and device stood in
    for, so it runs without a card)."""
    made, handed = [], []

    class Stream:
        def __init__(self, device):
            self.device = torch.device(device)
            made.append(self)

    class Graph:
        def __init__(self, graph, stream=None):
            handed.append(stream)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Device:
        def __init__(self, device):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(loop, "_CAPTURE_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "graph", Graph)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    eng = small_engine()
    live = eng.state
    cards = [torch.device("cuda", i) for i in (1, 0, 3, 1, 0)]
    for d in cards:
        eng._capture(lambda e, state, avs: (state, None), 0, live, d, None)
    assert [s.device for s in handed] == cards
    assert [s.device for s in made] == [torch.device("cuda", i)
                                        for i in (1, 0, 3)]
    assert handed[3] is handed[0] and handed[4] is handed[1]


def test_frame_dp_gather_is_a_span_of_its_call(tmp_path):
    """A traced frame-DP call over 2 CPU entries: its gather is the span
    `engine.gather`, after the span `engine.call`, carrying the call's
    number."""
    eng = small_engine()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        eng.render_script_dp(actions(4), dt=0.05, mesh=["cpu"] * 2)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    call = [e for e in events if e["name"] == "engine.call"]
    gather = [e for e in events if e["name"] == "engine.gather"]
    assert len(call) == 1 and len(gather) == 1
    assert gather[0]["ts"] >= call[0]["ts"] + call[0]["dur"]
    assert gather[0]["args"]["call"] == call[0]["args"]["call"]


def test_profiling_counters_and_spans_carry_values(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "COUNTERS", {})
    profiling.count("images.to_host.calls", 1)
    profiling.count("images.to_host.calls", 2)
    assert profiling.COUNTERS == {"images.to_host.calls": 3}
    assert profiling.off("engine.replay", device=2) is profiling.NOOP
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        with profiling.spans(5)("engine.replay", device=2):
            pass
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        span, = [e for e in json.load(f)["traceEvents"]
                 if e.get("name") == "engine.replay"]
    assert (span["args"]["call"], span["args"]["device"]) == (5, 2)


def record8_root(tmp_path):
    """A root whose BENCHMARK.json holds, besides the benchmark's own
    cells, `island_720p.record8`: one card's record job, whose traffic and
    limits rtbench/ has but which BENCHMARK.json does not run (PERF.md)."""
    bench = spec.load_benchmark()
    bench["workloads"].append(
        {"name": RECORD8, "config": "island_720p", "traffic": "record8",
         "chips": 1, "why": "record on one card at 1280x720"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(spec.ROOT / "rtbench" / "configs",
                    tmp_path / "rtbench" / "configs")
    return tmp_path


@pytest.mark.parametrize("cell, mesh", [(DP4, ["cpu"] * 4),
                                        (RECORD8, None)])
def test_a_record_cell_runs_correct_on_the_cpu(cell, mesh, tmp_path):
    """The record cells, at 96x48 with a 64x128 sky (the size of rtbench's
    own CPU runs): frame DP over 4 CPU entries in batches of 16 as
    BENCHMARK.json holds it (and one card's batches of 8), whole batch and
    last frame against the plain reference in rtbench/reference/."""
    root = record8_root(tmp_path) if cell == RECORD8 else spec.ROOT
    res = run.run_cell(cell, 2**31 + 977, 0.5, False, device="cpu",
                       root=root,
                       render_over={"width": 96, "height": 48,
                                    "procedural_sky_shape": [64, 128]},
                       mesh=mesh)
    K = run.Cell(cell, root).params["batch"]
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= K and res["attempted"] % K == 0
    assert set(res["metrics"]) == {"fps", "frame_latency_ms_p99", "setup_s"}


def _trace(frames):
    return trace.Trace([], [], frames)


@pytest.mark.parametrize("counters, want", [
    ({"images.to_host.calls": 4,
      "images.to_host.host_alloc_bytes": 2 * 134217728}, 67.108864),
    ({"images.to_host.calls": 6, "images.to_host.host_alloc_bytes": 0}, 0.0),
    ({}, None)])
def test_host_alloc_mb_reads_the_programs_counters(counters, want,
                                                   monkeypatch):
    monkeypatch.setattr(profiling, "COUNTERS", counters)
    read = spec.reader("host_alloc_mb")
    got = read(_trace(3), {"frames_per_call": 16})
    assert got == (None if want is None else pytest.approx(want))
    assert read(_trace(0), {}) is None


def test_the_record_cells_list_their_metrics():
    """The 4-card cell lists the shared metrics, gather_ms and
    host_alloc_mb; record8 is no cell of BENCHMARK.json and no metric
    lists it."""
    bench = spec.load_benchmark()
    names = {m["name"] for m in spec.metrics_of(bench, "per_layer", DP4)}
    assert {"host_alloc_mb", "gather_ms", "readback_ms", "torch_ops_ms",
            "raytrace_roofline_pct", "fxaa_roofline_pct", "host_call_ms",
            "device_idle_pct", "frame_mfu"} <= names
    assert not names & {"step_ms", "packs_ms", "sky_ms"}
    assert spec.cell(bench, DP4)["chips"] == 4
    assert RECORD8 not in {w["name"] for w in bench["workloads"]}
    assert not any(RECORD8 in m.get("workloads", ())
                   for m in bench["per_layer"])
