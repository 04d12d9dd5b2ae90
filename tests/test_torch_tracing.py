"""The program's tracing on the CPU: host spans and stage marks are on
exactly while a torch.profiler session records, the spans of one Engine
call nest in `engine.call` and carry its number, the readback's spans come
only while profiled, nothing a frame or state holds changes under the
profiler, and the benchmark's stage metrics have their readers."""

import json
import os

import pytest
import torch

from raytracing_cuda_tpu_torch import _build
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.app.window import Readback
from raytracing_cuda_tpu_torch.sim import state as tsim
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils import profiling
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from rtbench import spec

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_METRICS = {"step_ms": "ms", "packs_ms": "ms", "sky_ms": "ms",
                 "step_kernels": "kernels", "packs_kernels": "kernels"}


def small_engine() -> Engine:
    return Engine(RenderConfig(width=64, height=32,
                               procedural_sky_shape=(32, 64)), device="cpu")


def actions(n):
    return [Action.idle()._replace(mouse_dx=float(3 * i - 4),
                                   move_forward=i % 2)
            for i in range(n)]


def profiled_events(tmp_path, fn) -> list:
    """The complete events ("X") of a CPU profile of fn(), shapes
    recorded, as the exported Chrome trace holds them."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X"]


def named(events, name) -> list:
    return sorted((e for e in events if e["name"] == name),
                  key=lambda e: e["ts"])


def inside(child, parent) -> bool:
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def test_span_is_the_shared_noop_off_the_profiler():
    assert not profiling.recording()
    assert profiling.span_function(3)("engine.call") is profiling.NOOP
    assert profiling.span_function()("readback.wait") is profiling.NOOP
    assert profiling.span_function(7) is profiling.off
    assert profiling.off("engine.replay") is profiling.NOOP
    with profiling.span_function(3)("engine.call") as s:
        assert s is None


@pytest.mark.parametrize("stage", profiling.STAGES)
def test_mark_does_nothing_off_a_marked_capture(stage):
    """Outside marking() a mark returns at once: no library is built or
    loaded (this machine has no nvcc) and no kernel launched, also while
    a profiler records."""
    assert profiling.mark(stage) is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.recording()
        assert profiling.mark(stage) is None
    assert "marks" not in _build._LIBS


def test_engine_call_spans_nest_and_share_the_call_number(tmp_path):
    """Two step_and_frame calls of a CPU Engine (eager): each is one
    engine.call holding its engine.upload and engine.eager, in that order,
    every span carrying the call's number; the second call's number is the
    next."""
    eng = small_engine()
    eng.step_and_frame()
    a = actions(2)
    events = profiled_events(
        tmp_path, lambda: [eng.step_and_frame(x, 0.02) for x in a])
    calls = named(events, "engine.call")
    assert len(calls) == 2
    numbers = [c["args"]["call"] for c in calls]
    assert numbers[1] == numbers[0] + 1
    for c in calls:
        parts = [next(e for e in named(events, n) if inside(e, c))
                 for n in ("engine.upload", "engine.eager")]
        assert [p["args"]["call"] for p in parts] == [c["args"]["call"]] * 2
        assert parts[0]["ts"] <= parts[1]["ts"]
    assert not named(events, "engine.replay")
    assert not named(events, "engine.capture")


def test_readback_spans_only_while_profiled(tmp_path):
    """Device-free frames through the readback ring: only the submits
    made while profiled leave spans, one readback.copy each and one
    readback.wait for each frame handed back."""
    ring = Readback()
    frames = [torch.full((4, 6, 3), i, dtype=torch.uint8) for i in range(5)]
    assert ring.submit(frames[0]) is None

    def inside_profile():
        for f in frames[1:3]:
            ring.submit(f)

    events = profiled_events(tmp_path, inside_profile)
    for f in frames[3:]:
        ring.submit(f)
    assert torch.equal(ring.flush(), frames[4])
    assert len(named(events, "readback.copy")) == 2
    assert len(named(events, "readback.wait")) == 2
    assert all("call" not in e["args"] for e in named(events,
                                                      "readback.copy"))


def test_frames_and_state_identical_with_and_without_profiler(tmp_path):
    plain, traced = small_engine(), small_engine()
    a = actions(3)
    want = [plain.step_and_frame(x, 0.03) for x in a]
    want.append(plain.frame())
    got = []

    def run():
        got.extend(traced.step_and_frame(x, 0.03) for x in a)
        got.append(traced.frame())

    events = profiled_events(tmp_path, run)
    assert len(named(events, "engine.call")) == 4
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(x, y) for x, y in zip(
        tsim.state_tensors(traced.state), tsim.state_tensors(plain.state)))


def test_trace_holds_the_engine_spans(tmp_path):
    """utils.profiling.trace, the operator's way to the spans: the
    exported trace holds each call's span with its number."""
    eng = small_engine()
    out = str(tmp_path / "prof")
    with profiling.trace(out):
        eng.step_and_frame()
        eng.step()
    with open(os.path.join(out, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    calls = [e for e in events if e.get("name") == "engine.call"]
    assert [e["args"]["call"] for e in calls] == [1, 2]


@pytest.mark.parametrize("name", sorted(STAGE_METRICS))
def test_stage_metric_has_a_reader_and_its_unit(name):
    bench = spec.load_benchmark()
    m = next(m for m in bench["per_layer"] if m["name"] == name)
    assert callable(spec.reader(name))
    assert m["unit"] == STAGE_METRICS[name]
    assert (m["source"], m["moves"], m["better"]) == (
        "device_trace", "fps", "lower")
    assert m["workloads"] == ["island_720p.fly", "island_1080p.fly"]
