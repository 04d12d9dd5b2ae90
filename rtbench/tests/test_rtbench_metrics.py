"""Every per-layer metric's reader on a small synthetic Chrome trace, as
torch.profiler writes one."""

import json

import pytest

from rtbench import spec, trace
from rtbench.counts import fxaa, frame, raytrace

ISLAND = {"planes": 1, "triangles": 106, "spheres": 26}
RUN = {"width": 1280, "height": 720, "objects": ISLAND,
       "host_call_ms": [0.2, 0.1, 0.3, 0.15],
       "device_frames": {"frames": 400, "span_ms": 600.0, "idle_ms": 12.0}}


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _frame(t0):
    """One frame's events from t0 (µs): the host span, the action upload,
    torch kernels, kernel A, kernel B and the readback."""
    return [
        _x("rtbench.frame", "user_annotation", t0, 1000),
        _x("rtbench.readback", "user_annotation", t0 + 760, 230),
        _x("cudaGraphLaunch", "cuda_runtime", t0 + 10, 20),
        _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t0 + 90, 5),
        _x("void at::native::elementwise_kernel<128, 2>", "kernel",
           t0 + 100, 300),
        _x("raytrace_kernel", "kernel", t0 + 400, 200),
        _x("void at::native::index_elementwise_kernel", "kernel",
           t0 + 600, 100),
        _x("fxaa_kernel", "kernel", t0 + 700, 10),
        _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", t0 + 710, 50),
        _x("Memset (Device)", "gpu_memset", t0 + 20, 2),
    ]


@pytest.fixture
def tr(tmp_path):
    events = _frame(0) + _frame(1000) + [
        {"ph": "i", "name": "marker", "ts": 5},
        _x("gpu annotation", "gpu_user_annotation", 0, 2000)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.parse(str(path))


def read(name, t, run=RUN):
    return spec.reader(name)(t, run)


def test_parse(tr):
    assert tr.frames == 2
    assert len(tr.device) == 14
    assert {h.name for h in tr.host} == {"rtbench.frame", "rtbench.readback"}
    assert tr.window_us() == pytest.approx(1760 - 20)
    # busy: the memset 20-22, the upload 90-95, the kernels and the
    # readback 100-760, in each frame
    assert tr.busy_us() == pytest.approx(2 * (2 + 5 + 660))
    assert tr.has_kernels(("raytrace_kernel", "fxaa_kernel"))
    assert not tr.has_kernels(("raytrace_kernel", "no_such_kernel"))


def test_each_reader(tr):
    assert read("host_call_ms", tr) == pytest.approx(0.175)
    assert read("readback_ms", tr) == pytest.approx(0.05)
    assert read("torch_ops_ms", tr) == pytest.approx(0.4)
    least_a = raytrace.count(1280, 720, ISLAND).seconds()
    assert read("raytrace_roofline_pct", tr) == pytest.approx(
        100 * least_a / 200e-6)
    least_b = fxaa.count(1280, 720).seconds()
    assert read("fxaa_roofline_pct", tr) == pytest.approx(
        100 * least_b / 10e-6)
    # the device's share: from the frames timed by events, not the slice
    assert read("device_idle_pct", tr) == pytest.approx(2.0)
    least_f = frame.count(1280, 720, ISLAND).seconds()
    assert read("frame_mfu", tr) == pytest.approx(
        100 * least_f / 1.5e-3)


def test_readers_find_nothing_in_an_empty_trace():
    empty = trace.Trace([], [], 0)
    for m in spec.load_benchmark()["per_layer"]:
        v = read(m["name"], empty, {**RUN, "host_call_ms": [],
                                     "device_frames": None})
        assert v is None, m["name"]


def test_breakdown(tr):
    top = tr.top_device_ops(3)
    assert top[0] == ["void at::native::elementwise_kernel<128, 2>", 600e-6]
    assert [t[0] for t in top[1:]] == [
        "raytrace_kernel", "void at::native::index_elementwise_kernel"]
    gaps = tr.longest_gaps()
    # the longest gap, 760 to 1020, lies in frame 0's readback span
    assert gaps[0] == ["rtbench.readback", pytest.approx(260e-6)]
    assert all(g[1] > 0 for g in gaps)
    assert len(gaps) == len(tr.gaps()) <= 10


def test_every_per_layer_metric_has_a_reader_and_unit():
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
