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


def test_the_record_values_default_to_one_frame(tr):
    """frames_per_call, frames_per_launch and chips at 1, as the fly driver
    leaves them, read what the fly driver's run reads."""
    ones = {**RUN, "frames_per_call": 1, "frames_per_launch": 1, "chips": 1}
    for m in spec.load_benchmark()["per_layer"]:
        assert read(m["name"], tr, ones) == read(m["name"], tr), m["name"]


def _batch(t0, k, device=0):
    """One record batch of k frames from t0 (µs), each frame's work as in
    _frame, each kernel launched once for the k frames: the host span, the
    upload, the torch kernels, kernel A, kernel B and the batch's copy to
    host."""
    return [
        _x("rtbench.frame", "user_annotation", t0, 1000 * k),
        _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t0 + 90, 5),
        _x("void at::native::elementwise_kernel<128, 2>", "kernel",
           t0 + 100, 300 * k),
        _x("raytrace_kernel", "kernel", t0 + 100 + 300 * k, 200 * k),
        _x("void at::native::index_elementwise_kernel", "kernel",
           t0 + 100 + 500 * k, 100 * k),
        _x("fxaa_kernel", "kernel", t0 + 100 + 600 * k, 10 * k),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
           t0 + 100 + 610 * k, 50 * k),
    ]


def _parsed(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.parse(str(path))


def test_a_batch_of_eight_reads_per_frame(tr, tmp_path):
    """Two batches of K = 8 whose launches each do 8 frames' work read the
    per-frame values of the single-frame trace."""
    batches = _parsed(tmp_path, _batch(0, 8) + _batch(8000, 8))
    assert batches.frames == 2
    run = {**RUN, "frames_per_call": 8, "frames_per_launch": 8,
           "device_frames": {"frames": 8 * 400, "span_ms": 8 * 600.0,
                             "idle_ms": 8 * 12.0}}
    for name in ("readback_ms", "torch_ops_ms", "raytrace_roofline_pct",
                 "fxaa_roofline_pct", "device_idle_pct", "frame_mfu"):
        assert read(name, batches, run) == pytest.approx(read(name, tr)), name
    # frame DP over 4 cards: a launch renders a block of 2, and the frame
    # is charged against 4 cards' peaks
    dp = {**run, "frames_per_launch": 2, "chips": 4}
    assert read("raytrace_roofline_pct", batches, dp) == pytest.approx(
        read("raytrace_roofline_pct", tr) / 4)
    assert read("frame_mfu", batches, dp) == pytest.approx(
        read("frame_mfu", tr) / 4)


def test_gather_ms(tr, tmp_path):
    """The frame-DP gather: the device-to-device and peer copies per frame;
    none in the fly trace."""
    assert read("gather_ms", tr) is None
    events = _batch(0, 4) + [
        _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 2000, 30),
        _x("Memcpy PtoP (Device -> Device)", "gpu_memcpy", 2100, 90),
        _x("Memcpy PtoP (Device -> Device)", "gpu_memcpy", 2200, 80)]
    got = read("gather_ms", _parsed(tmp_path, events),
               {**RUN, "frames_per_call": 4})
    assert got == pytest.approx(0.2 / 4)


def test_busy_is_the_mean_over_the_cards(tmp_path):
    ev = [{**_x("raytrace_kernel", "kernel", 0, 100), "args": {"device": 0}},
          {**_x("raytrace_kernel", "kernel", 50, 100), "args": {"device": 1}},
          {**_x("fxaa_kernel", "kernel", 300, 100), "args": {"device": 1}}]
    t = _parsed(tmp_path, ev)
    assert {e.device for e in t.device} == {0, 1}
    assert t.busy_us() == pytest.approx((100 + 200) / 2)
    assert t.window_us() == pytest.approx(400)
    assert t.gaps() == [(150, 300)]
