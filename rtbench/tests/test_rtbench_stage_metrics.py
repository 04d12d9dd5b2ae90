"""The stage readers (step_ms, packs_ms, sky_ms, step_kernels,
packs_kernels) on a small synthetic Chrome trace, as torch.profiler writes
one of the marked frame graph: two complete frames and a third that the
slice cuts after its `step` mark."""

import json

import pytest

from rtbench import spec, stages, trace

RUN = {"width": 1280, "height": 720,
       "objects": {"planes": 1, "triangles": 106, "spheres": 26},
       "host_call_ms": [], "device_frames": None}


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _k(name, ts, dur=1.0):
    return _x(name, "kernel", ts, dur)


def _marked(t0, n_step, n_packs, step_end, packs_end, a_end, sky_at):
    """One frame of the marked graph from t0 (µs): the begin mark, n_step
    kernels, the step mark at t0 + step_end, n_packs kernels, the packs
    mark at t0 + packs_end, kernel A ending at t0 + a_end, the sky's
    kernels, the sky mark at t0 + sky_at, kernel B and the readback."""
    ev = [_x("rtbench.frame", "user_annotation", t0, 1000),
          _x("engine.replay", "cpu_op", t0 + 1, 20),
          _k("stage_mark_begin", t0 + 10, 2)]
    ev += [_k("void at::native::elementwise_kernel<128, 4>",
              t0 + 20 + 5 * i) for i in range(n_step)]
    ev.append(_k("stage_mark_step", t0 + step_end, 2))
    ev += [_k("void at::native::reduce_kernel<512, 1>",
              t0 + step_end + 5 + 3 * i) for i in range(n_packs)]
    ev.append(_k("stage_mark_packs", t0 + packs_end, 2))
    ev.append(_k("raytrace_kernel", t0 + packs_end + 4,
                 a_end - packs_end - 4))
    ev += [_k("void at::native::CatArrayBatchedCopy<uint8_t>",
              t0 + a_end + 2, 30),
           _k("void at::native::index_elementwise_kernel<128, 4>",
              t0 + a_end + 40, 20),
           _k("stage_mark_sky", t0 + sky_at, 2),
           _k("fxaa_kernel", t0 + sky_at + 5, 10),
           _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy",
              t0 + sky_at + 20, 50)]
    return ev


@pytest.fixture
def tr(tmp_path):
    events = (_marked(0, 3, 5, 200, 400, 610, 700)
              + _marked(1000, 4, 6, 250, 420, 650, 800)
              # the slice ends after the third frame's step mark
              + _marked(2000, 3, 5, 200, 400, 610, 700)[:7])
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.parse(str(path))


def read(name, t):
    return spec.reader(name)(t, RUN)


def test_complete_frames(tr):
    got = stages.frames(tr)
    assert len(got) == 2
    assert [f.marks["begin"].ts for f in got] == [10, 1010]
    assert [f.a_end for f in got] == [610, 1650]


def test_each_stage_reader(tr):
    # step: the step mark's start less the begin mark's end (10 + 2)
    assert read("step_ms", tr) == pytest.approx(
        ((200 - 12) + (250 - 12)) / 2 / 1e3)
    # packs: the packs mark's start less the step mark's end
    assert read("packs_ms", tr) == pytest.approx(
        ((400 - 202) + (420 - 252)) / 2 / 1e3)
    # sky: the sky mark's start less kernel A's end
    assert read("sky_ms", tr) == pytest.approx(
        ((700 - 610) + (800 - 650)) / 2 / 1e3)
    assert read("step_kernels", tr) == pytest.approx(3.5)
    assert read("packs_kernels", tr) == pytest.approx(5.5)


def test_out_of_order_marks_and_a_frame_without_kernel_a(tmp_path):
    """A frame whose marks come out of order, and one with no kernel A
    between packs and sky, are not complete; the next whole frame is."""
    swapped = _marked(0, 3, 5, 200, 400, 610, 700)
    swapped[2], swapped[6] = ({**swapped[6], "ts": 10},
                              {**swapped[2], "ts": 200})
    no_a = [e for e in _marked(1000, 3, 5, 200, 400, 610, 700)
            if e["name"] != "raytrace_kernel"]
    whole = _marked(2000, 2, 7, 200, 400, 610, 700)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": swapped + no_a + whole}))
    t = trace.parse(str(path))
    assert [f.marks["begin"].ts for f in stages.frames(t)] == [2010]
    assert read("step_kernels", t) == 2
    assert read("packs_kernels", t) == 7


@pytest.mark.parametrize("name", ["step_ms", "packs_ms", "sky_ms",
                                  "step_kernels", "packs_kernels"])
def test_nothing_to_read_without_marks(name):
    """A trace of a program that places no mark, and an empty one."""
    path_free = trace.Trace(
        [trace.Event("raytrace_kernel", "kernel", 0.0, 100.0),
         trace.Event("fxaa_kernel", "kernel", 120.0, 10.0)], [], 1)
    assert read(name, path_free) is None
    assert read(name, trace.Trace([], [], 0)) is None
