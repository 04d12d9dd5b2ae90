"""The port's profiling hooks: FrameProbe against the JAX package's on the
same clock readings, a CPU torch.profiler trace written to disk, and
FrameTimer's per-batch intervals."""

import json
import os
import time

import pytest
import torch

from raytracing_cuda_tpu.utils import profiling as jprof
from raytracing_cuda_tpu_torch.utils import profiling as tprof
from raytracing_cuda_tpu_torch.utils.timing import FrameTimer

torch.set_num_threads(2)


def run_probe(cls, readings, window):
    it = iter(readings)
    orig = time.perf_counter
    time.perf_counter = lambda: next(it)
    try:
        p = cls(window=window)
        dts = [p.tick() for _ in readings]
    finally:
        time.perf_counter = orig
    return dts, p.stats()


@pytest.mark.parametrize("window", [3, 16, 240])
def test_frame_probe_matches_jax(window):
    readings = [0.0]
    for i in range(40):
        readings.append(readings[-1] + 0.001 * (1 + (i * 7) % 5))
    assert run_probe(tprof.FrameProbe, readings, window) == run_probe(
        jprof.FrameProbe, readings, window)


def test_frame_probe_empty_and_live():
    p = tprof.FrameProbe(window=16)
    assert p.stats() == {"frames": 0}
    for _ in range(5):
        p.tick()
        time.sleep(0.002)
    s = p.stats()
    assert s["frames"] == 4 and s["mean_ms"] >= 1.0
    assert s["p99_ms"] >= s["p50_ms"] > 0


def test_cpu_trace_writes_chrome_trace(tmp_path):
    out = str(tmp_path / "prof")
    with tprof.trace(out) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    path = os.path.join(out, tprof.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_frame_timer_batch_intervals():
    t = FrameTimer(4, 2).start()
    time.sleep(0.004)
    t.tick(4)
    t.tick()
    s = t.stop()
    assert s.frames == 5 and len(s.frame_ms) == 2
    # the batch entry is its interval over 4 frames; seconds is the sum of
    # the intervals, not of the per-frame entries
    assert 0.9e-3 < s.frame_ms[0] < s.seconds * 1e3 / 4 + 1e-6
    assert s.seconds >= 0.004
