"""The port's profiling hooks: a CPU torch.profiler trace written to disk,
and FrameTimer's per-batch intervals."""

import json
import os
import time

import torch

from raytracing_cuda_tpu_torch.utils import profiling as tprof
from raytracing_cuda_tpu_torch.utils.timing import FrameTimer

torch.set_num_threads(2)


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
