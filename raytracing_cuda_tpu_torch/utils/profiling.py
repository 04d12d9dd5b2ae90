"""Profiling / tracing hooks (port of raytracing_cuda_tpu/utils/
profiling.py).

`trace` records host and device activity around a block of frame work with
torch.profiler and exports a Chrome trace (open it in Perfetto or
chrome://tracing); `FrameProbe` keeps rolling per-frame wall-clock stats
for interactive loops, beside utils.timing's FrameTimer (sustained
throughput with device timing).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(out_dir: str):
    """torch.profiler capture of CPU activity, and of CUDA activity where a
    card is present, around the block → yields the profiler (for
    key_averages()) and writes out_dir/trace.json when the block ends."""
    os.makedirs(out_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))


class FrameProbe:
    """Rolling per-frame wall-clock stats: last/mean/p99 frame ms.

    A host-side probe for interactive loops; pairs with utils.timing's
    FrameTimer (which measures sustained throughput with device timing).
    """

    def __init__(self, window: int = 240):
        self.window = window
        self.samples: collections.deque = collections.deque(maxlen=window)
        self._last = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.samples.append(dt)     # deque(maxlen) evicts in O(1)
        self._last = now
        return dt

    def stats(self) -> dict:
        if not self.samples:
            return {"frames": 0}
        s = sorted(self.samples)
        n = len(s)
        return {
            "frames": n,
            "mean_ms": round(sum(s) / n * 1e3, 2),
            "p50_ms": round(s[n // 2] * 1e3, 2),
            "p99_ms": round(s[min(n - 1, int(n * 0.99))] * 1e3, 2),
            "fps": round(n / sum(s), 1),
        }
