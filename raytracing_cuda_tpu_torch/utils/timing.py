"""Frame timing and throughput (port of raytracing_cuda_tpu/utils/timing.py).

Replaces the reference's FPS window title (main.cpp:230-259). On a CUDA
device the frame times come from CUDA events recorded on the stream after
each frame's work, so they measure when the device finished each frame; on
the CPU they come from the host clock.
"""

from __future__ import annotations

import dataclasses
import time

import torch


def device_sync(device: torch.device) -> None:
    """Wait for all queued work on `device` (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class FrameStats:
    frames: int
    seconds: float
    width: int
    height: int
    frame_ms: list = dataclasses.field(default_factory=list)

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds > 0 else float("inf")

    @property
    def mrays_per_s(self) -> float:
        return self.fps * self.width * self.height / 1e6

    def as_dict(self) -> dict:
        ms = sorted(self.frame_ms)
        return {
            "frames": self.frames,
            "seconds": self.seconds,
            "fps": self.fps,
            "mrays_per_s": self.mrays_per_s,
            "frame_ms_median": ms[len(ms) // 2] if ms else None,
            "frame_ms_max": ms[-1] if ms else None,
        }


class FrameTimer:
    """Timer over a run of frames: CUDA events on a CUDA device, else the
    host clock. Each tick closes an interval of one or more frames; its
    frame_ms entry is the interval divided by its frame count."""

    def __init__(self, width: int, height: int, device="cpu"):
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.frames = 0
        self._marks: list = []
        self._counts: list = []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    def start(self) -> "FrameTimer":
        self._marks = [self._mark()]
        self._counts = []
        return self

    def tick(self, frames: int = 1) -> None:
        """Count `frames` frames whose work has been queued."""
        self._marks.append(self._mark())
        self._counts.append(frames)
        self.frames += frames

    def stop(self) -> FrameStats:
        device_sync(self.device)
        if self.cuda:
            ms = [a.elapsed_time(b) for a, b in zip(self._marks, self._marks[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(self._marks, self._marks[1:])]
        return FrameStats(self.frames, sum(ms) / 1e3, self.width, self.height,
                          [m / n for m, n in zip(ms, self._counts)])
