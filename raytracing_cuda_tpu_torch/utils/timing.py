"""Frame timing and throughput (port of raytracing_cuda_tpu/utils/timing.py).

Replaces the reference's FPS window title (main.cpp:230-259). On a CUDA
device the frame times come from CUDA events recorded on the stream after
each frame's work, so they measure when the device finished each frame; on
the CPU they come from the host clock. Every run is also read by the host
clock from its start to the end of its last frame's work (`host_seconds`),
the way the JAX package times its loops, so a benchmark can report both.
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
    host_seconds: float = 0.0    # the same run by the host clock, end sync in

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds > 0 else float("inf")

    @property
    def host_fps(self) -> float:
        return (self.frames / self.host_seconds if self.host_seconds > 0
                else float("inf"))

    @property
    def mrays_per_s(self) -> float:
        return self.fps * self.width * self.height / 1e6

    def as_dict(self) -> dict:
        ms = sorted(self.frame_ms)
        return {
            "frames": self.frames,
            "seconds": self.seconds,
            "fps": self.fps,
            "host_fps": self.host_fps,
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
        self._t0 = time.perf_counter()
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
        host_seconds = time.perf_counter() - self._t0
        if self.cuda:
            ms = [a.elapsed_time(b) for a, b in zip(self._marks, self._marks[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(self._marks, self._marks[1:])]
        return FrameStats(self.frames, sum(ms) / 1e3, self.width, self.height,
                          [m / n for m, n in zip(ms, self._counts)],
                          host_seconds)


def capture_graph(fn, reps: int):
    """A CUDA graph of reps calls of fn() on the current CUDA device, after
    one warm-up call outside the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_ms(graph, reps: int, replays: int = 5) -> float:
    """Device milliseconds per call of a capture_graph(fn, reps) graph,
    from CUDA events around `replays` replays back to back."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * reps)


def graph_device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of fn() on the current CUDA device, from
    CUDA events around 5 replays of a CUDA graph of reps calls,
    which the card runs back to back without waiting on the host. For
    launches so short that events around a host loop time the host's launch
    rate instead."""
    return replay_ms(capture_graph(fn, reps), reps)


def graph_nodes(fn) -> int:
    """The node count of a CUDA graph of one fn() call on the current CUDA
    device (cudaGraphGetNodes on the graph a capture kept; the graph and
    its memory are released before this returns). fn must already have run
    once eagerly, as any capture needs."""
    import ctypes

    from raytracing_cuda_tpu_torch.parallel.mesh import _cudart

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    lib = _cudart()
    lib.cudaGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_size_t)]
    lib.cudaGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    err = lib.cudaGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    graph.reset()
    torch.cuda.empty_cache()
    if err:
        raise RuntimeError(f"cudaGraphGetNodes failed: "
                           f"{lib.cudaGetErrorString(err).decode()}")
    return n.value
