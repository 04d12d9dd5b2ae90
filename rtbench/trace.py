"""A torch.profiler slice of the window, parsed: the device's kernels,
copies and memsets, and the harness's host spans around them.

The harness traces a bounded slice of frames inside the window (the trace
of a whole window would be hundreds of MB), exports it as a Chrome trace,
and parses it into a `Trace`; the per-layer metric readers
(rtbench/metrics/) read only that. Now and then a trace comes back with no
device events at all; `has_kernels` tells the harness to trace another
slice.
"""

from __future__ import annotations

import json
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPAN = "user_annotation"
FRAME_SPAN = "rtbench.frame"


class Event(NamedTuple):
    name: str
    cat: str
    ts: float       # microseconds
    dur: float
    device: int = 0     # the card a device event ran on


class Trace(NamedTuple):
    """A traced slice: device events, the harness's host spans (record
    function ranges named rtbench.*), and the frames the slice holds."""

    device: list
    host: list
    frames: int

    def kernels(self, name_part: str) -> list:
        """The kernel events whose name holds name_part."""
        return [e for e in self.device
                if e.cat == "kernel" and name_part in e.name]

    def has_kernels(self, names) -> bool:
        return all(self.kernels(n) for n in names)

    def busy_intervals(self, device=None) -> list:
        """The union of the device events' intervals (those of card
        `device` alone, where given), [(start, end)] in microseconds, in
        order."""
        merged = []
        events = [e for e in self.device
                  if device is None or e.device == device]
        for e in sorted(events, key=lambda e: e.ts):
            lo, hi = e.ts, e.ts + e.dur
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [tuple(iv) for iv in merged]

    def window_us(self) -> float:
        """From the first device event's start to the last one's end."""
        if not self.device:
            return 0.0
        return (max(e.ts + e.dur for e in self.device)
                - min(e.ts for e in self.device))

    def busy_us(self) -> float:
        """The time in which an operation ran, the mean over the cards the
        slice's device events ran on."""
        cards = {e.device for e in self.device}
        return sum(hi - lo for d in cards
                   for lo, hi in self.busy_intervals(d)) / max(len(cards), 1)

    def gaps(self) -> list:
        """The device's idle gaps inside the window, in which no card ran
        anything, [(start, end)] µs."""
        iv = self.busy_intervals()
        return [(a[1], b[0]) for a, b in zip(iv, iv[1:]) if b[0] > a[1]]

    def host_at(self, t: float) -> str:
        """The innermost harness span running on the host at time t (µs),
        or "host" where none is."""
        inside = [h for h in self.host if h.ts <= t <= h.ts + h.dur]
        if not inside:
            return "host"
        return min(inside, key=lambda h: h.dur).name

    def top_device_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the n device operations that took most time
        in the slice, by name."""
        tot: dict = {}
        for e in self.device:
            tot[e.name] = tot.get(e.name, 0.0) + e.dur
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], us / 1e6] for name, us in top]

    def longest_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds]] of the n longest idle gaps
        of the device, named by the harness span at each gap's middle."""
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self.host_at((lo + hi) / 2), (hi - lo) / 1e6]
                for lo, hi in gaps]


def parse(path: str) -> Trace:
    """A Chrome trace written by torch.profiler → Trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ev = Event(e.get("name", ""), e.get("cat", ""), float(e["ts"]),
                   float(e["dur"]), int(e.get("args", {}).get("device", 0)))
        if ev.cat in DEVICE_CATS:
            device.append(ev)
        elif ev.cat == HOST_SPAN and ev.name.startswith("rtbench."):
            host.append(ev)
    frames = sum(1 for h in host if h.name == FRAME_SPAN)
    return Trace(device, host, frames)
