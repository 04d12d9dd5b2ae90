"""Kernel B (csrc/fxaa.cu `fxaa_kernel`): its count's least time
(rtbench/counts/fxaa.py), charged for each of the run["frames_per_launch"]
frames a launch filters (1 where absent: the K-frame form filters K, a
frame-DP entry its block), as a share of its mean device time per launch
in the traced slice."""

from rtbench.counts import fxaa


def read(trace, run):
    ev = trace.kernels("fxaa_kernel")
    if not ev:
        return None
    per_launch = sum(e.dur for e in ev) / 1e6 / len(ev)
    return 100.0 * fxaa.count(run["width"], run["height"]).seconds() \
        * run.get("frames_per_launch", 1) / per_launch
