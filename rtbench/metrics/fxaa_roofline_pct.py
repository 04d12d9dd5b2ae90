"""Kernel B (csrc/fxaa.cu `fxaa_kernel`): its count's least time
(rtbench/counts/fxaa.py) as a share of its mean device time per launch in
the traced slice."""

from rtbench.counts import fxaa


def read(trace, run):
    ev = trace.kernels("fxaa_kernel")
    if not ev:
        return None
    per_launch = sum(e.dur for e in ev) / 1e6 / len(ev)
    return 100.0 * fxaa.count(run["width"], run["height"]).seconds() \
        / per_launch
