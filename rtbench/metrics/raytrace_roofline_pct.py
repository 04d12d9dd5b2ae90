"""Kernel A (csrc/raytrace.cu `raytrace_kernel`): its count's least time
(rtbench/counts/raytrace.py) as a share of its mean device time per launch
in the traced slice."""

from rtbench.counts import raytrace


def read(trace, run):
    ev = trace.kernels("raytrace_kernel")
    if not ev:
        return None
    per_launch = sum(e.dur for e in ev) / 1e6 / len(ev)
    least = raytrace.count(run["width"], run["height"],
                           run["objects"]).seconds()
    return 100.0 * least / per_launch
