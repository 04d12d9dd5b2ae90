"""Kernel A (csrc/raytrace.cu `raytrace_kernel`): its count's least time
(rtbench/counts/raytrace.py), charged for each of the
run["frames_per_launch"] frames a launch renders (1 where absent: the K-frame
form renders K, a frame-DP entry its block), as a share of its mean device
time per launch in the traced slice."""

from rtbench.counts import raytrace


def read(trace, run):
    ev = trace.kernels("raytrace_kernel")
    if not ev:
        return None
    per_launch = sum(e.dur for e in ev) / 1e6 / len(ev)
    least = raytrace.count(run["width"], run["height"],
                           run["objects"]).seconds()
    return 100.0 * least * run.get("frames_per_launch", 1) / per_launch
