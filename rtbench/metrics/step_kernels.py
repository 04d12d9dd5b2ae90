"""The state step's kernels: the kernels launched between the `begin` and
`step` stage marks (the marks not counted), the mean over the traced
slice's complete frames (rtbench/stages.py)."""

from rtbench import stages


def read(trace, run):
    return stages.mean(f.step_kernels for f in stages.frames(trace))
