"""The packs' kernels: the kernels launched between the `step` and `packs`
stage marks (the marks not counted), the mean over the traced slice's
complete frames (rtbench/stages.py)."""

from rtbench import stages


def read(trace, run):
    return stages.mean(f.packs_kernels for f in stages.frames(trace))
