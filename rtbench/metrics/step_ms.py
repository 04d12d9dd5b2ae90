"""The state step (sim/state.py `animate_packed`, the first work of the
frame graph): device milliseconds from the end of the `begin` stage mark
to the start of the `step` mark, the mean over the traced slice's complete
frames (rtbench/stages.py)."""

from rtbench import stages


def read(trace, run):
    return stages.mean_ms(f.marks["step"].ts - stages.end(f.marks["begin"])
                          for f in stages.frames(trace))
