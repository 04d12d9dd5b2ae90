"""The sky lookup and quantize (render/pipeline.py `_base` after kernel A:
the planes stacked, scene/textures.py `sample_sky_packed_pair`, quantize):
device milliseconds from the end of the frame's last kernel A launch to
the start of the `sky` stage mark, the mean over the traced slice's
complete frames (rtbench/stages.py)."""

from rtbench import stages


def read(trace, run):
    return stages.mean_ms(f.marks["sky"].ts - f.a_end
                          for f in stages.frames(trace))
