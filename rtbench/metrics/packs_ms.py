"""The packs (render/pipeline.py `frame_packs`: the frame's scene, rays,
coefficient table, params and cull bounds): device milliseconds from the
end of the `step` stage mark to the start of the `packs` mark, the mean
over the traced slice's complete frames (rtbench/stages.py)."""

from rtbench import stages


def read(trace, run):
    return stages.mean_ms(f.marks["packs"].ts - stages.end(f.marks["step"])
                          for f in stages.frames(trace))
