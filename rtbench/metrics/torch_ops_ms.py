"""The torch kernels of the frame graph (the state step, the packs, the sky
lookup and quantize: sim/state.py, render/pipeline.py, render/cuda_rt.py,
scene/textures.py): device milliseconds per frame of every kernel that is
neither kernel A nor kernel B (copies and memsets are not kernels), summed
over the cards; a `rtbench.frame` span of the slice holds
run["frames_per_call"] frames (1 where absent)."""

SKIP = ("raytrace_kernel", "fxaa_kernel")


def read(trace, run):
    if not trace.frames:
        return None
    us = sum(e.dur for e in trace.device if e.cat == "kernel"
             and not any(s in e.name for s in SKIP))
    frames = trace.frames * run.get("frames_per_call", 1)
    return us / 1e3 / frames if us else None
