"""The frame-DP gather (parallel/mesh.py `place_bands`, called by
`Engine.render_script_dp`: each mesh entry's block of frames copied into
the batch on the first card): the device time of the device-to-device and
peer copies per frame of the traced slice, whose `rtbench.frame` spans
each hold run["frames_per_call"] frames (1 where absent)."""

KINDS = ("DtoD", "PtoP")


def read(trace, run):
    if not trace.frames:
        return None
    us = sum(e.dur for e in trace.device if e.cat == "gpu_memcpy"
             and any(k in e.name for k in KINDS))
    frames = trace.frames * run.get("frames_per_call", 1)
    return us / 1e3 / frames if us else None
