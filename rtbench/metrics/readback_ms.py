"""Readback (app/window.py `Readback`; the record job's
`utils.images.to_host`): the device-to-host copies' device time per frame
of the traced slice, whose `rtbench.frame` spans each hold
run["frames_per_call"] frames (1 where absent)."""


def read(trace, run):
    if not trace.frames:
        return None
    us = sum(e.dur for e in trace.device
             if e.cat == "gpu_memcpy" and "DtoH" in e.name)
    frames = trace.frames * run.get("frames_per_call", 1)
    return us / 1e3 / frames if us else None
