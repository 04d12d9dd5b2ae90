"""Readback (app/window.py `Readback`): the device-to-host copies' device
time per frame of the traced slice."""


def read(trace, run):
    if not trace.frames:
        return None
    us = sum(e.dur for e in trace.device
             if e.cat == "gpu_memcpy" and "DtoH" in e.name)
    return us / 1e3 / trace.frames if us else None
