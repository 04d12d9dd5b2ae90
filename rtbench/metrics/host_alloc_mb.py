"""Readback in the record job (`utils.images.to_host`): the host memory a
copy of a batch newly allocated, MB a batch, from the program's counters
(`utils.profiling.COUNTERS`), which total the calls made while a profiler
recorded: the traced slice. 0 where every copy reused page-locked memory.
Nothing where the program keeps no such counter or no batch was traced."""


def read(trace, run):
    if not trace.frames:
        return None
    try:
        from raytracing_cuda_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "COUNTERS", {})
    calls = counters.get("images.to_host.calls", 0)
    if not calls:
        return None
    return counters.get("images.to_host.host_alloc_bytes", 0) / 1e6 / calls
