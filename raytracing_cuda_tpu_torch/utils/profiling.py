"""Profiling and tracing hooks (port of raytracing_cuda_tpu/utils/
profiling.py).

`trace` records host and device activity around a block of frame work with
torch.profiler and exports a Chrome trace (open it in Perfetto or
chrome://tracing).

The program's own tracing is on exactly while a torch.profiler session
records (`recording()`). Off, an Engine call costs one flag check, a
readback one flag check and two shared no-op contexts, and the device
nothing: no graph replayed then holds a mark.

- `span_function(call)(name, **values)` is, while the profiler records, a
  host range of the trace (the Engine's calls and their upload, replay,
  eager run and capture, and a frame-DP call's gather; the readback's copy
  and wait; `utils/images.py` `to_host` and its copy and wait), else
  NOOP. The ranges lie on the clock the device's events share, so every
  idle gap of the device can be put down to the host's work at that
  moment. The spans of one Engine call carry its number (`call`), and
  a span may carry more integers (`values`: the card a replay runs
  on, the host bytes a copy to host allocated), shown in the
  trace where the profiler records shapes, as `trace` does.
- `count(name, n)` adds n to the program counter `name` in COUNTERS, the
  totals over the calls made while a profiler recorded (`to_host`'s
  calls and the host bytes they allocated), which the benchmark reads.
- `mark(stage)` launches one of four empty kernels (csrc/marks.cu) at a
  stage boundary of a frame: `begin` before the state step, `step` after
  it, `packs` after the packs, `sky` after the sky lookup and quantize. It
  launches only inside `marking()`, which the Engine opens to capture the
  marked variant of a frame graph while a profiler records; the graphs it
  replays otherwise hold no mark.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import os

import torch

from raytracing_cuda_tpu_torch import _build

TRACE_FILE = "trace.json"
STAGES = ("begin", "step", "packs", "sky")

# the program counters: totals over the traced calls (`count`)
COUNTERS: dict = {}
# the marks' library while marks are being captured, else None
_MARKING: contextvars.ContextVar = contextvars.ContextVar("stage_marks",
                                                          default=None)
NOOP = contextlib.nullcontext()


@contextlib.contextmanager
def trace(out_dir: str):
    """torch.profiler capture of CPU activity, and of CUDA activity where a
    card is present, around the block → yields the profiler (for
    key_averages()) and writes out_dir/trace.json when the block ends. The
    program's spans and stage marks are in it (shapes are recorded, so each
    span shows its Engine call's number)."""
    os.makedirs(out_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))


def recording() -> bool:
    """Whether a torch.profiler session records on this thread now."""
    return torch.autograd._profiler_enabled()


def off(name: str, **values):
    """The span function of an untraced call: name → NOOP, one shared
    context that does nothing."""
    return NOOP


def spans(call: int | None = None):
    """The span function of one traced call: (name, **values) → a host
    range of the trace named `name`, carrying `call` (its args' "call")
    and the integers `values` under their names."""
    # record_function would drop its args string from the exported trace;
    # this range keeps keyword values there (under record_shapes)
    from torch._C._profiler import _RecordFunctionFast

    kw = {} if call is None else {"call": call}
    return lambda name, **values: _RecordFunctionFast(name, [],
                                                      {**kw, **values})


def span_function(call: int | None = None):
    """spans(call) while the profiler records, else off: one flag check."""
    return spans(call) if recording() else off


def count(name: str, n: int) -> None:
    """Add n to the program counter `name` (COUNTERS)."""
    COUNTERS[name] = COUNTERS.get(name, 0) + n


def _marks_library():
    """csrc/marks.cu built and loaded, every mark's module loaded (so no
    capture loads one)."""
    lib = _build.load("marks")
    lib.rt_marks_load.argtypes = []
    lib.rt_marks_load.restype = ctypes.c_int
    lib.rt_stage_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.rt_stage_mark.restype = ctypes.c_int
    _build.check(lib, lib.rt_marks_load(), "loading the stage marks")
    return lib


@contextlib.contextmanager
def marking():
    """Inside the block `mark` launches its kernel (on a card: the marks'
    library is built and loaded on entering, before any capture)."""
    token = _MARKING.set(_marks_library())
    try:
        yield
    finally:
        _MARKING.reset(token)


def mark(stage: str) -> None:
    """Launch stage `stage`'s mark (one of STAGES) on the current CUDA
    stream inside `marking()`; elsewhere return at once."""
    lib = _MARKING.get()
    if lib is None:
        return
    err = lib.rt_stage_mark(STAGES.index(stage),
                            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"stage mark {stage}")
