"""The frames of a traced slice, split at the program's stage marks.

In a traced run the Engine replays the variant of its frame graph that
holds four empty kernels (raytracing_cuda_tpu_torch/csrc/marks.cu), one at
each stage boundary of a frame: `stage_mark_begin` before the state step,
`stage_mark_step` after it, `stage_mark_packs` after the packs, and
`stage_mark_sky` after the sky lookup and quantize, which follow kernel A.
A frame is complete where its four marks come in that order with kernel A
between `packs` and `sky`; a frame the slice cuts, or one whose marks are
out of order, is left out. The stage readers (rtbench/metrics/step_ms.py
and the others) take means over the complete frames, and find nothing in a
trace without marks, such as one of a program that places none.
"""

from __future__ import annotations

from typing import NamedTuple

MARK = "stage_mark_"
STAGES = ("begin", "step", "packs", "sky")
KERNEL_A = "raytrace_kernel"


class Frame(NamedTuple):
    """One complete frame: its four marks (trace.Event), the end of the
    last kernel A launch before `sky` (µs), and the kernels other than the
    marks between `begin` and `step`, and between `step` and `packs`."""

    marks: dict
    a_end: float
    step_kernels: int
    packs_kernels: int


def stage_of(name: str):
    """The stage a kernel's name marks, or None."""
    i = name.find(MARK)
    if i < 0:
        return None
    stage = name[i + len(MARK):].split("(")[0]
    return stage if stage in STAGES else None


def frames(trace) -> list:
    """The complete frames of a trace.Trace, in time order."""
    done, cur = [], None
    kernels = sorted((e for e in trace.device if e.cat == "kernel"),
                     key=lambda e: e.ts)
    for e in kernels:
        stage = stage_of(e.name)
        if stage == "begin":
            cur = {"marks": {"begin": e}, "a_end": None, "counts": [0, 0]}
        elif cur is None:
            continue
        elif stage is not None:
            want = STAGES[len(cur["marks"])]
            if stage != want or (stage == "sky" and cur["a_end"] is None):
                cur = None
                continue
            cur["marks"][stage] = e
            if stage == "sky":
                done.append(Frame(cur["marks"], cur["a_end"],
                                  *cur["counts"]))
                cur = None
        elif KERNEL_A in e.name:
            if "packs" not in cur["marks"]:
                cur = None
            else:
                cur["a_end"] = e.ts + e.dur
        elif len(cur["marks"]) < 3:
            cur["counts"][len(cur["marks"]) - 1] += 1
    return done


def end(e) -> float:
    return e.ts + e.dur


def mean_ms(values) -> float | None:
    """The mean of µs values, in ms; None where there are none."""
    values = list(values)
    return sum(values) / len(values) / 1e3 if values else None


def mean(values) -> float | None:
    values = list(values)
    return sum(values) / len(values) if values else None
