"""The whole frame (`Engine.step_and_frame`, or one frame of a record
batch): the frame function's least time (rtbench/counts/frame.py) as a
share of the time per frame of the run["chips"] cards it renders on (1
where absent), idle included, over the frames of a traced run that the
harness times by CUDA events before its profiler slice
(run["device_frames"]): the slice's own wall time is stretched by the
profiler. It bounds what the kernels' rooflines can claim, even where a
later change takes a kernel off the path."""

from rtbench.counts import frame


def read(trace, run):
    d = run.get("device_frames")
    if not d or d["span_ms"] <= 0:
        return None
    least = frame.count(run["width"], run["height"],
                        run["objects"]).seconds()
    per_frame = d["span_ms"] / 1e3 / d["frames"]
    return 100.0 * least / (run.get("chips", 1) * per_frame)
