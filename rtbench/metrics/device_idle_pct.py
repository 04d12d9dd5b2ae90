"""The device: the share of the card's time in which it had nothing
enqueued, the host being behind. Read from the CUDA events the harness
records around each frame of a traced run before its profiler slice
(run["device_frames"], run.FrameEvents): the gaps from a frame's end to
the next frame's start, over the first start to the last end. The
profiler's slice is not read: a trace slows every graph launch after it
begins, and the slice idles by that alone."""


def read(trace, run):
    d = run.get("device_frames")
    if not d or d["span_ms"] <= 0:
        return None
    return 100.0 * d["idle_ms"] / d["span_ms"]
