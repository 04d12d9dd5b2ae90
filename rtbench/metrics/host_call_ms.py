"""Engine call on the host (app/loop.py `Engine._call`: the action's upload
from pinned memory and the graph launch): the median host milliseconds of
a `step_and_frame` call, over the traced run's calls before the profiler
starts (a trace slows every later graph launch)."""

import statistics


def read(trace, run):
    calls = run["host_call_ms"]
    return statistics.median(calls) if calls else None
