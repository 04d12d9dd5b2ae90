"""The readings that the limits of `correct` are set from, for one cell, in
one process on the card (set-up once):

- the program's: for each of --seeds, one window of the cell's driver as a
  run drives it (the seeded flight, or the seeded record job), its frames
  and final state against the float32 reference (the lower readings);
- the controls': for each of --control-seeds, each of CONTROLS put in the
  program's place for the same window's inputs, against the float32
  reference, and judged by the cell's limits (the upper readings):
  `bf16`, the reference computed in bfloat16 (the state stepped and the
  frames rendered); `bf16_render`, the float32 states rendered in
  bfloat16; `no_fxaa`, the float32 frames with FXAA left out while the
  state's toggle is on (kernel B skipped); `half_sky`, the float32 frames
  over panoramas of half the configured height and width (the port's
  default 2048x4096 against the configured 4096x8192).

    python3 rtbench/calibrate.py --workload island_720p.fly \
        --seconds 10 --seeds 11 12 13 --control-seeds 11 12 13

--mesh overrides a record cell's cards (a rehearsal of a 4-card cell on
one card: --mesh cuda:0 cuda:0 cuda:0 cuda:0).

One JSON line per seed on standard output. The benchmark's own runs do not
run the control.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rtbench import correct, run  # noqa: E402


BINS = (0, 1, 2, 3, 11, 51, 256)
CONTROLS = ("bf16", "bf16_render", "no_fxaa", "half_sky")


def control_outputs(name: str, render: dict, start, vecs, frames, device,
                    want_state: dict, kept: dict):
    """Control `name`'s (final state, {i: frame}) for a window: the state
    and the float32 states `kept` of the reference where the control
    leaves the step alone."""
    if name == "bf16":
        return correct.reference_outputs(render, start, vecs, frames, device,
                                         torch.bfloat16)
    if name == "bf16_render":
        return want_state, correct.reference_frames(render, kept, device,
                                                    torch.bfloat16)
    if name == "no_fxaa":
        return want_state, correct.reference_frames(render, kept, device,
                                                    fxaa=False)
    if name == "half_sky":
        h, w = render["procedural_sky_shape"]
        return want_state, correct.reference_frames(
            render, kept, device, sky_shape=(h // 2, w // 2))
    raise ValueError(f"unknown control {name!r}")


def detail(got, want, state) -> dict:
    """One checked frame against the reference's: its two readings, how
    many pixels part by how many levels (the largest channel's gap, in the
    bins [0], [1], [2], [3, 10], [11, 50], [51, 255]), and the frame's clock
    and sky weights."""
    rmse, off = correct.frame_gaps(got, want)
    gap = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(-1)
    return {"rmse": rmse, "px_off_pct": off,
            "pixels_by_gap": np.histogram(gap, BINS)[0].tolist(),
            "day_time": state["day_time"], "sky_vars": state["sky_vars"],
            "aa": state["aa"], "pos": state["pos"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", nargs="+", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        run.log("calibrate needs a CUDA card")
        return 2
    torch.set_num_threads(4)
    cell = run.Cell(args.workload)
    sut = run.build(cell, args.device, args.mesh, T_START)
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        result, rec = run.drive(cell, sut, seed, args.seconds, False, t0)
        frames = run.handed_back(rec)
        final, kept = correct.reference_states(cell.render, rec["start"],
                                               rec["vecs"], set(frames))
        want_state = correct.state_numbers(final)
        want_frames = correct.reference_frames(cell.render, kept,
                                               args.device)
        line = {"seed": seed, "frames": rec["frames"],
                "checked": sorted(frames), "metrics": result["metrics"]}
        if seed in args.seeds:
            line["program"] = correct.compare(rec["state"], frames,
                                              want_state, want_frames)
            line["per_frame"] = {
                i: detail(frames[i], want_frames[i],
                          correct.state_numbers(kept[i]))
                for i in sorted(frames)}
        if seed in args.control_seeds:
            line["controls"] = {}
            for name in CONTROLS:
                got = control_outputs(name, cell.render, rec["start"],
                                      rec["vecs"], set(frames), args.device,
                                      want_state, kept)
                readings = correct.compare(*got, want_state, want_frames)
                ok, _ = correct.judge(readings, cell.limits)
                line["controls"][name] = {"readings": readings,
                                          "correct": ok}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
