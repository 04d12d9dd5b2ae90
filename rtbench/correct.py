"""What decides `correct`: the frames the window handed to the host and the
state after its last frame, held against the plain reference
(rtbench/reference/) worked out again from the same start and actions.

Numbers compared, each against its limit in the configuration file
(`limits`):

- frame_rmse: the largest RMSE, on the 0..1 scale, of a checked frame
  against the reference's frame of the same state;
- frame_px_off_pct: the largest share, in %, of a checked frame's pixels
  with a channel more than 2 levels off the reference's;
- state_gap: the widest gap of a float field of the final state (camera
  position, yaw, pitch, fov, clock, sea level, both sky weight vectors),
  relative to the reference's value or 1, whichever is larger; the yaw and
  the clock are compared around their circles (360, 24);
- state_flags_apart: the final state's booleans (clock playing, FXAA) that
  differ from the reference's; an exact comparison, limit 0.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from rtbench import reference as ref
from rtbench.reference.sky import ProceduralSky

PERIODS = {"hor_angle": 360.0, "day_time": 24.0}
LEVELS_OFF = 2
NAMES = ("frame_rmse", "frame_px_off_pct", "state_gap", "state_flags_apart")


def state_numbers(state) -> dict:
    """A FrameState (the program's or the reference's) → {field: float, or
    list of floats, or bool} on the host."""
    cam = state.cam
    fields = {"pos": cam.pos, "hor_angle": cam.hor_angle,
              "ver_angle": cam.ver_angle, "fov": cam.fov,
              "day_time": state.day_time, "sea_y": state.sea_y,
              "sky_vars": state.sky_vars,
              "recolor_vars": state.recolor_vars,
              "play": state.play, "aa": state.aa}
    out = {}
    for k, t in fields.items():
        t = t.detach().cpu()
        out[k] = (bool(t) if t.dtype == torch.bool
                  else t.to(torch.float64).tolist())
    return out


def reference_states(render: dict, start, vecs: np.ndarray, frames,
                     dtype=torch.float32):
    """The reference's state after the run's last action and after each
    action whose index is in `frames`, stepped on the host in `dtype` from
    the start (generator.Start) → (final, {i: state})."""
    state0 = ref.start_state(start.hour, start.cam_preset,
                             render["antialiasing"], dtype)
    with torch.inference_mode():
        return ref.replay(state0, vecs, keep=frames)


def reference_frames(render: dict, kept: dict, device, dtype=torch.float32,
                     sky_shape=None, fxaa=True) -> dict:
    """The reference's frames {i: (H, W, 3) uint8} of the states `kept`,
    rendered on `device` in `dtype` (each state cast to it) over the
    configuration's sky, or one of `sky_shape`; `fxaa` False leaves FXAA
    out whatever the state's toggle (a control, not the reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, w = render["height"], render["width"]
    with torch.inference_mode():
        scene = ref.scene_on(device, dtype)
        sky = ProceduralSky(*(sky_shape or render["procedural_sky_shape"]),
                            device, dtype)
        out = {}
        for i in sorted(kept):
            st = ref.state_cast(kept[i], dtype)
            if not fxaa:
                st = st._replace(aa=torch.tensor(False))
            out[i] = ref.render(scene, st, sky, h, w).cpu().numpy()
    return out


def reference_outputs(render: dict, start, vecs: np.ndarray, frames,
                      device, dtype=torch.float32, states=None):
    """The reference's final state (state_numbers) and its frames
    {i: (H, W, 3) uint8} for the frame indices in `frames`, from the start
    (generator.Start), the packed actions of the run and the
    configuration's `render` settings, all in `dtype`. The state steps on
    the host; the frames render on `device`. `states`, where given,
    receives the state of each frame (state_numbers)."""
    t0 = time.perf_counter()
    final, kept = reference_states(render, start, vecs, frames, dtype)
    t1 = time.perf_counter()
    imgs = reference_frames(render, kept, device, dtype)
    if states is not None:
        states.update({i: state_numbers(kept[i]) for i in kept})
    print(f"reference ({dtype}): {len(vecs)} steps {t1 - t0:.3f} s, "
          f"{len(imgs)} frames {time.perf_counter() - t1:.3f} s",
          file=sys.stderr, flush=True)
    return state_numbers(final), imgs


def frame_gaps(img: np.ndarray, want: np.ndarray):
    """(RMSE on the 0..1 scale, % of pixels with a channel more than
    LEVELS_OFF levels off) of frame img against want."""
    d = np.abs(img.astype(np.int16) - want.astype(np.int16))
    rmse = float(np.sqrt(np.mean((d / 255.0) ** 2)))
    return rmse, 100.0 * float(np.mean(d.max(-1) > LEVELS_OFF))


def state_gaps(got: dict, want: dict):
    """(the widest relative gap of the float fields, the booleans apart)."""
    gap, apart = 0.0, 0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, bool):
            apart += int(g != w)
            continue
        for a, b in zip(np.atleast_1d(g), np.atleast_1d(w)):
            d = abs(a - b)
            if k in PERIODS:
                d = min(d, PERIODS[k] - d)
            rel = float(d / max(1.0, abs(b)))
            gap = float("inf") if np.isnan(rel) else max(gap, rel)
    return gap, apart


def compare(got_state: dict, got_frames: dict, want_state: dict,
            want_frames: dict) -> dict:
    """The numbers compared: the program's (or a control's) final state
    and frames against the reference's. A frame the reference rendered and
    the program did not hand back reads as entirely off."""
    rmse, off = 0.0, 0.0
    for i, want in want_frames.items():
        got = got_frames.get(i)
        r, o = (1.0, 100.0) if got is None else frame_gaps(got, want)
        rmse, off = max(rmse, r), max(off, o)
    gap, apart = state_gaps(got_state, want_state)
    return {"frame_rmse": rmse, "frame_px_off_pct": off, "state_gap": gap,
            "state_flags_apart": apart}


def judge(readings: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): correct where every number is
    within its limit (a NaN is not)."""
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in NAMES}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
