"""Frame state and its step functions.

Port of raytracing_cuda_tpu/sim/state.py.

The reference's per-frame host pipeline (animate, scene.cpp:806-816):
moveCamera → controls → recolorObjects → calcSkyVars → moveLights. As in the
source, it runs on the host: FrameState holds float32 CPU tensors, Actions
are host values, and each step is a handful of scalar tensor ops written in
the JAX package's operation order so both produce the same floats.

Ordering quirk preserved: recolorObjects runs before calcSkyVars
(scene.cpp:806-816), so object colors blend with the previous frame's sky
weights. FrameState carries both `sky_vars` (current, drives sky sampling)
and `recolor_vars` (one frame older, drives palette blending).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracing_cuda_tpu_torch.core.math3d import rot_y, rot_z, to_rad
from raytracing_cuda_tpu_torch.core.types import (Camera, CameraRays, Lights,
                                                  Scene)
from raytracing_cuda_tpu_torch.scene import palettes
from raytracing_cuda_tpu_torch.sim.actions import Action

f32 = torch.float32

# control-rate constants (scene.cpp:14-32)
MOVE_SPEED = 50.0
CAM_VIEW_DELTA = 0.02
CAM_VIEW_LIMIT = 44.0
RUN_SPEED_UP = 2.0
SEA_SPEED = 2.0
DAY_NIGHT_SPEED = 0.5
DAY_NIGHT_DISTANCE = 500.0
DAY_NIGHT_CONTROL_SPEED = 4.0

TIME_PRESETS = np.array([6.0, 14.0, 18.0, 1.0], np.float32)  # scene.cpp:713-728
CAM_PRESETS_POS = np.array([[-56, 2.2, 72], [324.4, 12.41, -84]], np.float32)
CAM_PRESETS_HOR = np.array([309.0, 141.2], np.float32)
CAM_PRESETS_VER = np.array([-7.07, -12.65], np.float32)


def _t(x) -> torch.Tensor:
    """Host float32 scalar or array tensor."""
    return torch.tensor(np.asarray(x, np.float32))


class FrameState(NamedTuple):
    """Everything scene.cpp keeps in file-static globals."""

    cam: Camera
    day_time: torch.Tensor      # 0..24 h clock
    play: torch.Tensor          # bool: automatic time advance
    sea_y: torch.Tensor         # sea plane height (objects[0].pos.y)
    aa: torch.Tensor            # bool: FXAA enabled
    sky_vars: torch.Tensor      # (4,) current blend weights (sky sampling)
    recolor_vars: torch.Tensor  # (4,) previous frame's weights (recolor)


def init_camera() -> Camera:
    """initCamera (scene.cpp:165-173)."""
    return Camera(pos=_t([-56, 2.2, 72]), hor_angle=_t(309.0),
                  ver_angle=_t(-7.07), fov=_t(40.0))


def init_state() -> FrameState:
    """Initial globals (scene.cpp:23-37, 448)."""
    return FrameState(cam=init_camera(), day_time=_t(6.0),
                      play=torch.tensor(True), sea_y=_t(-4.5),
                      aa=torch.tensor(True), sky_vars=_t([0, 0, 0, 1]),
                      recolor_vars=_t([0, 0, 0, 1]))


def calc_sky_vars(d) -> torch.Tensor:
    """calcSkyVars (scene.cpp:778-804): piecewise 4-way day/night crossfade.

    Pure bands morning 6-8 / day 10-16 / evening 18-20 / night 22-4 with
    2 h linear fades between them. Returns (4,) weights summing to 1.
    """
    d = torch.as_tensor(d, dtype=f32)
    one, zero = torch.ones((), dtype=f32), torch.zeros((), dtype=f32)
    w = torch.where
    morning = w((d >= 6) & (d <= 8), one, zero)
    day = w((d >= 10) & (d <= 16), one, zero)
    evening = w((d >= 18) & (d <= 20), one, zero)
    night = w((d >= 22) | (d <= 4), one, zero)

    fade = (d - 8.0) / 2.0
    day = w((d > 8) & (d < 10), fade, day)
    morning = w((d > 8) & (d < 10), 1.0 - fade, morning)

    fade = (d - 16.0) / 2.0
    evening = w((d > 16) & (d < 18), fade, evening)
    day = w((d > 16) & (d < 18), 1.0 - fade, day)

    fade = (d - 20.0) / 2.0
    night = w((d > 20) & (d < 22), fade, night)
    evening = w((d > 20) & (d < 22), 1.0 - fade, evening)

    fade = (d - 4.0) / 2.0
    morning = w((d > 4) & (d < 6), fade, morning)
    night = w((d > 4) & (d < 6), 1.0 - fade, night)
    return torch.stack([morning, day, evening, night])


def get_color_by_time(mats, sky_vars) -> torch.Tensor:
    """getColorByTime (scene.cpp:666-672): (4,3) palette x (4,) weights."""
    return (torch.from_numpy(np.asarray(mats, np.float32))
            * sky_vars[:, None]).sum(0)


def move_lights(day_time) -> Lights:
    """moveLights (scene.cpp:758-776): sun/moon orbit + intensity.

    Sun orbits a tilted circle of radius 500 (angle = day-fraction*360 - 120,
    tilted rotY(-45), offset (-500, 0, 500)); the moon is antipodal. Both
    lights share color {1,1,1} * |sun.y|/500.
    """
    a = to_rad(torch.fmod((day_time / 24.0) * 360.0 - 120.0, 360.0))
    base = torch.stack([torch.cos(a), torch.sin(a),
                        torch.zeros_like(a)]) * DAY_NIGHT_DISTANCE
    sun = rot_y(base, to_rad(_t(-45.0)))
    offset = _t([-500.0, 0.0, 500.0])
    pos = torch.stack([sun + offset, -sun + offset])
    val = torch.abs(pos[0, 1]) / DAY_NIGHT_DISTANCE
    color = (torch.ones(3, dtype=f32) * val).expand(2, 3).contiguous()
    return Lights(pos=pos, color=color, intensity=torch.ones(2, dtype=f32))


def camera_rays(cam: Camera, aspect) -> CameraRays:
    """cameraHelperAngles (scene.cpp:100-126): frustum corner directions.

    Corners start as {1, ±h, ±w} (forward = +x), pitched with rotZ(-ver)
    then yawed with rotY(-hor). h = tan(fov/2), w = h * aspect.
    """
    h = torch.tan(to_rad(cam.fov / 2.0))
    w = h * float(np.float32(aspect))
    one = torch.ones_like(h)
    corners = torch.stack([
        torch.stack([one, -h, -w]),  # LD
        torch.stack([one, -h, w]),   # RD
        torch.stack([one, h, -w]),   # LU
        torch.stack([one, h, w]),    # RU
    ])
    corners = rot_y(rot_z(corners, to_rad(-cam.ver_angle)),
                    to_rad(-cam.hor_angle))
    return CameraRays(pos=cam.pos, LD=corners[0], RD=corners[1],
                      LU=corners[2], RU=corners[3])


def update_camera(cam: Camera, action: Action, dt) -> Camera:
    """mouseMotion (scene.cpp:128-140) + moveCamera (scene.cpp:142-163)."""
    hor = torch.fmod(cam.hor_angle + CAM_VIEW_DELTA * _t(action.mouse_dx)
                     + 360.0, 360.0)
    ver = torch.clamp(cam.ver_angle + CAM_VIEW_DELTA * _t(action.mouse_dy),
                      -CAM_VIEW_LIMIT, CAM_VIEW_LIMIT)

    # WASD/QE translation in the yaw plane
    dir_rad = to_rad(hor)
    forward = torch.stack([torch.cos(dir_rad), torch.zeros_like(dir_rad),
                           torch.sin(dir_rad)])
    side = torch.stack([-forward[2], torch.zeros_like(dir_rad), forward[0]])
    up = _t([0.0, 1.0, 0.0])
    move = (side * _t(action.move_side) + forward * _t(action.move_forward)
            + up * _t(action.move_up))
    pos = cam.pos
    if action.move_side != 0 or action.move_forward != 0 or action.move_up != 0:
        sq = move * move
        move = move / torch.sqrt(sq[0] + sq[1] + sq[2])
        speed = MOVE_SPEED * (RUN_SPEED_UP if action.run else 1.0)
        pos = pos + move * speed * _t(dt)
    return cam._replace(pos=pos, hor_angle=hor, ver_angle=ver)


def apply_controls(state: FrameState, action: Action, dt) -> FrameState:
    """controls (scene.cpp:689-756): time scrub, play/pause, sea level,
    time/camera presets, FXAA toggle."""
    dt = _t(dt)
    day_time = state.day_time
    if action.time_control != 0:       # manual scrub overrides auto advance
        tc = _t(action.time_control)
        day_time = torch.fmod(day_time + DAY_NIGHT_SPEED * dt * tc
                              * DAY_NIGHT_CONTROL_SPEED + 24.0, 24.0)
    elif bool(state.play):
        day_time = torch.fmod(day_time + DAY_NIGHT_SPEED * dt + 24.0, 24.0)

    # play/pause: P sets true, then O sets false (O wins if both held)
    play = state.play
    if action.set_play:
        play = torch.tensor(True)
    if action.set_pause:
        play = torch.tensor(False)

    sea_y = state.sea_y + _t(action.sea_control) * SEA_SPEED * dt

    if action.time_preset >= 0:                     # keys 1-4
        day_time = _t(TIME_PRESETS[min(int(action.time_preset), 3)])

    cam = state.cam
    if action.cam_preset >= 0:                      # keys 5-6
        cp = min(int(action.cam_preset), 1)
        cam = cam._replace(pos=_t(CAM_PRESETS_POS[cp]),
                           hor_angle=_t(CAM_PRESETS_HOR[cp]),
                           ver_angle=_t(CAM_PRESETS_VER[cp]))

    # FXAA: B enables, then V disables (V wins if both held)
    aa = state.aa
    if action.set_aa_on:
        aa = torch.tensor(True)
    if action.set_aa_off:
        aa = torch.tensor(False)
    return state._replace(cam=cam, day_time=day_time, play=play, sea_y=sea_y,
                          aa=aa)


def animate(state: FrameState, action: Action, dt) -> FrameState:
    """One host-state step in the reference's order (scene.cpp:806-816).

    mouse+moveCamera → controls → (recolor uses the pre-update sky_vars, so
    it is snapshotted into recolor_vars) → calcSkyVars. moveLights is
    stateless and runs in derive_frame at render time.
    """
    cam = update_camera(state.cam, action, dt)
    state = apply_controls(state._replace(cam=cam), action, dt)
    return state._replace(recolor_vars=state.sky_vars,
                          sky_vars=calc_sky_vars(state.day_time))


def settle(state: FrameState) -> FrameState:
    """Make a hand-built state self-consistent (sky_vars match day_time)."""
    sv = calc_sky_vars(state.day_time)
    return state._replace(sky_vars=sv, recolor_vars=sv)


def derive_frame(scene: Scene, state: FrameState):
    """Per-frame scene derivation: recolorObjects (scene.cpp:674-687) + sea
    level (scene.cpp:708-709) + moveLights proxy spheres (scene.cpp:770-771).

    Returns (scene', lights, ambient).
    """
    rv = state.recolor_vars
    tree_c = get_color_by_time(palettes.MAT_TREE, rv)
    mount_c = get_color_by_time(palettes.MAT_MOUNT, rv)
    lake_c = get_color_by_time(palettes.MAT_LAKE, rv)
    ambient = get_color_by_time(palettes.MAT_AMBIENT, rv)

    color = torch.where(scene.tree_mask[:, None], tree_c, scene.color)
    color = torch.where(scene.mount_mask[:, None], mount_c, color)
    color[0] = lake_c

    lights = move_lights(state.day_time)

    # sun/moon proxy spheres are the last two spheres (globals 131, 132)
    sph_pos = scene.sph_pos.clone()
    sph_pos[-2:] = lights.pos
    center = scene.center.clone()
    center[-2:] = lights.pos
    plane_pos = scene.plane_pos.clone()
    plane_pos[1] = state.sea_y
    scene = scene._replace(color=color, sph_pos=sph_pos, center=center,
                           plane_pos=plane_pos)
    return scene, lights, ambient


def format_time(day_time: float) -> str:
    """getTime / HH:MM formatting (scene.cpp:731-733)."""
    d = float(day_time)
    return "%02d:%02d" % (int(d), int((int(d * 100) % 100) / 100.0 * 60))
