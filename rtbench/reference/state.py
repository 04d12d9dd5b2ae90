"""Frame state and its step (a frozen copy of
raytracing_cuda_tpu_torch/sim/state.py, the reference's per-frame host
pipeline, animate, scene.cpp:806-816: moveCamera → controls →
recolorObjects → calcSkyVars → moveLights).

FrameState holds tensors of one float dtype (float32 for the reference,
bfloat16 for its control) and one frame's input is the packed (16,) action
vector (slot 14 is dt). Every branch is a `torch.where`.

Ordering quirk preserved: recolorObjects runs before calcSkyVars
(scene.cpp:806-816), so object colors blend with the previous frame's sky
weights. FrameState carries both `sky_vars` (current, drives sky sampling)
and `recolor_vars` (one frame older, drives palette blending).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rtbench.reference.math3d import (rot_y, rot_z, to_rad,
                                                   true_div)
from rtbench.reference.structs import Camera, CameraRays, Lights, Scene
from rtbench.reference import palettes

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

# the packed action vector's slots (slot 14 is dt)
(A_SIDE, A_FORWARD, A_UP, A_RUN, A_MDX, A_MDY, A_TIME, A_PLAY, A_PAUSE,
 A_SEA, A_TIME_PRESET, A_CAM_PRESET, A_AA_ON, A_AA_OFF, A_DT) = range(15)


def _t(x, device=None, dtype=f32) -> torch.Tensor:
    """A scalar or array tensor of `dtype` on `device` (the host by
    default), rounded through float32."""
    return torch.tensor(np.asarray(x, np.float32), device=device).to(dtype)


_CONSTS: dict = {}


def device_constants(device, dtype=f32) -> dict:
    """The step's constant tables of `dtype` on `device`, made once."""
    device = torch.device(device)
    c = _CONSTS.get((device, dtype))
    if c is None:
        c = _CONSTS[(device, dtype)] = {
            "time_presets": _t(TIME_PRESETS, device, dtype),
            "cam_pos": _t(CAM_PRESETS_POS, device, dtype),
            "cam_hor": _t(CAM_PRESETS_HOR, device, dtype),
            "cam_ver": _t(CAM_PRESETS_VER, device, dtype),
            "up": _t([0.0, 1.0, 0.0], device, dtype),
            "light_tilt": _t(-45.0, device, dtype),
            "light_offset": _t([-500.0, 0.0, 500.0], device, dtype),
            **{name: _t(getattr(palettes, name), device, dtype)
               for name in ("MAT_TREE", "MAT_MOUNT", "MAT_LAKE",
                            "MAT_AMBIENT")}}
    return c


class FrameState(NamedTuple):
    """Everything scene.cpp keeps in file-static globals."""

    cam: Camera
    day_time: torch.Tensor      # 0..24 h clock
    play: torch.Tensor          # bool: automatic time advance
    sea_y: torch.Tensor         # sea plane height (objects[0].pos.y)
    aa: torch.Tensor            # bool: FXAA enabled
    sky_vars: torch.Tensor      # (4,) current blend weights (sky sampling)
    recolor_vars: torch.Tensor  # (4,) previous frame's weights (recolor)


def state_tensors(state: FrameState) -> tuple:
    """The state's tensors in a fixed order, the camera's first."""
    return (*state.cam, *state[1:])


def state_from_tensors(tensors) -> FrameState:
    """The inverse of state_tensors."""
    n = len(Camera._fields)
    return FrameState(Camera(*tensors[:n]), *tensors[n:])


def state_to(state: FrameState, device) -> FrameState:
    """The state on `device`: the state itself where every field is there
    already, else a copy."""
    device = torch.device(device)
    ts = state_tensors(state)
    if all(t.device == device for t in ts):
        return state
    return state_from_tensors([t.to(device) for t in ts])


def init_camera(device=None, dtype=f32) -> Camera:
    """initCamera (scene.cpp:165-173)."""
    return Camera(pos=_t([-56, 2.2, 72], device, dtype),
                  hor_angle=_t(309.0, device, dtype),
                  ver_angle=_t(-7.07, device, dtype),
                  fov=_t(40.0, device, dtype))


def init_state(device=None, dtype=f32) -> FrameState:
    """Initial globals (scene.cpp:23-37, 448) on `device` (the host by
    default)."""
    return FrameState(cam=init_camera(device, dtype),
                      day_time=_t(6.0, device, dtype),
                      play=torch.tensor(True, device=device),
                      sea_y=_t(-4.5, device, dtype),
                      aa=torch.tensor(True, device=device),
                      sky_vars=_t([0, 0, 0, 1], device, dtype),
                      recolor_vars=_t([0, 0, 0, 1], device, dtype))


def calc_sky_vars(d) -> torch.Tensor:
    """calcSkyVars (scene.cpp:778-804): piecewise 4-way day/night crossfade.

    Pure bands morning 6-8 / day 10-16 / evening 18-20 / night 22-4 with
    2 h linear fades between them. Returns (4,) weights summing to 1, on
    the device of d.
    """
    d = torch.as_tensor(d)
    one, zero = torch.ones_like(d), torch.zeros_like(d)
    w = torch.where
    morning = w((d >= 6) & (d <= 8), one, zero)
    day = w((d >= 10) & (d <= 16), one, zero)
    evening = w((d >= 18) & (d <= 20), one, zero)
    night = w((d >= 22) | (d <= 4), one, zero)

    fade = true_div(d - 8.0, 2.0)
    day = w((d > 8) & (d < 10), fade, day)
    morning = w((d > 8) & (d < 10), 1.0 - fade, morning)

    fade = true_div(d - 16.0, 2.0)
    evening = w((d > 16) & (d < 18), fade, evening)
    day = w((d > 16) & (d < 18), 1.0 - fade, day)

    fade = true_div(d - 20.0, 2.0)
    night = w((d > 20) & (d < 22), fade, night)
    evening = w((d > 20) & (d < 22), 1.0 - fade, evening)

    fade = true_div(d - 4.0, 2.0)
    morning = w((d > 4) & (d < 6), fade, morning)
    night = w((d > 4) & (d < 6), 1.0 - fade, night)
    return torch.stack([morning, day, evening, night])


def get_color_by_time(mats: torch.Tensor, sky_vars) -> torch.Tensor:
    """getColorByTime (scene.cpp:666-672): (4,3) palette x (4,) weights,
    on their device. The four terms are added left to right as explicit
    adds, the order of the host's sum, which a device reduction need not
    keep."""
    p = mats * sky_vars[:, None]
    return ((p[0] + p[1]) + p[2]) + p[3]


def move_lights(day_time) -> Lights:
    """moveLights (scene.cpp:758-776): sun/moon orbit + intensity.

    Sun orbits a tilted circle of radius 500 (angle = day-fraction*360 - 120,
    tilted rotY(-45), offset (-500, 0, 500)); the moon is antipodal. Both
    lights share color {1,1,1} * |sun.y|/500. On the device of day_time.
    """
    c = device_constants(day_time.device, day_time.dtype)
    a = to_rad(torch.fmod(true_div(day_time, 24.0) * 360.0 - 120.0, 360.0))
    base = torch.stack([torch.cos(a), torch.sin(a),
                        torch.zeros_like(a)]) * DAY_NIGHT_DISTANCE
    sun = rot_y(base, to_rad(c["light_tilt"]))
    offset = c["light_offset"]
    pos = torch.stack([sun + offset, -sun + offset])
    val = true_div(torch.abs(pos[0, 1]), DAY_NIGHT_DISTANCE)
    color = (torch.ones(3, dtype=a.dtype, device=a.device) * val).expand(
        2, 3).contiguous()
    return Lights(pos=pos, color=color,
                  intensity=torch.ones(2, dtype=a.dtype, device=a.device))


def camera_rays(cam: Camera, aspect) -> CameraRays:
    """cameraHelperAngles (scene.cpp:100-126): frustum corner directions.

    Corners start as {1, ±h, ±w} (forward = +x), pitched with rotZ(-ver)
    then yawed with rotY(-hor). h = tan(fov/2), w = h * aspect.
    """
    h = torch.tan(to_rad(true_div(cam.fov, 2.0)))
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


def update_camera_packed(cam: Camera, av: torch.Tensor) -> Camera:
    """mouseMotion (scene.cpp:128-140) + moveCamera (scene.cpp:142-163) on
    a packed action vector, on its device."""
    c = device_constants(av.device, av.dtype)
    dt = av[A_DT]
    hor = torch.fmod(cam.hor_angle + CAM_VIEW_DELTA * av[A_MDX] + 360.0,
                     360.0)
    ver = torch.clamp(cam.ver_angle + CAM_VIEW_DELTA * av[A_MDY],
                      -CAM_VIEW_LIMIT, CAM_VIEW_LIMIT)

    # WASD/QE translation in the yaw plane
    dir_rad = to_rad(hor)
    forward = torch.stack([torch.cos(dir_rad), torch.zeros_like(dir_rad),
                           torch.sin(dir_rad)])
    side = torch.stack([-forward[2], torch.zeros_like(dir_rad), forward[0]])
    move = side * av[A_SIDE] + forward * av[A_FORWARD] + c["up"] * av[A_UP]
    moving = (av[A_SIDE] != 0) | (av[A_FORWARD] != 0) | (av[A_UP] != 0)
    sq = move * move
    norm = torch.sqrt(sq[0] + sq[1] + sq[2])
    move = move / torch.where(moving, norm, torch.ones_like(norm))
    run = (av[A_RUN] > 0).to(av.dtype)
    speed = MOVE_SPEED * (1.0 + run * (RUN_SPEED_UP - 1.0))   # 50 or 100
    pos = torch.where(moving, cam.pos + move * speed * dt, cam.pos)
    return cam._replace(pos=pos, hor_angle=hor, ver_angle=ver)


def apply_controls_packed(state: FrameState, av: torch.Tensor) -> FrameState:
    """controls (scene.cpp:689-756) on a packed action vector: time scrub,
    play/pause, sea level, time/camera presets, FXAA toggle."""
    c = device_constants(av.device, av.dtype)
    dt = av[A_DT]
    tc = av[A_TIME]
    # time: a manual scrub overrides the automatic advance
    scrub = torch.fmod(state.day_time + DAY_NIGHT_SPEED * dt * tc
                       * DAY_NIGHT_CONTROL_SPEED + 24.0, 24.0)
    auto = torch.fmod(state.day_time + DAY_NIGHT_SPEED * dt + 24.0, 24.0)
    day_time = torch.where(tc != 0, scrub,
                           torch.where(state.play, auto, state.day_time))

    # play/pause: P sets true, then O sets false (O wins if both held)
    play = (state.play | (av[A_PLAY] > 0)) & ~(av[A_PAUSE] > 0)

    sea_y = state.sea_y + av[A_SEA] * SEA_SPEED * dt

    # time presets (keys 1-4), by clamped index
    tp = av[A_TIME_PRESET]
    tpi = torch.clamp(tp, 0, 3).to(torch.int64).reshape(1)
    day_time = torch.where(tp >= 0, c["time_presets"].index_select(0, tpi)[0],
                           day_time)

    # camera presets (keys 5-6)
    cp = av[A_CAM_PRESET]
    has_cp = cp >= 0
    cpi = torch.clamp(cp, 0, 1).to(torch.int64).reshape(1)
    cam = state.cam
    cam = cam._replace(
        pos=torch.where(has_cp, c["cam_pos"].index_select(0, cpi)[0],
                        cam.pos),
        hor_angle=torch.where(has_cp, c["cam_hor"].index_select(0, cpi)[0],
                              cam.hor_angle),
        ver_angle=torch.where(has_cp, c["cam_ver"].index_select(0, cpi)[0],
                              cam.ver_angle))

    # FXAA: B enables, then V disables (V wins if both held)
    aa = (state.aa | (av[A_AA_ON] > 0)) & ~(av[A_AA_OFF] > 0)
    return state._replace(cam=cam, day_time=day_time, play=play, sea_y=sea_y,
                          aa=aa)


def animate_packed(state: FrameState, av: torch.Tensor) -> FrameState:
    """One state step in the reference's order (scene.cpp:806-816) on a
    packed (16,) action vector on the state's device.

    mouse+moveCamera → controls → (recolor uses the pre-update sky_vars, so
    it is snapshotted into recolor_vars) → calcSkyVars. moveLights is
    stateless and runs in derive_frame at render time.
    """
    cam = update_camera_packed(state.cam, av)
    state = apply_controls_packed(state._replace(cam=cam), av)
    return state._replace(recolor_vars=state.sky_vars,
                          sky_vars=calc_sky_vars(state.day_time))


def settle(state: FrameState) -> FrameState:
    """Make a hand-built state self-consistent (sky_vars match day_time)."""
    sv = calc_sky_vars(state.day_time)
    return state._replace(sky_vars=sv, recolor_vars=sv)


def derive_frame(scene: Scene, state: FrameState):
    """Per-frame scene derivation: recolorObjects (scene.cpp:674-687) + sea
    level (scene.cpp:708-709) + moveLights proxy spheres (scene.cpp:770-771),
    on the scene's device.

    Returns (scene', lights, ambient).
    """
    c = device_constants(scene.color.device, scene.color.dtype)
    rv = state.recolor_vars
    tree_c = get_color_by_time(c["MAT_TREE"], rv)
    mount_c = get_color_by_time(c["MAT_MOUNT"], rv)
    lake_c = get_color_by_time(c["MAT_LAKE"], rv)
    ambient = get_color_by_time(c["MAT_AMBIENT"], rv)

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
