"""The plain reference of the viewer: what a frame and the state after a run
of inputs should be, worked out again from the same inputs the program is
given (the start, the packed actions, the frame size and the sky's size).

Frozen copies of the port's plain code (raytracing_cuda_tpu_torch: the
scene builder, the state step, the `oracle` raytracer and plain FXAA) and
the procedural sky written from its formulas; plain PyTorch, importing
nothing of the program. `dtype` is float32 for the reference and bfloat16
for its control.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import state as sim
from rtbench.reference.builders import build_scene
from rtbench.reference.fxaa import fxaa_torch
from rtbench.reference.math3d import true_div
from rtbench.reference.oracle import render_base_image
from rtbench.reference.sky import ProceduralSky
from rtbench.reference.structs import Scene

# pixels per chunk of the plain raytracer: large, so that the host launches
# few ops per frame; its (chunk, objects, 3) intermediates take a few GB
CHUNK = 262144


def start_state(hour: float, cam_preset: int, antialiasing: bool,
                dtype=torch.float32) -> sim.FrameState:
    """The state a run starts from, on the host: the initial globals at
    `hour` with the FXAA toggle, camera preset `cam_preset` pressed (keys
    5/6, with dt 0), settled."""
    st = sim.init_state(dtype=dtype)
    st = st._replace(day_time=sim._t(hour, None, dtype),
                     aa=torch.tensor(bool(antialiasing)))
    av = torch.zeros(16, dtype=dtype)
    av[sim.A_TIME_PRESET] = -1
    av[sim.A_CAM_PRESET] = cam_preset
    return sim.settle(sim.apply_controls_packed(st, av))


def replay(state: sim.FrameState, vecs: np.ndarray, keep=()):
    """Step `state` through the packed (N, 16) actions on the host → (the
    state after the last, {i: the state after action i for i in keep})."""
    av_all = torch.from_numpy(np.ascontiguousarray(vecs, np.float32)).to(
        state.day_time.dtype)
    keep, kept = set(keep), {}
    for i in range(len(av_all)):
        state = sim.animate_packed(state, av_all[i])
        if i in keep:
            kept[i] = state
    return state, kept


def state_cast(state: sim.FrameState, dtype) -> sim.FrameState:
    """The state with its float fields in `dtype`."""
    return sim.state_from_tensors([
        t.to(dtype) if t.is_floating_point() else t
        for t in sim.state_tensors(state)])


def scene_on(device, dtype=torch.float32) -> Scene:
    """The island scene on `device`, its float fields in `dtype`."""
    return Scene(*(t.to(device=device, dtype=dtype) if t.is_floating_point()
                   else t.to(device) for t in build_scene()))


def render(scene: Scene, state: sim.FrameState, sky: ProceduralSky,
           height: int, width: int, chunk: int = CHUNK) -> torch.Tensor:
    """The frame the viewer shows for `state` → (height, width, 3) uint8
    on the scene's device: the plain raytracer over the procedural sky,
    then FXAA where the state's toggle is on."""
    device = scene.color.device
    state = sim.state_to(state, device)
    scene_f, lights, ambient = sim.derive_frame(scene, state)
    rays = sim.camera_rays(state.cam, width / height)
    day_frac = true_div(state.day_time, 24.0)
    base = render_base_image(
        scene_f, lights, ambient,
        lambda d: sky.lookup(d, day_frac, state.sky_vars), rays, height,
        width, chunk=chunk)
    return fxaa_torch(base, scene.color.dtype) if bool(state.aa) else base
