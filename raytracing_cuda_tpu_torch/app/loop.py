"""Frame loop / engine facade (port of the single-device core of
raytracing_cuda_tpu/app/loop.py).

The Engine owns the scene, the static sky stack and the frame state.
`step_and_frame` is the interactive loop's frame, split as the reference
splits it (scene.cpp:806-816, kernel.cu:406-462):

1. the state machine steps on the host (CPU float32 tensors);
2. the host derives the frame's scene and rays and packs the coefficient
   table and params vector (~25 KB for the island);
3. one copy moves them into device buffers allocated once;
4. the device runs the megakernel, the sky lookup + quantize, and FXAA.

The device is always explicit: Engine(config, device="cuda") runs the CUDA
kernels, device="cpu" their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from raytracing_cuda_tpu_torch.core.types import Camera
from raytracing_cuda_tpu_torch.render.fxaa import apply_fxaa
from raytracing_cuda_tpu_torch.render.pipeline import _base, host_packs
from raytracing_cuda_tpu_torch.scene.builders import (CLASSIC_CAMERA,
                                                      SPH_CLUSTERS,
                                                      TRI_CLUSTERS, TRI_SUBS,
                                                      build_named_scene)
from raytracing_cuda_tpu_torch.scene.textures import load_skies, pack_sky_all
from raytracing_cuda_tpu_torch.sim import state as sim
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.timing import (FrameStats, FrameTimer,
                                                    device_sync)


class Engine:
    """Scene + static sky stack + frame state, rendering on one device."""

    def __init__(self, config: RenderConfig, device):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') but CUDA is unavailable")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.scene = build_named_scene(config.scene)
        texels = load_skies(config.sky_source,
                            config.procedural_sky_shape).texels
        self.sky_h, self.sky_w = texels.shape[1:3]
        self.sky_pack = pack_sky_all(torch.from_numpy(texels).to(self.device))
        state = sim.init_state()._replace(
            aa=torch.tensor(bool(config.antialiasing)))
        if config.scene == "classic":
            cc = CLASSIC_CAMERA
            state = state._replace(cam=Camera(
                pos=torch.tensor(cc["pos"], dtype=torch.float32),
                hor_angle=torch.tensor(cc["hor_angle"], dtype=torch.float32),
                ver_angle=torch.tensor(cc["ver_angle"], dtype=torch.float32),
                fov=torch.tensor(cc["fov"], dtype=torch.float32)))
        self.state = sim.settle(state)
        self.tri_clusters = TRI_CLUSTERS.get(config.scene)
        self.sph_clusters = SPH_CLUSTERS.get(config.scene)
        self.tri_subs = TRI_SUBS.get(config.scene)

        # per-frame upload buffers, allocated once: the device buffer the
        # kernels read, and (on CUDA) a pinned host staging buffer whose
        # copy-done event gates the next frame's host write
        coef, params, _, _ = self._packs()
        self._coef_shape = tuple(coef.shape)
        self._n_coef = coef.numel()
        n = coef.numel() + params.numel()
        self._dev_buf = torch.empty(n, dtype=torch.float32, device=self.device)
        if self.device.type == "cuda":
            self._host_buf = torch.empty(n, dtype=torch.float32,
                                         pin_memory=True)
            self._copied = torch.cuda.Event()

    # --- state ---

    def step(self, action: Action | None = None, dt: float = 1 / 60):
        """Advance the host state machine one frame."""
        self.state = sim.animate(self.state, action or Action.idle(), dt)
        return self.state

    def set_state(self, state: sim.FrameState):
        self.state = state

    # --- rendering ---

    def _packs(self):
        c = self.config
        return host_packs(self.scene, self.state, c.height, c.width, c.aspect,
                          self.tri_clusters, self.sph_clusters, self.tri_subs)

    def _upload(self, coef, params):
        """Host packs → views of the device buffer (one copy on CUDA)."""
        n = self._n_coef
        if self.device.type == "cpu":
            self._dev_buf[:n] = coef.reshape(-1)
            self._dev_buf[n:] = params
        else:
            self._copied.synchronize()     # the previous copy has read it
            self._host_buf[:n] = coef.reshape(-1)
            self._host_buf[n:] = params
            self._dev_buf.copy_(self._host_buf, non_blocking=True)
            self._copied.record()
        return self._dev_buf[:n].view(self._coef_shape), self._dev_buf[n:]

    def frame(self) -> torch.Tensor:
        """Render the current state → (H, W, 3) uint8 on the engine device."""
        c = self.config
        coef, params, n_tri, n_sph = self._packs()
        coef_d, params_d = self._upload(coef, params)
        base = _base(coef_d, params_d, n_tri, n_sph, self.sky_pack,
                     self.sky_h, self.sky_w, self.state, c.height, c.width)
        return apply_fxaa(base, bool(self.state.aa))

    def step_and_frame(self, action: Action | None = None,
                       dt: float = 1 / 60) -> torch.Tensor:
        """Step the state machine, then render the new state."""
        self.step(action, dt)
        return self.frame()

    def frame_np(self) -> np.ndarray:
        return self.frame().cpu().numpy()

    # --- drivers ---

    def run(self, n_frames: int,
            action_fn: Callable[[int], Action] | None = None,
            dt: float = 1 / 60, warmup: int = 2,
            on_frame: Callable[[int, torch.Tensor], None] | None = None
            ) -> FrameStats:
        """Headless loop: step + render n_frames (idle input by default),
        after `warmup` untimed frames from the same starting state."""
        state0 = self.state
        for _ in range(warmup):
            self.step_and_frame(None, dt)
        device_sync(self.device)
        self.state = state0
        c = self.config
        timer = FrameTimer(c.width, c.height, self.device).start()
        for i in range(n_frames):
            img = self.step_and_frame(action_fn(i) if action_fn else None, dt)
            if on_frame is not None:
                on_frame(i, img)
            timer.tick()
        return timer.stop()
