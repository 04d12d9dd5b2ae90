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

`step_and_frame_batch` does the same for K frames with one copy and one
launch of each kernel (render/pipeline.py `batch_packs` /
`frames_from_packs`); `run(batch=K)` and the CLI's `record` drive it.

config.path "fast" and "oracle" render with the plain PyTorch raytracers
instead (render/fast.py, render/reference.py) from the sky blended per
frame, and config.sky_cache=False renders the megakernel path through the
one-shot `render_frame`; a batch is then a loop of single frames, as the
JAX package scans them (loop.py:219-230). `step_and_frame_preview` renders
at full size and box-downsamples on the device for the window's readback.

The device is always explicit: Engine(config, device="cuda") runs the CUDA
kernels, device="cpu" their plain PyTorch versions. Engine(...,
sharded=True) renders every frame in row bands over all devices of that
type, or over an explicit device list (parallel/mesh.py);
`render_script_dp` renders a scripted animation with its frames, or frames
and rows, spread over devices (parallel/frames.py).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from raytracing_cuda_tpu_torch.core.math3d import true_div
from raytracing_cuda_tpu_torch.core.types import Camera
from raytracing_cuda_tpu_torch.parallel import frames as pframes
from raytracing_cuda_tpu_torch.parallel.mesh import (as_device, as_mesh,
                                                     band_rows, devices,
                                                     make_mesh, render_bands,
                                                     render_bands_plain)
from raytracing_cuda_tpu_torch.render.fxaa import apply_fxaa
from raytracing_cuda_tpu_torch.render.pipeline import (_base, batch_packs,
                                                       frames_from_packs,
                                                       host_packs,
                                                       pack_actions,
                                                       render_frame)
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


def _box_downsample(img: torch.Tensor, n: int) -> torch.Tensor:
    """(H, W, 3) uint8 → (H/n, W/n, 3) uint8 box mean on the device of
    `img` (the preview readback): the device twin of
    utils.images.box_downsample, float32 mean, + 0.5, truncate. The n x n
    sum of 8-bit values is exact in float32, and it is divided truly (a
    CUDA mean multiplies by a rounded 1/n²), so host and device agree bit
    for bit."""
    if n == 1:
        return img
    H, W = img.shape[0], img.shape[1]
    boxes = img.to(torch.float32).reshape(H // n, n, W // n, n, 3)
    return (true_div(boxes.sum(dim=(1, 3)), float(n * n)) + 0.5).to(
        torch.uint8)


def initial_state(config: RenderConfig) -> sim.FrameState:
    """The state an Engine of `config` starts from: the reference's
    globals with the config's FXAA toggle, at the classic scene's camera
    pose where that scene is chosen, settled."""
    state = sim.init_state()._replace(
        aa=torch.tensor(bool(config.antialiasing)))
    if config.scene == "classic":
        cc = CLASSIC_CAMERA
        state = state._replace(cam=Camera(
            pos=torch.tensor(cc["pos"], dtype=torch.float32),
            hor_angle=torch.tensor(cc["hor_angle"], dtype=torch.float32),
            ver_angle=torch.tensor(cc["ver_angle"], dtype=torch.float32),
            fov=torch.tensor(cc["fov"], dtype=torch.float32)))
    return sim.settle(state)


class Engine:
    """Scene + sky + frame state, rendering on one device or, sharded, in
    row bands over several."""

    def __init__(self, config: RenderConfig, device, sharded=False,
                 share_assets_from: "Engine | None" = None):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') but CUDA is unavailable")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.device = as_device(self.device)
        self.sharded = sharded
        self.mesh = self._row_mesh(sharded)
        self.path = config.path
        # what the path reads of the sky: the megakernel path looks up the
        # static int32 stack (always when sharded, as the JAX package);
        # 'fast', 'oracle' and sky_cache=False blend the uint8 texels per
        # frame. Only what is read goes to the device.
        static = self.path == "auto" and (config.sky_cache
                                          or self.mesh is not None)
        src = share_assets_from
        if src is not None:
            # the resize path (main.cpp:293-306): same scene, sky and state
            if (src.device, src.config.scene, src.config.sky_source,
                    src.config.sky_downsample,
                    src.config.procedural_sky_shape,
                    src.sky_pack is not None) != (
                    self.device, config.scene, config.sky_source,
                    config.sky_downsample, config.procedural_sky_shape,
                    static):
                raise ValueError("share_assets_from needs the same device, "
                                 "scene, sky and sky form")
            self.scene, self.state = src.scene, src.state
            self.sky_pack, self.sky_texels = src.sky_pack, src.sky_texels
            self.sky_h, self.sky_w = src.sky_h, src.sky_w
        else:
            self.scene = build_named_scene(config.scene)
            texels = load_skies(config.sky_source, config.sky_downsample,
                                config.procedural_sky_shape).texels
            self.sky_h, self.sky_w = texels.shape[1:3]
            texels = torch.from_numpy(texels).to(self.device)
            self.sky_pack = pack_sky_all(texels) if static else None
            self.sky_texels = None if static else texels
            self.state = initial_state(config)
        # the static sky stack on each device that renders, copied to a
        # device once, at its first use
        self._sky_packs = dict(getattr(src, "_sky_packs", {}))
        if static:
            self._sky_packs[self.sky_pack.device] = self.sky_pack
            self._sky_packs_for(self.mesh or [])
        self.tri_clusters = TRI_CLUSTERS.get(config.scene)
        self.sph_clusters = SPH_CLUSTERS.get(config.scene)
        self.tri_subs = TRI_SUBS.get(config.scene)
        # the packs' last cull table for kernel A, on the host and on the
        # engine device (copied again only when the packs' table changes)
        self._cull = (None, None)
        # per-frame upload buffers, one set per batch size K, allocated at
        # its first use: the device buffer the kernels read and (on CUDA) a
        # pinned host staging buffer whose copy-done event gates the next
        # host write
        self._bufs: dict = {}

    def _row_mesh(self, sharded):
        """The row mesh of sharded (True: all devices of the engine's type;
        or a device list), or None when the frame is not split."""
        if sharded is False or sharded is None:
            return None
        mesh = (make_mesh(device_type=self.device.type) if sharded is True
                else as_mesh(sharded))
        if mesh[0].type != self.device.type:
            raise ValueError(f"a {self.device.type} engine cannot shard over "
                             f"{mesh[0].type} devices")
        interleave = self.config.shard_interleave
        if len(mesh) == 1:
            # one device: the single-device render, where striding does not
            # exist (loop.py:88-98)
            if interleave > 1:
                warnings.warn(
                    f"sharded over a single device: shard_interleave="
                    f"{interleave} has no effect (rendering single-device)",
                    stacklevel=3)
            return None
        band_rows(self.config.height, len(mesh), interleave)   # fail fast
        return mesh

    def _sky_packs_for(self, mesh) -> dict:
        for d in dict.fromkeys(mesh):
            if d.type != self.device.type:
                raise ValueError(f"a {self.device.type} engine cannot render "
                                 f"on {d}")
            if d not in self._sky_packs:
                self._sky_packs[d] = self.sky_pack.to(d)
        return self._sky_packs

    # --- state ---

    def step(self, action: Action | None = None, dt: float = 1 / 60):
        """Advance the host state machine one frame."""
        self.state = sim.animate(self.state, action or Action.idle(), dt)
        return self.state

    def fast_forward(self, action_vecs, dt: float = 1 / 30):
        """Advance the state machine past a batch of actions without
        rendering (record --resume). action_vecs: packed (K, 16) vectors or
        a list of Actions (packed with dt). A host loop, so the result is
        exactly that of stepping frame by frame."""
        dts = ([dt] * len(action_vecs)
               if isinstance(action_vecs, (list, tuple)) else None)
        for av in pack_actions(action_vecs, dts):
            self.state = sim.animate(self.state, Action.unpack(av),
                                     Action.unpack_dt(av))
        return self.state

    def set_state(self, state: sim.FrameState):
        self.state = state

    def time_string(self) -> str:
        return sim.format_time(float(self.state.day_time))

    def resized(self, width: int, height: int) -> "Engine":
        """An Engine at another framebuffer size sharing this one's scene,
        sky stack and state (the reference's reshape, main.cpp:293-306)."""
        cfg = dataclasses.replace(self.config, width=width, height=height)
        return Engine(cfg, self.device, sharded=self.sharded,
                      share_assets_from=self)

    # --- rendering ---

    def _packs(self):
        c = self.config
        return host_packs(self.scene, self.state, c.height, c.width, c.aspect,
                          self.tri_clusters, self.sph_clusters, self.tri_subs)

    def _upload(self, coefs, params):
        """K frames of host packs (K, n, C), (K, P) → views of the device
        buffer for K frames (one copy on CUDA)."""
        n = coefs.numel()
        bufs = self._bufs.get(coefs.shape[0])
        if bufs is None:
            size = n + params.numel()
            cuda = self.device.type == "cuda"
            bufs = self._bufs[coefs.shape[0]] = (
                torch.empty(size, dtype=torch.float32, device=self.device),
                torch.empty(size, dtype=torch.float32, pin_memory=True)
                if cuda else None,
                torch.cuda.Event() if cuda else None)
        dev_buf, host_buf, copied = bufs
        if host_buf is None:
            dev_buf[:n] = coefs.reshape(-1)
            dev_buf[n:] = params.reshape(-1)
        else:
            copied.synchronize()     # the previous copy has read it
            host_buf[:n] = coefs.reshape(-1)
            host_buf[n:] = params.reshape(-1)
            dev_buf.copy_(host_buf, non_blocking=True)
            copied.record()
        return dev_buf[:n].view(coefs.shape), dev_buf[n:].view(params.shape)

    def _cull_on_device(self, cull):
        """The packs' cull table on the engine device; a host-to-device
        copy only when it differs from the last one (a per-frame copy from
        pageable memory would wait for the stream)."""
        host, dev = self._cull
        if host is None or not torch.equal(host, cull):
            self._cull = host, dev = cull, cull.to(self.device)
        return dev

    def _bands(self, coefs, params, n_tri: int, n_sph: int, cull, states):
        """K frames in row bands over the engine's mesh → (K, H, W, 3)
        uint8 on the engine device."""
        c = self.config
        return render_bands(coefs, params, n_tri, n_sph, states,
                            self._sky_packs, self.sky_h, self.sky_w,
                            mesh=self.mesh, height=c.height, width=c.width,
                            interleave=c.shard_interleave,
                            cull=self._cull_on_device(cull)).to(self.device)

    def _frame_blended(self) -> torch.Tensor:
        """The current state's frame from the sky blended per frame: the
        'fast' and 'oracle' paths (in row bands when sharded) and the
        one-shot megakernel frame of sky_cache=False."""
        c = self.config
        if self.mesh is not None:
            return render_bands_plain(
                self.scene, self.state, self.sky_texels, mesh=self.mesh,
                height=c.height, width=c.width, chunk=c.chunk,
                aspect=c.aspect, aa=bool(self.state.aa),
                interleave=c.shard_interleave).to(self.device)
        return render_frame(self.scene, self.state, self.sky_texels, c.height,
                            c.width, chunk=c.chunk, aspect=c.aspect,
                            path=self.path, tri_clusters=self.tri_clusters,
                            sph_clusters=self.sph_clusters,
                            t_subs=self.tri_subs)

    def frame(self) -> torch.Tensor:
        """Render the current state → (H, W, 3) uint8 on the engine device."""
        if self.sky_pack is None:
            return self._frame_blended()
        c = self.config
        coef, params, n_tri, n_sph, cull = self._packs()
        if self.mesh is not None:
            return self._bands(coef[None], params[None], n_tri, n_sph, cull,
                               [self.state])[0]
        coef_d, params_d = self._upload(coef[None], params[None])
        base = _base(coef_d[0], params_d[0], n_tri, n_sph, self.sky_pack,
                     self.sky_h, self.sky_w, self.state, c.height, c.width,
                     self._cull_on_device(cull))
        return apply_fxaa(base, bool(self.state.aa))

    def step_and_frame(self, action: Action | None = None,
                       dt: float = 1 / 60) -> torch.Tensor:
        """Step the state machine, then render the new state."""
        self.step(action, dt)
        return self.frame()

    def step_and_frame_preview(self, action: Action | None = None,
                               dt: float = 1 / 60) -> torch.Tensor:
        """Step, render at full size, box-downsample on the device →
        (H/p, W/p, 3) uint8 on the engine device (p = config.preview): a
        full-size render with a small readback."""
        return _box_downsample(self.step_and_frame(action, dt),
                               self.config.preview)

    def step_and_frame_batch(self, actions, dts=None) -> torch.Tensor:
        """Step and render K frames → (K, H, W, 3) uint8 on the engine
        device, each kernel launched once for the batch (frame by frame
        where the sky is blended per frame). actions: a list of Actions
        (dts per frame, default 1/60 each) or packed (K, 16) vectors
        carrying their own dt. Frame k equals the k-th of K step_and_frame
        calls."""
        if isinstance(actions, (list, tuple)) and dts is None:
            dts = [1 / 60] * len(actions)
        if self.sky_pack is None:
            imgs = []
            for av in pack_actions(actions, dts):
                self.state = sim.animate(self.state, Action.unpack(av),
                                         Action.unpack_dt(av))
                imgs.append(self.frame())
            if not imgs:
                raise ValueError("a batch needs at least one frame")
            return torch.stack(imgs)
        c = self.config
        coefs, params, n_tri, n_sph, cull, states = batch_packs(
            self.scene, self.state, pack_actions(actions, dts), c.height,
            c.width, c.aspect, self.tri_clusters, self.sph_clusters,
            self.tri_subs)
        if self.mesh is not None:
            imgs = self._bands(coefs, params, n_tri, n_sph, cull, states)
        else:
            coefs_d, params_d = self._upload(coefs, params)
            imgs = frames_from_packs(coefs_d, params_d, n_tri, n_sph,
                                     self.sky_pack, self.sky_h, self.sky_w,
                                     states, c.height, c.width,
                                     self._cull_on_device(cull))
        self.state = states[-1]
        return imgs

    def render_script_dp(self, action_vecs, n_devices: int | None = None,
                         dt: float = 1 / 60, n_rows: int = 1, mesh=None):
        """Offline frame-parallel batch → (K, H, W, 3) uint8 on the engine
        device, equal to K step_and_frame calls; advances the state past
        all K frames (loop.py:317-373).

        The K frames spread over n_devices devices of the engine's type
        (all of them by default), K divisible by their count. n_rows > 1
        selects the (frames, rows) hybrid: n_devices frame groups (by
        default as many as fit) of n_rows row-sharded devices each, with
        the config's shard_interleave. mesh overrides the devices: a list
        (frame DP) or a list of n_frames lists of devices (hybrid). dt
        applies to a list of Actions; packed (K, 16) vectors carry their
        own dt."""
        if self.mesh is not None:
            raise ValueError("frame DP and row sharding are alternative "
                             "layouts; build the Engine with sharded=False "
                             "(n_rows>1 composes them on a 2-D mesh)")
        if self.sky_pack is None:
            raise ValueError("render_script_dp needs the megakernel "
                             "static-sky path (config path='auto', "
                             "sky_cache=True)")
        if isinstance(action_vecs, (list, tuple)):
            action_vecs = pack_actions(action_vecs, [dt] * len(action_vecs))
        c = self.config
        if mesh is None:
            kind = self.device.type
            if n_devices is None:
                n_devices = max(len(devices(None, kind, "frame DP"))
                                // n_rows, 1)
            mesh = pframes.make_hybrid_mesh(n_devices, n_rows, kind)
        # a flat list is frame DP: one device per frame group
        mesh = [as_mesh(g if isinstance(g, (list, tuple)) else [g])
                for g in mesh]
        imgs, self.state = pframes.render_script_hybrid(
            self.scene, self.state,
            self._sky_packs_for([d for g in mesh for d in g]), self.sky_h,
            self.sky_w, action_vecs, mesh=mesh, height=c.height,
            width=c.width, aspect=c.aspect,
            # one device per group: striding does not exist (as _row_mesh)
            interleave=c.shard_interleave if len(mesh[0]) > 1 else 1,
            tri_clusters=self.tri_clusters, sph_clusters=self.sph_clusters,
            t_subs=self.tri_subs)
        return imgs.to(self.device)

    def frame_np(self) -> np.ndarray:
        return self.frame().cpu().numpy()

    # --- drivers ---

    def run(self, n_frames: int,
            action_fn: Callable[[int], Action] | None = None,
            dt: float = 1 / 60, warmup: int = 2,
            on_frame: Callable[[int, torch.Tensor], None] | None = None,
            batch: int = 1) -> FrameStats:
        """Headless loop: step + render n_frames (idle input by default),
        after `warmup` untimed frames (or batches) from the same starting
        state.

        batch > 1 renders full batches of that many frames through
        step_and_frame_batch, then the remainder frame by frame; on_frame
        is then not available. In batch mode frame_ms holds one entry per
        batch, the batch's interval divided by its frame count (and one per
        remainder frame).
        """
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if batch > 1 and on_frame is not None:
            raise ValueError("on_frame needs batch=1: batches yield frames "
                             "per batch")
        state0 = self.state
        for _ in range(warmup):
            if batch > 1:
                self.step_and_frame_batch([Action.idle()] * batch,
                                          [dt] * batch)
            if batch == 1 or n_frames % batch:
                self.step_and_frame(None, dt)
        device_sync(self.device)
        self.state = state0

        def action(i):
            return action_fn(i) if action_fn else Action.idle()

        c = self.config
        timer = FrameTimer(c.width, c.height, self.device).start()
        done = 0
        if batch > 1:
            while done + batch <= n_frames:
                self.step_and_frame_batch(
                    [action(done + j) for j in range(batch)], [dt] * batch)
                timer.tick(batch)
                done += batch
        for i in range(done, n_frames):
            img = self.step_and_frame(action(i), dt)
            if on_frame is not None:
                on_frame(i, img)
            timer.tick()
        return timer.stop()
