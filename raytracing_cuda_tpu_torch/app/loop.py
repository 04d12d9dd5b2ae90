"""Frame loop / engine facade (port of the single-device core of
raytracing_cuda_tpu/app/loop.py).

The Engine owns the scene, the static sky stack, the scene's cull table
and the frame state, all on its device from construction. `step_and_frame`
is the interactive loop's frame, on that device as the JAX Engine's one
jitted dispatch (loop.py:211-217): the state machine steps on the packed
action vector (sim.animate_packed), the frame's scene and rays are derived
and packed into the coefficient table and params vector, then the
megakernel, the sky lookup + quantize, and FXAA selected by the state's
toggle. The one host-to-device copy per frame is the (16,) action vector
(K of them for a batch), from pinned memory on a card.

On a card, on the single-device static-sky megakernel path (path "auto",
sky_cache=True, no mesh), `step_and_frame`, `step_and_frame_batch` (one
graph per K) and `step_and_frame_preview` replay a CUDA graph of that
device step: its first call runs the step eagerly (the warm-up, which also
builds and loads the kernels), the second captures the same code and every
call from then on replays it. The graph reads the state from buffers of
its own and writes the new state back into them; `Engine.state` hands out
a snapshot (a copy made when it is read), and each frame returned is a
copy of the graph's output, so no later call overwrites it. A failed
capture raises: there is no eager fallback on the card. A replay adds to
each kernel wrapper's launch counter the launches its capture recorded.

`step_and_frame_batch` renders K frames with one launch of each kernel
(render/pipeline.py `batch_packs` / `frames_from_packs`); `run(batch=K)`
and the CLI's `record` drive it.

config.path "fast" and "oracle" render with the plain PyTorch raytracers
instead (render/fast.py, render/reference.py) from the sky blended per
frame, and config.sky_cache=False renders the megakernel path through the
one-shot `render_frame`; a batch is then a loop of single frames, as the
JAX package scans them (loop.py:219-230). These paths, and the sharded
Engine, run the same device step eagerly, with no graph.
`step_and_frame_preview` renders at full size and box-downsamples on the
device for the window's readback.

The device is always explicit: Engine(config, device="cuda") runs the CUDA
kernels, device="cpu" their plain PyTorch versions through the same eager
code. Engine(..., sharded=True) renders every frame in row bands over all
devices of that type, or over an explicit device list (parallel/mesh.py);
`render_script_dp` renders a scripted animation with its frames, or frames
and rows, spread over devices (parallel/frames.py).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from raytracing_cuda_tpu_torch.core.math3d import true_div
from raytracing_cuda_tpu_torch.core.types import Camera, to_device
from raytracing_cuda_tpu_torch.parallel import frames as pframes
from raytracing_cuda_tpu_torch.parallel.mesh import (as_device, as_mesh,
                                                     band_rows, devices,
                                                     make_mesh, render_bands,
                                                     render_bands_plain)
from raytracing_cuda_tpu_torch.render.cuda_rt import (cull_groups, cull_table,
                                                      pack_scene,
                                                      raytrace_planes,
                                                      raytrace_planes_batch)
from raytracing_cuda_tpu_torch.render.fxaa import (apply_fxaa, fxaa,
                                                   fxaa_batch, fxaa_ext)
from raytracing_cuda_tpu_torch.render.pipeline import (_base, batch_packs,
                                                       frame_packs,
                                                       frames_from_packs,
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


def initial_state(config: RenderConfig, device="cpu") -> sim.FrameState:
    """The state an Engine of `config` starts from, on `device`: the
    reference's globals with the config's FXAA toggle, at the classic
    scene's camera pose where that scene is chosen, settled."""
    state = sim.init_state()._replace(
        aa=torch.tensor(bool(config.antialiasing)))
    if config.scene == "classic":
        cc = CLASSIC_CAMERA
        state = state._replace(cam=Camera(
            pos=torch.tensor(cc["pos"], dtype=torch.float32),
            hor_angle=torch.tensor(cc["hor_angle"], dtype=torch.float32),
            ver_angle=torch.tensor(cc["ver_angle"], dtype=torch.float32),
            fov=torch.tensor(cc["fov"], dtype=torch.float32)))
    return sim.settle(sim.state_to(state, device))


def _launch_counters() -> list:
    """(wrapper, attribute) of every kernel launch counter a frame moves."""
    return [(raytrace_planes, "launches"),
            (raytrace_planes_batch, "launches"),
            (raytrace_planes_batch, "frames"), (fxaa, "launches"),
            (fxaa_batch, "launches"), (fxaa_batch, "frames"),
            (fxaa_ext, "launches"), (fxaa_ext, "frames")]


class _Graph(NamedTuple):
    """One captured device step: the graph, its static action input
    (K, 16), its output (frames), and the launch counts one replay adds."""

    graph: object
    actions: torch.Tensor
    out: torch.Tensor
    counts: tuple


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
        self.tri_clusters = TRI_CLUSTERS.get(config.scene)
        self.sph_clusters = SPH_CLUSTERS.get(config.scene)
        self.tri_subs = TRI_SUBS.get(config.scene)
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
            self.scene, self.cull, state = src.scene, src.cull, src.state
            self.sky_pack, self.sky_texels = src.sky_pack, src.sky_texels
            self.sky_h, self.sky_w = src.sky_h, src.sky_w
        else:
            self.scene = to_device(build_named_scene(config.scene),
                                   self.device)
            # kernel A's cull table depends only on the scene's layout:
            # built once, on the device
            self.cull = cull_table(
                pack_scene(self.scene, self.tri_clusters, self.sph_clusters),
                cull_groups(self.scene.n_triangles, self.scene.n_spheres,
                            self.tri_clusters, self.sph_clusters,
                            self.tri_subs))
            texels = load_skies(config.sky_source, config.sky_downsample,
                                config.procedural_sky_shape).texels
            self.sky_h, self.sky_w = texels.shape[1:3]
            texels = torch.from_numpy(texels).to(self.device)
            self.sky_pack = pack_sky_all(texels) if static else None
            self.sky_texels = None if static else texels
            state = initial_state(config, self.device)
        # the step's constant tables, copied to the device here: a CUDA
        # graph cannot capture a copy from pageable host memory
        sim.device_constants(self.device)
        # the static sky stack on each device that renders, copied to a
        # device once, at its first use
        self._sky_packs = dict(getattr(src, "_sky_packs", {}))
        if static:
            self._sky_packs[self.sky_pack.device] = self.sky_pack
            self._sky_packs_for(self.mesh or [])
        # the state: a snapshot handed out (None while only the graphs'
        # buffers hold it), the graphs' state buffers, and whether those
        # hold the current state
        self._state = None
        self._live = None
        self._live_current = False
        self.state = state
        # CUDA graphs of the device step by (kind, K), and the keys whose
        # first, eager call has run
        self._graphs: dict = {}
        self._warm: set = set()

    @property
    def state(self) -> sim.FrameState:
        """The current state on the engine device: a snapshot, which no
        later step writes into."""
        if self._state is None:
            self._state = sim.clone_state(self._live)
        return self._state

    @state.setter
    def state(self, state: sim.FrameState):
        self._state = sim.state_to(state, self.device)
        self._live_current = False

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

    def _upload(self, vecs, out=None) -> torch.Tensor:
        """(K, 16) packed actions → a float32 tensor on the engine device
        (`out`, where given): the frame's one host-to-device copy, from
        pinned memory on a card (the caching host allocator keeps the
        buffer until the copy has read it, so the host never waits)."""
        t = (vecs.to(torch.float32) if isinstance(vecs, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(vecs, np.float32)))
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        if out is not None:
            return out.copy_(t, non_blocking=True)
        return t.to(self.device, non_blocking=True)

    def step(self, action: Action | None = None, dt: float = 1 / 60):
        """Advance the state machine one frame on the engine device."""
        av = self._upload((action or Action.idle()).pack(dt)[None])[0]
        self.state = sim.animate_packed(self.state, av)
        return self.state

    def fast_forward(self, action_vecs, dt: float = 1 / 30):
        """Advance the state machine past a batch of actions without
        rendering (record --resume). action_vecs: packed (K, 16) vectors or
        a list of Actions (packed with dt). The device step, once per
        vector, so the result is exactly that of stepping frame by
        frame."""
        dts = ([dt] * len(action_vecs)
               if isinstance(action_vecs, (list, tuple)) else None)
        vecs = pack_actions(action_vecs, dts)
        if len(vecs):
            st = self.state
            for av in self._upload(vecs):
                st = sim.animate_packed(st, av)
            self.state = st
        return self.state

    def set_state(self, state: sim.FrameState):
        """Make `state` the current state (moved to the engine device)."""
        self.state = state

    def time_string(self) -> str:
        """The clock as HH:MM (reads the state back to the host)."""
        return sim.format_time(float(self.state.day_time))

    def resized(self, width: int, height: int) -> "Engine":
        """An Engine at another framebuffer size sharing this one's scene,
        sky stack and state (the reference's reshape, main.cpp:293-306)."""
        cfg = dataclasses.replace(self.config, width=width, height=height)
        return Engine(cfg, self.device, sharded=self.sharded,
                      share_assets_from=self)

    # --- rendering ---

    def _packs(self, state=None):
        """The packs of `state` (default: the current one) on the engine
        device, with the engine's cull table."""
        c = self.config
        return frame_packs(self.scene, self.state if state is None else state,
                           c.height, c.width, c.aspect, self.tri_clusters,
                           self.sph_clusters, self.tri_subs, self.cull)

    def _bands(self, coefs, params, n_tri: int, n_sph: int, states):
        """K frames in row bands over the engine's mesh → (K, H, W, 3)
        uint8 on the engine device."""
        c = self.config
        return render_bands(coefs, params, n_tri, n_sph, states,
                            self._sky_packs, self.sky_h, self.sky_w,
                            mesh=self.mesh, height=c.height, width=c.width,
                            interleave=c.shard_interleave,
                            cull=self.cull).to(self.device)

    def _frame_blended(self) -> torch.Tensor:
        """The current state's frame from the sky blended per frame: the
        'fast' and 'oracle' paths (in row bands when sharded) and the
        one-shot megakernel frame of sky_cache=False."""
        c = self.config
        if self.mesh is not None:
            return render_bands_plain(
                self.scene, self.state, self.sky_texels, mesh=self.mesh,
                height=c.height, width=c.width, chunk=c.chunk,
                aspect=c.aspect, aa=self.state.aa,
                interleave=c.shard_interleave).to(self.device)
        return render_frame(self.scene, self.state, self.sky_texels, c.height,
                            c.width, chunk=c.chunk, aspect=c.aspect,
                            path=self.path, tri_clusters=self.tri_clusters,
                            sph_clusters=self.sph_clusters,
                            t_subs=self.tri_subs)

    def _render_static(self, state) -> torch.Tensor:
        """The frame of `state` on the single-device static-sky path."""
        c = self.config
        coef, params, n_tri, n_sph, _ = self._packs(state)
        base = _base(coef, params, n_tri, n_sph, self.sky_pack, self.sky_h,
                     self.sky_w, state, c.height, c.width, self.cull)
        return apply_fxaa(base, state.aa)

    def frame(self) -> torch.Tensor:
        """Render the current state → (H, W, 3) uint8 on the engine device."""
        if self.sky_pack is None:
            return self._frame_blended()
        if self.mesh is not None:
            coef, params, n_tri, n_sph, _ = self._packs()
            return self._bands(coef[None], params[None], n_tri, n_sph,
                               [self.state])[0]
        return self._render_static(self.state)

    def _step_render(self, kind: str, state, avs):
        """The device step of one call on the static single-device path:
        from `state`, on packed actions avs (K, 16) on the engine device →
        (the new state, the output). kind "frame": one frame; "preview":
        one frame box-downsampled by config.preview; "batch": K frames,
        each kernel launched once. What the CUDA graphs capture."""
        if kind == "batch":
            c = self.config
            coefs, params, n_tri, n_sph, _, states = batch_packs(
                self.scene, state, avs, c.height, c.width, c.aspect,
                self.tri_clusters, self.sph_clusters, self.tri_subs,
                self.cull)
            return states[-1], frames_from_packs(
                coefs, params, n_tri, n_sph, self.sky_pack, self.sky_h,
                self.sky_w, states, c.height, c.width, self.cull)
        state = sim.animate_packed(state, avs[0])
        img = self._render_static(state)
        if kind == "preview":
            img = _box_downsample(img, self.config.preview)
        return state, img

    def _load_live(self):
        """Make the graphs' state buffers hold the current state."""
        if self._live is None:
            self._live = sim.clone_state(self.state)
        elif not self._live_current:
            for dst, src in zip(sim.state_tensors(self._live),
                                sim.state_tensors(self._state)):
                dst.copy_(src)
        self._live_current = True

    def _capture(self, kind: str, k: int) -> _Graph:
        """A CUDA graph of _step_render(kind) from the graphs' state
        buffers on a static (k, 16) action buffer, which writes the new
        state back into those buffers. Raises where the capture fails."""
        actions = torch.zeros((k, 16), dtype=torch.float32,
                              device=self.device)
        live = sim.state_tensors(self._live)
        counters = _launch_counters()
        before = [getattr(fn, attr) for fn, attr in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                new, out = self._step_render(kind, self._live, actions)
                new = sim.state_tensors(new)
                # a new field may be an input buffer itself (recolor_vars
                # is the old sky_vars): copy those before any is written
                shared = {t.data_ptr() for t in live}
                new = [t.clone() if t.data_ptr() in shared else t
                       for t in new]
                for dst, src in zip(live, new):
                    dst.copy_(src)
        finally:
            # the capture recorded the launches, it ran none
            after = [getattr(fn, attr) for fn, attr in counters]
            for (fn, attr), n in zip(counters, before):
                setattr(fn, attr, n)
        return _Graph(graph, actions, out,
                      tuple(a - b for a, b in zip(after, before)))

    def _run_static(self, kind: str, vecs):
        """One call of the device step on the static single-device path,
        from the current state on packed actions vecs (K, 16) → the output,
        which no later call overwrites. On a card: the first call of each
        (kind, K) eagerly, the second captures a CUDA graph, and from then
        on each call replays it."""
        key = (kind, len(vecs))
        if self.device.type != "cuda" or key not in self._warm:
            self._warm.add(key)
            self.state, out = self._step_render(kind, self.state,
                                                self._upload(vecs))
            return out
        with torch.cuda.device(self.device):
            self._load_live()
            g = self._graphs.get(key)
            if g is None:
                g = self._graphs[key] = self._capture(kind, len(vecs))
            self._upload(vecs, out=g.actions)
            g.graph.replay()
            for (fn, attr), n in zip(_launch_counters(), g.counts):
                setattr(fn, attr, getattr(fn, attr) + n)
            self._state = None           # the graphs' buffers hold it
            return g.out.clone()

    def step_and_frame(self, action: Action | None = None,
                       dt: float = 1 / 60) -> torch.Tensor:
        """Step the state machine, then render the new state."""
        if self.sky_pack is not None and self.mesh is None:
            return self._run_static(
                "frame", (action or Action.idle()).pack(dt)[None])
        self.step(action, dt)
        return self.frame()

    def step_and_frame_preview(self, action: Action | None = None,
                               dt: float = 1 / 60) -> torch.Tensor:
        """Step, render at full size, box-downsample on the device →
        (H/p, W/p, 3) uint8 on the engine device (p = config.preview): a
        full-size render with a small readback."""
        if self.sky_pack is not None and self.mesh is None:
            return self._run_static(
                "preview", (action or Action.idle()).pack(dt)[None])
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
        vecs = pack_actions(actions, dts)
        if len(vecs) < 1:
            raise ValueError("a batch needs at least one frame")
        if self.sky_pack is None:
            imgs = []
            for av in self._upload(vecs):
                self.state = sim.animate_packed(self.state, av)
                imgs.append(self.frame())
            return torch.stack(imgs)
        if self.mesh is None:
            return self._run_static("batch", vecs)
        c = self.config
        coefs, params, n_tri, n_sph, _, states = batch_packs(
            self.scene, self.state, self._upload(vecs), c.height, c.width,
            c.aspect, self.tri_clusters, self.sph_clusters, self.tri_subs,
            self.cull)
        imgs = self._bands(coefs, params, n_tri, n_sph, states)
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
