"""Frame loop / engine facade (port of the single-device core of
raytracing_cuda_tpu/app/loop.py).

The Engine owns the scene, the static sky stack, the scene's cull table
and pack base (render/packs.py) and the frame state, all on its device
from construction. `step_and_frame` is the interactive loop's frame, on
that device as the JAX Engine's one jitted dispatch (loop.py:211-217): the
state machine steps on the packed action vector (sim.animate_packed), the
frame's coefficient table and params vector are packed (on a card one
launch of csrc/packs.cu over the pack base), then the megakernel, the
sky lookup + quantize, and FXAA selected by the state's toggle. The one
host-to-device copy per frame is the (16,) action vector (K of them for a
batch), from pinned memory on a card.

On a card every entry point runs as the JAX Engine's jitted programs do,
whatever config.path is, one device program per call: a CUDA graph of the
same device code. `step_and_frame`, `step_and_frame_batch`
(one graph per K) and `step_and_frame_preview` are the step + render
(the JAX `_step_render`, `_step_render_batch`, `_step_render_preview`);
`frame()` renders the current state without stepping (`_render_only`);
`step()` is the state step alone (`_animate`), and `fast_forward()` one
`step()` call per vector (where the JAX Engine scans 256 per dispatch,
`_ff_scan`; a 256-step graph costs a cold resume more to capture than it
saves). The first call of each kind and K runs eagerly (the warm-up,
which also builds and loads the kernels), the second captures the same
code and every call from then on replays it, each graph captured on a
stream of the card it runs on. The graphs read the state
from buffers of their own and write the new state back into them (a
render-only graph writes nothing); `Engine.state` hands out a snapshot
(a copy made when it is read), and each frame returned is a copy of the
graphs' output, so no later call overwrites it. A failed capture raises:
there is no eager fallback on the card. A replay adds to each kernel
wrapper's launch counter the launches its capture recorded.
`_frame_eager()` keeps the eager render the frame graphs are held
against.

While a torch.profiler session records (utils/profiling.py), each call is
a host span `engine.call` holding its upload, replay or eager run and
capture, all carrying the call's number (and a frame-DP call's gather onto
the Engine's device is the span `engine.gather`); and a single-device frame
call on the static sky stack (`step_and_frame`, `step_and_frame_preview`,
`frame()`) replays a second graph of the same step with four stage marks
in it (begin, step, packs, sky: empty kernels whose times split the
frame's device time in the trace), captured at the first such call in a
pool of its own. The graph replayed with the profiler off has no mark.

A sharded Engine (its step calls and its `frame()`, which renders without
stepping), and `render_script_dp`, run the JAX package's shard_map programs
the same way, one graph per mesh entry per call: every entry holds a
replica of the state on its device (the JAX package's replicated state,
in_specs=P()) beside that device's copy of the scene, cull table, pack base
and sky stack, uploads the action vectors itself, steps its replica and
renders its rows (parallel/mesh.py entry_bands, recomputing its halo rows
instead of exchanging them) or its block of frames (parallel/frames.py
script_entry, after scanning all K actions); no entry waits on another
within a call. The host then copies each entry's rows into the frame on the
Engine's device (parallel/mesh.py place_bands): n graph launches, n uploads
and n copies per call. The replicas stay equal because every entry steps
the same actions with the same code. On the CPU the same per-entry code
runs eagerly with the plain kernels.

`step_and_frame_batch` renders K frames with one launch of each kernel
(render/pipeline.py `batch_packs` / `frames_from_packs`); `run(batch=K)`
and the CLI's `record` drive it.

config.path "fast" and "oracle" render with the plain PyTorch raytracers
instead (render/fast.py, render/reference.py) from the sky blended per
frame, through the same graphs, sharded or not (a sharded entry renders
its rows with the fast renderer on both paths, parallel/mesh.py
entry_bands_plain, as the JAX package's shard_map program does). In the
graphs the `fast` renderer runs every bounce and shadow sweep masked,
where its eager form reads a flag back to the host at each early exit
(the JAX renderer decides them on the device with lax.cond); the pixels
are the same, and `_frame_eager()` keeps the host-decided form. Their
batch is K step_and_frame calls, K graph replays. config.sky_cache=False
renders the single-device megakernel path through the one-shot
`render_frame` (blend + pack per frame) inside the graphs; a batch is then
K single frames in one graph, as the JAX package scans them
(loop.py:219-230). A sharded Engine always renders from the static stack,
as the JAX package's (loop.py:129-131), so sky_cache=False does not change
it. `step_and_frame_preview` renders at full size and box-downsamples on
the device for the window's readback.

The device is always explicit: Engine(config, device="cuda") runs the CUDA
kernels, device="cpu" their plain PyTorch versions through the same eager
code. Engine(..., sharded=True) renders every frame in row bands over all
devices of that type, or over an explicit device list (parallel/mesh.py);
`render_script_dp` renders a scripted animation with its frames, or frames
and rows, spread over devices (parallel/frames.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from raytracing_cuda_tpu_torch.core.math3d import true_div
from raytracing_cuda_tpu_torch.core.types import Camera, to_device
from raytracing_cuda_tpu_torch.parallel import frames as pframes
from raytracing_cuda_tpu_torch.parallel.mesh import (as_device, as_mesh,
                                                     band_rows, devices,
                                                     entry_bands,
                                                     entry_bands_plain,
                                                     make_mesh, place_bands,
                                                     render_bands,
                                                     render_bands_plain)
from raytracing_cuda_tpu_torch.render.cuda_rt import (cull_table,
                                                      raytrace_planes,
                                                      raytrace_planes_batch)
from raytracing_cuda_tpu_torch.render.fxaa import (apply_fxaa, fxaa,
                                                   fxaa_batch, fxaa_ext)
from raytracing_cuda_tpu_torch.render.packs import (base_to, pack_base,
                                                    pack_frame)
from raytracing_cuda_tpu_torch.render.pipeline import (_base, batch_packs,
                                                       frame_packs,
                                                       frames_from_packs,
                                                       pack_actions,
                                                       render_frame,
                                                       stack_packs,
                                                       step_states)
from raytracing_cuda_tpu_torch.scene.builders import (CLASSIC_CAMERA,
                                                      SPH_CLUSTERS,
                                                      TRI_CLUSTERS, TRI_SUBS,
                                                      build_named_scene)
from raytracing_cuda_tpu_torch.scene.textures import load_skies, pack_sky_all
from raytracing_cuda_tpu_torch.sim import state as sim
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils import profiling
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
    return [(pack_frame, "launches"), (raytrace_planes, "launches"),
            (raytrace_planes_batch, "launches"),
            (raytrace_planes_batch, "frames"), (fxaa, "launches"),
            (fxaa_batch, "launches"), (fxaa_batch, "frames"),
            (fxaa_ext, "launches"), (fxaa_ext, "frames")]


class _Graph(NamedTuple):
    """One captured device step of one mesh entry: the graph, its static
    action input (K, 16) (None for a render-only graph), its output
    (frames, the entry's rows, or None for a state step alone), the launch
    counts one replay adds, the device memory the capture kept on the
    entry's device, (allocated, reserved) bytes: the graph's own memory
    pool, and the host seconds the capture and instantiation took."""

    graph: object
    actions: torch.Tensor
    out: torch.Tensor
    counts: tuple
    memory: tuple
    seconds: float


class _Replicas:
    """One state replica per entry of a mesh, each on its entry's device:
    the buffers the entries' steps read and write (made at their first
    call), whether they hold the Engine's current state, the CUDA graphs
    captured on them (by call key, one per entry), their variants with the
    stage marks (`traced`, replayed only while a profiler records) and the
    keys whose first, eager call has run."""

    def __init__(self, mesh):
        self.mesh = list(mesh)
        self.live: list | None = None
        self.current = False
        self.graphs: dict = {}
        self.traced: dict = {}
        self.warm: set = set()


# one capture stream per card, made at its first capture
_CAPTURE_STREAMS: dict = {}


def _capture_stream(device) -> torch.cuda.Stream:
    """The stream every graph captured on card `device` is captured on,
    made once per card on that card. torch.cuda.graph's own default is one
    stream made on the card current at the process's first capture, and a
    capture on a stream of another card than the one its work runs on
    fails at the first allocation."""
    device = as_device(device)
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        with torch.cuda.device(device):
            stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def _state_copy(state: sim.FrameState, device) -> sim.FrameState:
    """A copy of `state` on `device` that shares no tensor with it."""
    moved = sim.state_to(state, device)
    return sim.clone_state(moved) if moved is state else moved


def _write_state(live: sim.FrameState, new: sim.FrameState) -> None:
    """Copy state `new` into the buffers of state `live`. A field of `new`
    may be a buffer of `live` itself (recolor_vars is the old sky_vars):
    those are copied before any buffer is written."""
    dst = sim.state_tensors(live)
    shared = {t.data_ptr() for t in dst}
    src = [s if s is d else s.clone() if s.data_ptr() in shared else s
           for d, s in zip(dst, sim.state_tensors(new))]
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)


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
            self.pack_base = src.pack_base
            self.sky_pack, self.sky_texels = src.sky_pack, src.sky_texels
            self.sky_h, self.sky_w = src.sky_h, src.sky_w
        else:
            self.scene = to_device(build_named_scene(config.scene),
                                   self.device)
            # the packs' frame-invariant base and kernel A's cull table
            # depend only on the scene's layout: built once, on the device
            self.pack_base = pack_base(self.scene, self.tri_clusters,
                                       self.sph_clusters, self.tri_subs)
            self.cull = cull_table(self.pack_base.coef,
                                   self.pack_base.layout[2])
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
        # the fast renderer's early exits are decided on the host where no
        # CUDA graph captures a call (the CPU); on a card every call runs
        # them masked, the form its graphs capture (render/fast.py)
        self._early_exit = self.device.type != "cuda"
        # the scene, cull table, pack base and the sky the path reads (the
        # static stack, or the uint8 panoramas) on each device that
        # renders, copied to a device once, at its first use
        self._scenes = dict(getattr(src, "_scenes", {}))
        self._culls = dict(getattr(src, "_culls", {}))
        self._pack_bases = dict(getattr(src, "_pack_bases", {}))
        self._skies = dict(getattr(src, "_skies", {}))
        self._scenes[self.device] = self.scene
        self._culls[self.device] = self.cull
        self._pack_bases[self.device] = self.pack_base
        self._skies[self.device] = self.sky_pack if static else self.sky_texels
        self._assets_for(self.mesh or [])
        # the state: a snapshot handed out (None while only replicas hold
        # it); the replicas of the single-device graph path and of each
        # mesh, with their graphs
        self._state = None
        self._single = _Replicas([self.device])
        self._replicas: dict = {}
        self.state = state
        self._calls = 0                 # the traced calls, for their spans

    @property
    def state(self) -> sim.FrameState:
        """The current state on the engine device: a snapshot, which no
        later step writes into (entry 0's replica, copied when read)."""
        if self._state is None:
            reps = next(r for r in self._holders() if r.current)
            self._state = _state_copy(reps.live[0], self.device)
        return self._state

    @state.setter
    def state(self, state: sim.FrameState):
        """Make `state` current: every replica is written from it before
        its next step."""
        self._state = sim.state_to(state, self.device)
        for reps in self._holders():
            reps.current = False

    def _holders(self) -> list:
        return [self._single, *self._replicas.values()]

    @property
    def _graphs(self) -> dict:
        """The single-device path's CUDA graphs by (kind, K)."""
        return {key: gs[0] for key, gs in self._single.graphs.items()}

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

    def _assets_for(self, mesh) -> None:
        """Put the scene, the cull table, the pack base, the sky the path
        reads and the step's constants on every device of mesh, once per
        device, before any capture."""
        for d in dict.fromkeys(mesh):
            if d.type != self.device.type:
                raise ValueError(f"a {self.device.type} engine cannot render "
                                 f"on {d}")
            if d not in self._scenes:
                self._scenes[d] = to_device(self.scene, d)
            if d not in self._culls:
                self._culls[d] = self.cull.to(d)
            if d not in self._pack_bases:
                self._pack_bases[d] = base_to(self.pack_base, d)
            if d not in self._skies:
                self._skies[d] = self._skies[self.device].to(d)
            sim.device_constants(d)

    def _replicas_for(self, mesh) -> _Replicas:
        """The state replicas of a mesh (a flat list of devices)."""
        reps = self._replicas.get(tuple(mesh))
        if reps is None:
            self._assets_for(mesh)
            reps = self._replicas[tuple(mesh)] = _Replicas(mesh)
        return reps

    # --- state ---

    def _host(self, vecs) -> torch.Tensor:
        """(K, 16) packed actions → float32, in pinned memory on a card
        (the caching host allocator keeps the buffer until the copies have
        read it, so the host never waits)."""
        t = (vecs.to(torch.float32) if isinstance(vecs, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(vecs, np.float32)))
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t

    def _upload(self, vecs, out=None) -> torch.Tensor:
        """(K, 16) packed actions → a float32 tensor on the engine device
        (`out`, where given): the frame's one host-to-device copy, from
        pinned memory on a card."""
        t = self._host(vecs)
        if out is not None:
            return out.copy_(t, non_blocking=True)
        return t.to(self.device, non_blocking=True)

    def step(self, action: Action | None = None, dt: float = 1 / 60):
        """Advance the state machine one frame on the engine device (the
        JAX Engine's `_animate`: a CUDA graph replay on a card once warm)
        → the new state (Engine.state)."""
        self._step_one((action or Action.idle()).pack(dt)[None])
        return self.state

    def _step_one(self, vec) -> None:
        """One state step on the packed (1, 16) action vec, on the single
        replica: the `step()` call."""
        self._call(self._single, ("step", 1), vec,
                   lambda _, state, avs: (sim.animate_packed(state, avs[0]),
                                          None))

    def fast_forward(self, action_vecs, dt: float = 1 / 30):
        """Advance the state machine past a batch of actions without
        rendering (record --resume) → the new state. action_vecs: packed
        (K, 16) vectors or a list of Actions (packed with dt). One `step()`
        call per vector (on a card a replay of the step graph once warm),
        so the state is exactly that of stepping frame by frame. The JAX
        Engine scans 256 vectors per dispatch (loop.py:254-283); on a card
        a 256-step graph's capture costs a cold resume of 1,000 frames more
        than the step graph's replays (PERF.md)."""
        dts = ([dt] * len(action_vecs)
               if isinstance(action_vecs, (list, tuple)) else None)
        vecs = pack_actions(action_vecs, dts)
        for j in range(len(vecs)):
            self._step_one(vecs[j:j + 1])
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
        device, with the engine's cull table and pack base."""
        c = self.config
        return frame_packs(self.scene, self.state if state is None else state,
                           c.height, c.width, c.aspect, self.tri_clusters,
                           self.sph_clusters, self.tri_subs, self.cull,
                           self.pack_base)

    def _bands(self, coefs, params, n_tri: int, n_sph: int, states):
        """K frames in row bands over the engine's mesh → (K, H, W, 3)
        uint8 on the engine device."""
        c = self.config
        return render_bands(coefs, params, n_tri, n_sph, states,
                            self._skies, self.sky_h, self.sky_w,
                            mesh=self.mesh, height=c.height, width=c.width,
                            interleave=c.shard_interleave,
                            cull=self.cull).to(self.device)

    def _bands_plain(self, state) -> torch.Tensor:
        """The `fast` / `oracle` frame of `state` in row bands over the
        engine's mesh, exchanging halo rows (render_bands_plain, early exits
        decided on the host) → (H, W, 3) uint8 on the engine device."""
        c = self.config
        return render_bands_plain(
            self.scene, state, self.sky_texels, mesh=self.mesh,
            height=c.height, width=c.width, chunk=c.chunk, aspect=c.aspect,
            aa=state.aa, interleave=c.shard_interleave).to(self.device)

    def _render(self, state, early_exit: bool | None = None) -> torch.Tensor:
        """The frame of `state` on one device: from the static stack, or
        where the sky is blended per frame (the `fast` and `oracle` paths,
        and sky_cache=False) the one-shot render_frame with the Engine's
        cull table (read by the megakernel path only); early_exit as in
        render_frame (the `fast` path's), None: the Engine's own form
        (masked on a card)."""
        c = self.config
        if self.sky_pack is None:
            return render_frame(self.scene, state, self.sky_texels, c.height,
                                c.width, chunk=c.chunk, aspect=c.aspect,
                                path=self.path, tri_clusters=self.tri_clusters,
                                sph_clusters=self.sph_clusters,
                                t_subs=self.tri_subs, cull=self.cull,
                                base=self.pack_base,
                                early_exit=(self._early_exit
                                            if early_exit is None
                                            else early_exit))
        coef, params, n_tri, n_sph, _ = self._packs(state)
        profiling.mark("packs")
        base = _base(coef, params, n_tri, n_sph, self.sky_pack, self.sky_h,
                     self.sky_w, state, c.height, c.width, self.cull)
        return apply_fxaa(base, state.aa)

    def frame(self) -> torch.Tensor:
        """Render the current state → (H, W, 3) uint8 on the engine device,
        without stepping it (the JAX Engine's `_render_only`). On every path
        a call on a card is one CUDA graph replay once warm (one per mesh
        entry when sharded, each rendering its rows of its replica of the
        state)."""
        if self.mesh is not None:
            return self._run_sharded(None)[0]
        return self._run_single("render", None)

    def _frame_eager(self) -> torch.Tensor:
        """The current state's frame, rendered eagerly: the reference the
        frame graphs are held against, with the `fast` renderer's early
        exits decided on the host (for a sharded Engine the exchanging
        parallel/mesh.py render_bands, or render_bands_plain on the `fast`
        and `oracle` paths)."""
        if self.mesh is None:
            return self._render(self.state, early_exit=True)
        if self.path != "auto":
            return self._bands_plain(self.state)
        coef, params, n_tri, n_sph, _ = self._packs()
        return self._bands(coef[None], params[None], n_tri, n_sph,
                           [self.state])[0]

    def _step_render(self, kind: str, state, avs,
                     early_exit: bool | None = None):
        """The eager device step of one call: from `state`, on packed
        actions avs (K, 16) on the engine device → (the new state, the
        output). kind "frame": one frame; "preview": one frame
        box-downsampled by config.preview; "batch": K frames, each kernel
        launched once (from the static stack; where the sky is blended per
        frame K single frames); "render" (single device, avs None): the
        frame of `state` itself, unstepped. On one device it is what the CUDA
        graph captures; early_exit as in render_frame, None: the Engine's
        own form (on a card every bounce and sweep masked, as captured;
        True is the host-decided reference). On a sharded Engine it is the
        exchanging reference the entries' graphs are held against (the
        state stepped on the engine device, then packed and
        parallel/mesh.py render_bands, or render_bands_plain on the `fast`
        and `oracle` paths)."""
        c = self.config
        if self.mesh is not None:
            if self.path != "auto":
                states = step_states(state, avs, self.device)
                img = torch.stack([self._bands_plain(st) for st in states])
            else:
                coefs, params, n_tri, n_sph, _, states = batch_packs(
                    self.scene, state, avs, c.height, c.width, c.aspect,
                    self.tri_clusters, self.sph_clusters, self.tri_subs,
                    self.cull, self.pack_base)
                img = self._bands(coefs, params, n_tri, n_sph, states)
            if kind != "batch":
                img = img[0]
            if kind == "preview":
                img = _box_downsample(img, c.preview)
            return states[-1], img
        if kind == "render":
            profiling.mark("begin")
            return state, self._render(state, early_exit)
        if kind == "batch" and self.sky_pack is None:
            imgs = []
            for av in avs:
                state = sim.animate_packed(state, av)
                imgs.append(self._render(state, early_exit))
            return state, torch.stack(imgs)
        if kind == "batch":
            coefs, params, n_tri, n_sph, _, states = batch_packs(
                self.scene, state, avs, c.height, c.width, c.aspect,
                self.tri_clusters, self.sph_clusters, self.tri_subs,
                self.cull, self.pack_base)
            return states[-1], frames_from_packs(
                coefs, params, n_tri, n_sph, self.sky_pack, self.sky_h,
                self.sky_w, states, c.height, c.width, self.cull)
        profiling.mark("begin")
        state = sim.animate_packed(state, avs[0])
        profiling.mark("step")
        img = self._render(state, early_exit)
        if kind == "preview":
            img = _box_downsample(img, c.preview)
        return state, img

    def _shard_step(self, entry: int, state, avs):
        """Mesh entry `entry`'s step of a sharded call, on its device: its
        replica stepped on the K actions avs (K, 16), then its rows of the
        K new states' frames (_shard_bands) → (the K-th state, the rows)."""
        return self._shard_bands(entry,
                                 step_states(state, avs, self.mesh[entry]))

    def _shard_bands(self, entry: int, states):
        """Mesh entry `entry`'s rows of the K frames of `states`, on its
        device: the packs of the states and entry_bands (on the `fast` and
        `oracle` paths entry_bands_plain per state, its early exits masked
        on a card) → (the K-th state, (K, interleave, sub, W, 3) uint8)."""
        c = self.config
        d = self.mesh[entry]
        if self.path != "auto":
            return states[-1], torch.cat([entry_bands_plain(
                self._scenes[d], st, self._skies[d], entry=entry,
                n=len(self.mesh), height=c.height, width=c.width,
                chunk=c.chunk, aspect=c.aspect,
                interleave=c.shard_interleave, early_exit=self._early_exit)
                for st in states])
        coefs, params, n_tri, n_sph, cull = stack_packs(
            self._scenes[d], states, c.height, c.width, c.aspect,
            self.tri_clusters, self.sph_clusters, self.tri_subs,
            self._culls[d], self._pack_bases[d])
        return states[-1], entry_bands(
            coefs, params, n_tri, n_sph, states, self._skies[d],
            self.sky_h, self.sky_w, entry=entry, n=len(self.mesh),
            height=c.height, width=c.width, interleave=c.shard_interleave,
            cull=cull)

    def _load(self, reps: _Replicas) -> None:
        """Make the replicas of `reps` hold the current state."""
        if reps.current:
            return
        state = self.state
        if reps.live is None:
            reps.live = [_state_copy(state, d) for d in reps.mesh]
        else:
            for live in reps.live:
                for dst, src in zip(sim.state_tensors(live),
                                    sim.state_tensors(state)):
                    dst.copy_(src)
        reps.current = True

    def _capture(self, step, entry: int, live, device, k) -> _Graph:
        """A CUDA graph of step(entry, live, actions) on `device` from the
        replica `live` on a static (k, 16) action buffer (none where k is
        None: a render-only step), which writes the new state back into
        the replica; in a memory pool of its own, on the capture stream of
        `device` (_capture_stream). Raises where the capture fails."""
        with torch.cuda.device(device):
            actions = None if k is None else torch.zeros(
                (k, 16), dtype=torch.float32, device=device)
            counters = _launch_counters()
            before = [getattr(fn, attr) for fn, attr in counters]
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            mem = (torch.cuda.memory_allocated(device),
                   torch.cuda.memory_reserved(device))
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph,
                                      stream=_capture_stream(device)):
                    new, out = step(entry, live, actions)
                    _write_state(live, new)
            finally:
                # the capture recorded the launches, it ran none
                after = [getattr(fn, attr) for fn, attr in counters]
                for (fn, attr), n in zip(counters, before):
                    setattr(fn, attr, n)
            seconds = time.perf_counter() - t0
            mem = (torch.cuda.memory_allocated(device) - mem[0],
                   torch.cuda.memory_reserved(device) - mem[1])
        return _Graph(graph, actions, out,
                      tuple(a - b for a, b in zip(after, before)), mem,
                      seconds)

    def _call(self, reps: _Replicas, key, vecs, step, marks: bool = False,
              span=None):
        """One call of `step` on every entry of `reps`: entry e steps its
        replica, step(e, replica, actions) → (new state, output), on the
        packed actions vecs (K, 16) uploaded to its device → (the entries'
        outputs, whether graphs ran). vecs None: a render-only call, which
        uploads nothing and passes actions None; its step returns the
        replica itself, so no state is written and the Engine's state
        snapshot stays. On a card the first call of each key runs eagerly,
        the second captures one CUDA graph per entry and every call from
        then on replays them; a graph's output is overwritten by its next
        replay. Elsewhere every call is eager.

        While a torch.profiler session records, the call numbers itself
        and runs again inside the host span `engine.call`, given `span`,
        its span function (utils/profiling.py): its upload, replay or
        eager run and capture are spans then, all carrying its number (a
        replay also the index of its entry's card, `device`), and
        where `marks` (a step that places the stage marks) a replay is of
        the graph's marked variant, captured at the first such call in a
        pool of its own. Otherwise the call costs a flag check more than
        an untraced Engine's and replays the plain graph."""
        if span is None and profiling.recording():
            self._calls += 1
            span = profiling.spans(self._calls)
            with span("engine.call"):
                return self._call(reps, key, vecs, step, marks, span)
        self._load(reps)
        replay = self.device.type == "cuda" and key in reps.warm
        reps.warm.add(key)
        vecs = None if vecs is None else self._host(vecs)
        part = span or profiling.off
        outs = []
        if replay:
            table = reps.traced if span is not None and marks else reps.graphs
            graphs = table.get(key)
            if graphs is None:
                with part("engine.capture"), (
                        profiling.marking() if table is reps.traced
                        else profiling.NOOP):
                    graphs = table[key] = [
                        self._capture(step, e, live, d,
                                      None if vecs is None else len(vecs))
                        for e, (live, d) in enumerate(zip(reps.live,
                                                          reps.mesh))]
            for g, d in zip(graphs, reps.mesh):
                with torch.cuda.device(d):
                    if span is None:
                        if vecs is not None:
                            g.actions.copy_(vecs, non_blocking=True)
                        g.graph.replay()
                    else:
                        if vecs is not None:
                            with span("engine.upload"):
                                g.actions.copy_(vecs, non_blocking=True)
                        with span("engine.replay", device=d.index):
                            g.graph.replay()
                for (fn, attr), n in zip(_launch_counters(), g.counts):
                    setattr(fn, attr, getattr(fn, attr) + n)
                outs.append(g.out)
        else:
            for e, (live, d) in enumerate(zip(reps.live, reps.mesh)):
                with (torch.cuda.device(d) if d.type == "cuda"
                      else contextlib.nullcontext()):
                    avs = None
                    if vecs is not None:
                        with part("engine.upload"):
                            avs = vecs.to(d, non_blocking=True)
                    with part("engine.eager"):
                        new, out = step(e, live, avs)
                        _write_state(live, new)
                outs.append(out)
        if vecs is not None:
            self._state = None              # the replicas hold it
            for r in self._holders():
                r.current = r is reps
        return outs, replay

    def _run_single(self, kind: str, vecs, out=None):
        """One call of the device step on one device, from the current
        state on packed actions vecs (K, 16) (None: kind "render", the
        current state's frame, unstepped) → the output, which no later call
        overwrites (copied into `out` where given). The single frame kinds
        on the static sky stack place the stage marks."""
        outs, replay = self._call(
            self._single, (kind, 1 if vecs is None else len(vecs)), vecs,
            lambda _, state, avs: self._step_render(kind, state, avs),
            marks=kind != "batch" and self.sky_pack is not None)
        if out is not None:
            return out.copy_(outs[0])
        return outs[0].clone() if replay else outs[0]

    def _run_sharded(self, vecs, frames=None) -> torch.Tensor:
        """One call of the sharded device step on packed actions vecs
        (K, 16): every mesh entry steps its replica and renders its rows,
        then the rows are copied into the K frames on the engine device
        (`frames`, where given) → (K, H, W, 3) uint8. vecs None: each entry
        renders its rows of its replica's frame, unstepped (K = 1)."""
        c = self.config
        if vecs is None:
            key, step = ("render", 1), (
                lambda e, state, _: self._shard_bands(e, [state]))
        else:
            key, step = ("bands", len(vecs)), self._shard_step
        outs, _ = self._call(self._replicas_for(self.mesh), key, vecs, step)
        if frames is None:
            frames = torch.empty((key[1], c.height, c.width, 3),
                                 dtype=torch.uint8, device=self.device)
        for e, out in enumerate(outs):
            place_bands(frames, out, e, len(self.mesh))
        return frames

    def step_and_frame(self, action: Action | None = None,
                       dt: float = 1 / 60) -> torch.Tensor:
        """Step the state machine, then render the new state (the JAX
        Engine's `_step_render`: one CUDA graph replay per call on a card
        once warm, one per mesh entry when sharded)."""
        return self._step_frame((action or Action.idle()).pack(dt)[None])

    def _step_frame(self, vec, out=None) -> torch.Tensor:
        """One step_and_frame call on the packed (1, 16) action vec → the
        frame (written into `out`, (H, W, 3), where given)."""
        if self.mesh is None:
            return self._run_single("frame", vec, out)
        return self._run_sharded(vec, None if out is None else out[None])[0]

    def step_and_frame_preview(self, action: Action | None = None,
                               dt: float = 1 / 60) -> torch.Tensor:
        """Step, render at full size, box-downsample on the device →
        (H/p, W/p, 3) uint8 on the engine device (p = config.preview): a
        full-size render with a small readback. On one device a graph of
        its own (the JAX Engine's `_step_render_preview`); sharded, the
        step_and_frame graphs, then the downsample."""
        if self.mesh is None:
            return self._run_single(
                "preview", (action or Action.idle()).pack(dt)[None])
        return _box_downsample(self.step_and_frame(action, dt),
                               self.config.preview)

    def step_and_frame_batch(self, actions, dts=None) -> torch.Tensor:
        """Step and render K frames → (K, H, W, 3) uint8 on the engine
        device: on the megakernel path one call, each kernel launched once
        for the batch (with sky_cache=False K one-shot frames in one call);
        on the `fast` and `oracle` paths K step_and_frame calls, K replays
        of its graph on a card (a K-frame graph of these renderers costs
        more to capture than K replays, PERF.md). actions: a list of
        Actions (dts per frame, default 1/60 each) or packed (K, 16)
        vectors carrying their own dt. Frame k equals the k-th of K
        step_and_frame calls."""
        if isinstance(actions, (list, tuple)) and dts is None:
            dts = [1 / 60] * len(actions)
        vecs = pack_actions(actions, dts)
        if len(vecs) < 1:
            raise ValueError("a batch needs at least one frame")
        if self.path != "auto":
            c = self.config
            imgs = torch.empty((len(vecs), c.height, c.width, 3),
                               dtype=torch.uint8, device=self.device)
            for j in range(len(vecs)):
                self._step_frame(vecs[j:j + 1], imgs[j])
            return imgs
        if self.mesh is None:
            return self._run_single("batch", vecs)
        return self._run_sharded(vecs)

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
        own dt.

        Every entry of the mesh scans all K actions from its replica of
        the state and renders its rows of its group's block of frames
        (parallel/frames.py script_entry): one CUDA graph per entry on a
        card for each K and layout, as the single-device path's."""
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
        vecs = pack_actions(action_vecs, None)
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
        if not mesh or len({len(g) for g in mesh}) > 1:
            raise ValueError("a hybrid mesh is a non-empty list of equally "
                             "long device lists")
        n_frames, n_rows = len(mesh), len(mesh[0])
        # one device per group: striding does not exist (as _row_mesh)
        interleave = c.shard_interleave if n_rows > 1 else 1
        per = pframes.frame_blocks(len(vecs), n_frames, "frame axis")
        band_rows(c.height, n_rows, interleave)
        flat = [d for g in mesh for d in g]

        def step(entry, state, avs):
            d = flat[entry]
            return pframes.script_entry(
                self._scenes[d], state, avs, self._skies[d], self.sky_h,
                self.sky_w, group=entry // n_rows, row=entry % n_rows,
                n_frames=n_frames, n_rows=n_rows, height=c.height,
                width=c.width, aspect=c.aspect, interleave=interleave,
                tri_clusters=self.tri_clusters,
                sph_clusters=self.sph_clusters, t_subs=self.tri_subs,
                cull=self._culls[d], base=self._pack_bases[d])

        outs, _ = self._call(
            self._replicas_for(flat),
            ("script", len(vecs), n_frames, n_rows, interleave), vecs, step)
        imgs = torch.empty((len(vecs), c.height, c.width, 3),
                           dtype=torch.uint8, device=self.device)
        with profiling.span_function(self._calls)("engine.gather"):
            for e, out in enumerate(outs):
                g = e // n_rows
                place_bands(imgs[g * per:(g + 1) * per], out, e % n_rows,
                            n_rows)
        return imgs

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
