"""Render pipeline (port of raytracing_cuda_tpu/render/pipeline.py:
`render_frame` and `render_frame_np`, pipeline.py:25-65 and :155-159,
`render_frame_static_sky` and `_pallas_base`, pipeline.py:83-152, and
`render_frames_batch`, pipeline.py:162-277).

One frame is, on one device as in the JAX package's jitted step: derive the
frame's scene and rays, pack them into the coefficient table and params
vector (`frame_packs`: on a card one launch of csrc/packs.cu over the
scene's pack base, render/packs.py), then the megakernel (7 planes), the
flat pair sky lookup from the static panorama stack and
`quantize(rgb + mw·sky)` (reference.py:139-142; on a card one launch of
csrc/sky.cu, render/sky.py), and FXAA selected by the
state's toggle. Every step runs on the device of the scene and state;
nothing is read back to the host, so a CUDA graph can replay it
(app/loop.py).

A batch of K frames steps the state machine K times, stacks the K frames'
packs, and launches each kernel once over all K frames; frame k equals what
the single-frame path renders for state k.

`render_frame` is the one-shot frame: it blends the four panoramas for the
frame's sky weights and renders by `path`: "fast" and "oracle" are plain
PyTorch raytracers (render/fast.py, render/reference.py) on the device of
the sky texels; "auto" is the megakernel with a lookup into the packed
per-frame blend, equal bit for bit to the static stack's pair lookup.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracing_cuda_tpu_torch.core.math3d import true_div
from raytracing_cuda_tpu_torch.core.types import Scene, SkyTextures, to_device
from raytracing_cuda_tpu_torch.render.cuda_rt import (
    MAX_CLUSTERS, P_CLUSTERS, cluster_bounds, cull_groups, cull_table,
    pack_params, pack_scene, raytrace_planes, raytrace_planes_batch,
    sph_cluster_norm, tri_cluster_pads)
from raytracing_cuda_tpu_torch.render.fast import render_base_image_fast
from raytracing_cuda_tpu_torch.render.fxaa import apply_fxaa
from raytracing_cuda_tpu_torch.render.packs import (layout_key, pack_base,
                                                    pack_frame)
from raytracing_cuda_tpu_torch.render.reference import (quantize,
                                                        render_base_image)
from raytracing_cuda_tpu_torch.render.sky import sky_quantize
from raytracing_cuda_tpu_torch.scene.textures import (blend_sky, pack_sky,
                                                      sample_sky_packed)
from raytracing_cuda_tpu_torch.sim.state import (FrameState, animate_packed,
                                                 camera_rays, derive_frame,
                                                 state_to)
from raytracing_cuda_tpu_torch.utils import profiling


PLAIN_RENDERERS = {"fast": render_base_image_fast,
                   "oracle": render_base_image}


def frame_packs(scene: Scene, state: FrameState, height: int, width: int,
                aspect: float | None = None, tri_clusters=None,
                sph_clusters=None, t_subs=None, cull=None, base=None):
    """The packs of a frame → (coef, params, n_tri_rows, n_sph_rows, cull)
    on the device of `scene` (a state held elsewhere is copied there
    first): the float32 table and params, and kernel A's int32 cull table
    (cull_table), whose group g holds the rows under the bound written into
    params as bound g. On a card they are one launch of csrc/packs.cu
    (render/packs.py pack_frame) over `base`, the PackBase of the scene's
    layout on that device (built where None); on the CPU frame_packs_torch,
    which reads no base; the two give the same floats on the same device.
    A base of another layout is refused on every device. The cull table
    depends only on the scene's layout: a `cull` given is returned as it
    is, else it is built."""
    if t_subs and not tri_clusters:
        raise ValueError("t_subs requires tri_clusters")
    if base is not None and base.layout != layout_key(
            scene, tri_clusters, sph_clusters, t_subs):
        raise ValueError("the pack base was packed for another scene layout "
                         "than the scene and cluster arguments give")
    if scene.color.device.type != "cuda":
        return frame_packs_torch(scene, state, height, width, aspect,
                                 tri_clusters, sph_clusters, t_subs, cull)
    if base is None:
        base = pack_base(scene, tri_clusters, sph_clusters, t_subs)
    coef, params = pack_frame(base, state_to(state, scene.color.device),
                              width / height if aspect is None else aspect)
    if cull is None:
        cull = cull_table(base.coef, base.layout[2])
    return coef, params, base.n_tri_rows, base.n_sph_rows, cull


def frame_packs_torch(scene: Scene, state: FrameState, height: int,
                      width: int, aspect: float | None = None,
                      tri_clusters=None, sph_clusters=None, t_subs=None,
                      cull=None):
    """frame_packs in torch ops on any device (derive_frame, camera_rays,
    then the packing of render_base_planes_pallas, pallas_rt.py:1226-1254):
    the whole table and params packed anew. The CPU's frame_packs, and the
    reference the card's packs kernel is held to."""
    if t_subs and not tri_clusters:
        raise ValueError("t_subs requires tri_clusters")
    state = state_to(state, scene.color.device)
    if aspect is None:
        aspect = width / height
    scene_f, lights, ambient = derive_frame(scene, state)
    rays = camera_rays(state.cam, aspect)
    coef = pack_scene(scene_f, tri_clusters, sph_clusters)
    params = pack_params(rays, lights, ambient, scene_f.plane_pos[1])
    bounds = cluster_bounds(scene_f, tri_clusters, sph_clusters,
                            t_subs).reshape(-1)
    if bounds.numel() > 4 * MAX_CLUSTERS:
        raise ValueError(f"{bounds.numel() // 4} cull bounds exceed "
                         f"MAX_CLUSTERS={MAX_CLUSTERS}")
    params[P_CLUSTERS:P_CLUSTERS + bounds.numel()] = bounds
    n_tri_rows = sum(tri_cluster_pads(scene_f.n_triangles, tri_clusters))
    n_sph_rows = sum(sph_cluster_norm(scene_f.n_spheres, sph_clusters)[1])
    if cull is None:
        cull = cull_table(coef, cull_groups(
            scene_f.n_triangles, scene_f.n_spheres, tri_clusters,
            sph_clusters, t_subs))
    return coef, params, n_tri_rows, n_sph_rows, cull


def render_frame(scene: Scene, state: FrameState, sky_texels: torch.Tensor,
                 height: int, width: int, chunk: int = 32768,
                 aspect: float | None = None,
                 fxaa_static: bool | None = None, path: str = "fast",
                 tri_clusters=None, sph_clusters=None,
                 t_subs=None, cull=None, base=None,
                 early_exit: bool = True) -> torch.Tensor:
    """Render one frame → (height, width, 3) uint8 on the device of
    `sky_texels`, the four panoramas (4, H, W, 3) uint8.

    aspect defaults to width/height (see RenderConfig.aspect for the
    reference's stale-aspect quirk). fxaa_static overrides the state's FXAA
    toggle (the reference's per-frame `alias` flag, kernel.cu:263). path
    selects the raytracer: "fast" (render.fast), "oracle" (render.reference,
    the straight-line parity implementation), or "auto": the megakernel
    (the CUDA kernel on a card, its plain version on the CPU) with the sky
    looked up in the packed per-frame blend; only "auto" reads the cluster
    arguments, `cull`, the scene's cull table, and `base`, its pack base
    (frame_packs; each built for the frame where None, the same bit for
    bit). early_exit=False runs the "fast" renderer with every bounce and
    sweep masked and no value read back (render.fast; a CUDA graph can
    capture it); it changes no pixel. FXAA is kernel B on a card and its
    plain version on the CPU on every path.
    """
    if aspect is None:
        aspect = width / height
    dev = sky_texels.device
    state = state_to(state, scene.color.device)
    blended = blend_sky(sky_texels, state.sky_vars)
    day_frac = true_div(state.day_time, 24.0)
    if path == "auto":
        coef, params, nt, ns, cull = frame_packs(
            scene, state, height, width, aspect, tri_clusters, sph_clusters,
            t_subs, cull, base)
        r, g, b, mw, mdx, mdy, mdz = raytrace_planes(
            coef.to(dev), params.to(dev), height, width, nt, ns,
            cull=cull.to(dev))
        sky = sample_sky_packed(pack_sky(blended), *blended.shape[:2],
                                torch.stack([mdx, mdy, mdz], dim=-1),
                                day_frac)
        base = quantize(torch.stack([r, g, b], dim=-1) + mw[..., None] * sky)
    elif path in PLAIN_RENDERERS:
        scene_f, lights, ambient = derive_frame(scene, state)
        base = PLAIN_RENDERERS[path](
            to_device(scene_f, dev), to_device(lights, dev), ambient.to(dev),
            blended, day_frac, to_device(camera_rays(state.cam, aspect), dev),
            height, width, chunk=chunk,
            **({"early_exit": early_exit} if path == "fast" else {}))
    else:
        raise ValueError(f"path must be 'auto', 'fast' or 'oracle', got "
                         f"{path!r}")
    return apply_fxaa(base, state.aa if fxaa_static is None
                      else bool(fxaa_static))


def render_frame_np(scene: Scene, state: FrameState, sky: SkyTextures,
                    height: int, width: int, device, **kw) -> np.ndarray:
    """render_frame on `device` from host sky textures → host numpy array."""
    texels = torch.from_numpy(sky.texels).to(device)
    return render_frame(scene, state, texels, height, width,
                        **kw).cpu().numpy()


def _base(coef, params, n_tri_rows: int, n_sph_rows: int, sky_pack,
          sky_h: int, sky_w: int, state: FrameState, height: int,
          width: int, cull=None) -> torch.Tensor:
    """Device half before FXAA: megakernel + deferred sky + quantize →
    (height, width, 3) uint8 on the device of `coef`. cull: frame_packs'
    cull table on that device (read by the CUDA kernel only). The sky and
    quantize are render/sky.py sky_quantize over the one frame, reading the
    state's clock and sky weights on that device. The `sky` stage mark
    follows it (utils/profiling.py `mark`: launched only in a marked
    capture)."""
    planes = raytrace_planes(coef, params, height, width, n_tri_rows,
                             n_sph_rows, cull=cull)
    dev = coef.device
    base = sky_quantize([p[None] for p in planes], sky_pack, sky_h, sky_w,
                        state.day_time.to(dev).reshape(1),
                        state.sky_vars.to(dev).reshape(1, 4))[0]
    profiling.mark("sky")
    return base


def render_frame_static_sky(scene: Scene, state: FrameState, sky_pack,
                            sky_h: int, sky_w: int, height: int, width: int,
                            aspect: float | None = None, tri_clusters=None,
                            sph_clusters=None, t_subs=None) -> torch.Tensor:
    """One frame from the static (4, H*W) sky stack → (H, W, 3) uint8 on the
    device of `sky_pack`; the packs are made on the scene's device."""
    coef, params, nt, ns, cull = frame_packs(scene, state, height, width,
                                             aspect, tri_clusters,
                                             sph_clusters, t_subs)
    dev = sky_pack.device
    base = _base(coef.to(dev), params.to(dev), nt, ns, sky_pack, sky_h, sky_w,
                 state, height, width, cull.to(dev))
    return apply_fxaa(base, state.aa)


def pack_actions(actions, dts):
    """Actions with their dts, or packed (K, 16) vectors → (K, 16) float32
    (the Action wire format, slot 14 = dt): numpy, or the tensor given."""
    if isinstance(actions, (list, tuple)):
        if len(dts) != len(actions):
            raise ValueError(f"{len(actions)} actions but {len(dts)} dts")
        return np.array([a.pack(dt) for a, dt in zip(actions, dts)],
                        np.float32).reshape(-1, 16)
    vecs = (actions.to(torch.float32) if isinstance(actions, torch.Tensor)
            else np.asarray(actions, np.float32))
    if vecs.ndim != 2 or vecs.shape[1] != 16:
        raise ValueError(f"packed actions must be (K, 16), got "
                         f"{tuple(vecs.shape)}")
    return vecs


def batch_packs(scene: Scene, state: FrameState, vecs, height: int,
                width: int, aspect: float | None = None, tri_clusters=None,
                sph_clusters=None, t_subs=None, cull=None, base=None):
    """The packs of a K-frame batch on the scene's device: step the state
    machine once per packed action (pipeline.py:201-206), then each new
    state's frame_packs, stacked → (coefs (K, n, N_CHANNELS), params (K,
    N_PARAMS), n_tri_rows, n_sph_rows, cull, states). vecs: (K, 16) packed
    actions (numpy or a tensor). Per-frame packs, so frame k's are
    bit-identical to what the single-frame path packs for states[k]; the
    frames share one scene layout and so one cull table (`cull`, built
    when None) and, on a card, one pack base (`base`, built once when
    None)."""
    if len(vecs) < 1:
        raise ValueError("a batch needs at least one frame")
    states = step_states(state, vecs, scene.color.device)
    return (*stack_packs(scene, states, height, width, aspect, tri_clusters,
                         sph_clusters, t_subs, cull, base), states)


def step_states(state: FrameState, vecs, device) -> list:
    """The states after each of the packed (K, 16) actions vecs (numpy or a
    tensor), stepped in order on `device` (the scan of pipeline.py:201-206)
    → K states."""
    vecs = torch.as_tensor(vecs, dtype=torch.float32).to(device)
    state = state_to(state, device)
    states = []
    for av in vecs:
        state = animate_packed(state, av)
        states.append(state)
    return states


def stack_packs(scene: Scene, states, height: int, width: int,
                aspect: float | None = None, tri_clusters=None,
                sph_clusters=None, t_subs=None, cull=None, base=None):
    """Each state's frame_packs, stacked → (coefs (K, n, N_CHANNELS),
    params (K, N_PARAMS), n_tri_rows, n_sph_rows, cull): on a card K packs
    launches over one base (built once where None)."""
    if base is None and scene.color.device.type == "cuda":
        base = pack_base(scene, tri_clusters, sph_clusters, t_subs)
    packs = [frame_packs(scene, st, height, width, aspect, tri_clusters,
                         sph_clusters, t_subs, cull, base) for st in states]
    return (torch.stack([p[0] for p in packs]),
            torch.stack([p[1] for p in packs]), *packs[0][2:])


def bases_from_packs(coefs, params, n_tri_rows: int, n_sph_rows: int,
                     sky_pack, sky_h: int, sky_w: int, states, height: int,
                     width: int, row0: int = 0, total_h=None,
                     cull=None) -> torch.Tensor:
    """Device half of K frames before FXAA, on the device of `coefs`: one
    kernel A launch (culling by `cull`, the packs' cull table on that
    device), then the sky lookup + quantize of all K frames
    (render/sky.py sky_quantize, each state's clock and sky weights) →
    (K, height, width, 3) uint8. row0/total_h place a band of `height`
    rows in frames of total_h rows (parallel/mesh.py)."""
    planes = raytrace_planes_batch(coefs, params, height, width, n_tri_rows,
                                   n_sph_rows, row0, total_h, cull)
    dev = coefs.device
    return sky_quantize(planes, sky_pack, sky_h, sky_w,
                        torch.stack([st.day_time for st in states]).to(dev),
                        torch.stack([st.sky_vars for st in states]).to(dev))


def frames_from_packs(coefs, params, n_tri_rows: int, n_sph_rows: int,
                      sky_pack, sky_h: int, sky_w: int, states,
                      height: int, width: int, cull=None) -> torch.Tensor:
    """Device half of a K-frame batch on the device of `coefs`: the bases
    (bases_from_packs), one kernel B launch, then each frame's `aa` flag
    picks FXAA or the base frame on the device (pipeline.py:276) → (K,
    height, width, 3) uint8."""
    base = bases_from_packs(coefs, params, n_tri_rows, n_sph_rows, sky_pack,
                            sky_h, sky_w, states, height, width, cull=cull)
    return apply_fxaa(base, torch.stack([st.aa for st in states]))


def render_frames_batch(scene: Scene, state: FrameState, sky_pack,
                        sky_h: int, sky_w: int, action_vecs, height: int,
                        width: int, aspect: float | None = None,
                        tri_clusters=None, sph_clusters=None, t_subs=None):
    """K frames of packed (K, 16) actions from `state`, each kernel launched
    once for the batch → (imgs (K, H, W, 3) uint8 on the device of
    `sky_pack`, last_state); the state steps and packs run on the scene's
    device."""
    coefs, params, nt, ns, cull, states = batch_packs(
        scene, state, pack_actions(action_vecs, None), height, width,
        aspect, tri_clusters, sph_clusters, t_subs)
    dev = sky_pack.device
    imgs = frames_from_packs(coefs.to(dev), params.to(dev), nt, ns, sky_pack,
                             sky_h, sky_w, states, height, width,
                             cull.to(dev))
    return imgs, states[-1]
