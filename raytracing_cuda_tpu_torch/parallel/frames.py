"""Frame-parallel offline rendering over a list of devices (port of
raytracing_cuda_tpu/parallel/frames.py).

Row bands (parallel/mesh.py) cut the latency of one frame; a scripted
animation rendered offline (record) wants throughput, and its frames are
independent once their states are known. The state machine steps through
all K states in order, then device d renders its contiguous block of K / n
frames with one launch of each kernel, so frame k equals the k-th
Engine.step_and_frame from the same state. The hybrid composes this with
row bands: n_frames groups of n_rows devices, each group rendering its
block of frames in bands; frame DP is the hybrid with one device per
group.

Each mesh entry renders on its own device, with no exchange and no
hand-off: its rows (parallel/mesh.py entry_bands) of its group's block.
`script_entry` is what an entry of the Engine's path runs (one CUDA graph
per entry on a card, app/loop.py): it scans all K actions from its replica
of the state, as the JAX package's replicated lax.scan (frames.py:63-127),
then packs its group's block and renders its rows of it.
`render_script_dp` / `render_script_hybrid` step and pack all K states
once, on the scene's device, and copy each group's block to its devices;
the frames and the end state are the same.

A mesh is a list of torch.devices (a hybrid mesh a list of such lists);
devices may repeat, as in parallel/mesh.py. The result is gathered on the
first device.
"""

from __future__ import annotations

import torch

from raytracing_cuda_tpu_torch.core.types import Scene
from raytracing_cuda_tpu_torch.parallel.mesh import (as_mesh, band_rows,
                                                     devices, entry_bands,
                                                     place_bands)
from raytracing_cuda_tpu_torch.render.pipeline import (batch_packs,
                                                       pack_actions,
                                                       stack_packs,
                                                       step_states)
from raytracing_cuda_tpu_torch.sim.state import FrameState, state_to


def make_frames_mesh(n_devices: int | None = None,
                     device_type: str = "cuda") -> list:
    """Frame mesh over the first n_devices devices of a type. Fails fast
    where fewer exist: the CLI sizes its batches by the requested count
    (frames.py:46-60)."""
    return devices(n_devices, device_type, "frame DP")


def make_hybrid_mesh(n_frames: int, n_rows: int,
                     device_type: str = "cuda") -> list:
    """(frames, rows) mesh: n_frames groups of n_rows devices each, the
    rows of a group on neighbouring devices (frames.py:131-149)."""
    if n_frames < 1 or n_rows < 1:
        raise ValueError(f"hybrid mesh axes must be >= 1, got "
                         f"{n_frames}x{n_rows}")
    devs = devices(n_frames * n_rows, device_type,
                   f"hybrid mesh {n_frames}x{n_rows}")
    return [devs[g * n_rows:(g + 1) * n_rows] for g in range(n_frames)]


def frame_blocks(K: int, n: int, axis: str) -> int:
    """Frames per group when K frames spread over n groups of `axis`;
    raises where n does not divide K."""
    if K % n:
        raise ValueError(f"{K} frames not divisible over the {n}-device "
                         f"{axis}; render the remainder with single-frame "
                         f"steps")
    return K // n


def hybrid_layout(mesh, K: int, height: int, interleave: int):
    """The layout of K frames over a (frames, rows) mesh → (mesh as lists of
    torch.devices, frames per group, the interleave its groups render with):
    each entry of mesh is a list of devices, or one device (a group of
    one); the groups are equally long, the frames divide over them
    (frame_blocks) and the height over the rows of a group times the
    interleave, which is 1 where a group has one device (striding does not
    exist there)."""
    mesh = [as_mesh(g if isinstance(g, (list, tuple)) else [g])
            for g in mesh]
    if not mesh or len({len(g) for g in mesh}) > 1:
        raise ValueError("a hybrid mesh is a non-empty list of equally long "
                         "device lists")
    interleave = interleave if len(mesh[0]) > 1 else 1
    per = frame_blocks(K, len(mesh), "frame axis")
    band_rows(height, len(mesh[0]), interleave)
    return mesh, per, interleave


def render_script_dp(scene: Scene, state: FrameState, sky_packs: dict,
                     sky_h: int, sky_w: int, action_vecs, *, mesh,
                     height: int, width: int, aspect: float | None = None,
                     tri_clusters=None, sph_clusters=None, t_subs=None):
    """K frames of packed (K, 16) actions with the frames sharded over
    mesh → (imgs (K, H, W, 3) uint8 on mesh[0], last_state): the hybrid
    with one device per frame group.

    K must divide over the mesh. sky_packs maps each device of mesh to its
    copy of the static sky stack (parallel.mesh.replicate)."""
    return render_script_hybrid(
        scene, state, sky_packs, sky_h, sky_w, action_vecs,
        mesh=[[d] for d in as_mesh(mesh)], height=height, width=width,
        aspect=aspect, tri_clusters=tri_clusters, sph_clusters=sph_clusters,
        t_subs=t_subs)


def render_script_hybrid(scene: Scene, state: FrameState, sky_packs: dict,
                         sky_h: int, sky_w: int, action_vecs, *, mesh,
                         height: int, width: int,
                         aspect: float | None = None, interleave: int = 1,
                         tri_clusters=None, sph_clusters=None, t_subs=None):
    """K frames over a (frames, rows) mesh → (imgs (K, H, W, 3) uint8 on
    the first device, last_state): group g renders its block of K / n_frames
    frames in row bands over its n_rows devices (frames.py:152-256), each
    device its rows by entry_bands, each kernel launched once per chunk for
    the block, and place_bands gathers them.

    K must divide over the groups and height over n_rows * interleave.
    sky_packs maps each device of mesh to its copy of the static sky
    stack."""
    vecs = pack_actions(action_vecs, None)
    mesh, per, interleave = hybrid_layout(mesh, len(vecs), height,
                                          interleave)
    coefs, params, nt, ns, cull, states = batch_packs(
        scene, state, vecs, height, width, aspect, tri_clusters,
        sph_clusters, t_subs)
    n_rows = len(mesh[0])
    imgs = torch.empty((len(vecs), height, width, 3), dtype=torch.uint8,
                       device=mesh[0][0])
    for g, group in enumerate(mesh):
        s = slice(g * per, (g + 1) * per)
        for row, d in enumerate(group):
            place_bands(imgs[s], entry_bands(
                coefs[s].to(d), params[s].to(d), nt, ns,
                [state_to(st, d) for st in states[s]], sky_packs[d], sky_h,
                sky_w, entry=row, n=n_rows, height=height, width=width,
                interleave=interleave, cull=cull.to(d)), row, n_rows)
    return imgs, states[-1]


def script_entry(scene: Scene, state: FrameState, vecs, sky_pack,
                 sky_h: int, sky_w: int, *, group: int, row: int,
                 n_frames: int, n_rows: int, height: int, width: int,
                 aspect: float | None = None, interleave: int = 1,
                 tri_clusters=None, sph_clusters=None, t_subs=None,
                 cull=None, base=None):
    """Entry (group, row) of an n_frames x n_rows mesh, on the device of
    `scene` (where state, vecs (K, 16), sky_pack, cull and the pack base
    lie) → (the K-th state, its rows of its group's frames: (K / n_frames,
    interleave, sub, width, 3) uint8, see parallel.mesh.entry_bands). It
    steps all K states from `state`, packs frames group * K / n_frames … of
    them and renders row part `row` of n_rows (whole frames where n_rows *
    interleave == 1)."""
    per = frame_blocks(len(vecs), n_frames, "frame axis")
    states = step_states(state, vecs, scene.color.device)
    block = states[group * per:(group + 1) * per]
    coefs, params, nt, ns, cull = stack_packs(
        scene, block, height, width, aspect, tri_clusters, sph_clusters,
        t_subs, cull, base)
    return states[-1], entry_bands(
        coefs, params, nt, ns, block, sky_pack, sky_h, sky_w, entry=row,
        n=n_rows, height=height, width=width, interleave=interleave,
        cull=cull)
