"""Entry points of the PyTorch/CUDA port for a compile-and-shard check
(port of __graft_entry__.py).

entry(device) — a single-device forward step (the one-shot full frame
render) on small shapes: returns (fn, args); fn(*args) renders the frame on
`device`.

dryrun_multichip(n, device) — the full frame step (input → state machine →
row-sharded raytrace + FXAA, each entry recomputing its halo rows, then
the gather) over an n-device mesh on tiny shapes, again with strided sub-bands, then the frame-parallel and
the (frames, rows) hybrid offline paths over the same devices. The mesh is
n distinct cards where the machine has them, else n entries of the one
device (parallel/mesh.py: bands then run one after another). Beyond the
shapes, every sharded, frame-parallel and hybrid frame must equal the
single-device frame bit for bit.

Both run on the first CUDA card unless device="cpu" is passed, and raise
where there is no card: nothing falls back.

  python __torch_entry__.py [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

SKY_SHAPE = (64, 128)


def _device(device) -> torch.device:
    from raytracing_cuda_tpu_torch.parallel.mesh import as_device

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but "
                           f"torch.cuda.is_available() is False")
    return as_device(device)


def _setup(device, sky_shape=SKY_SHAPE):
    """(scene, settled initial state, the four panoramas), all on
    `device`."""
    from raytracing_cuda_tpu_torch.core.types import to_device
    from raytracing_cuda_tpu_torch.scene.builders import build_scene
    from raytracing_cuda_tpu_torch.scene.textures import procedural_skies
    from raytracing_cuda_tpu_torch.sim import state as sim

    sky = torch.from_numpy(procedural_skies(*sky_shape)).to(device)
    return (to_device(build_scene(), device),
            sim.settle(sim.init_state(device)), sky)


def entry(device="cuda"):
    """Returns (fn, example_args): the forward frame step on one device,
    render_frame at 144x256 with a 64x128 sky on the megakernel path."""
    from raytracing_cuda_tpu_torch.render.pipeline import render_frame
    from raytracing_cuda_tpu_torch.scene.builders import (
        ISLAND_SPH_CLUSTERS, ISLAND_TRI_CLUSTERS, ISLAND_TRI_SUBS)

    scene, state, sky = _setup(_device(device))
    height, width, chunk = 144, 256, 9216

    def fn(scene, state, sky_texels):
        return render_frame(scene, state, sky_texels, height, width,
                            chunk=chunk, path="auto",
                            tri_clusters=ISLAND_TRI_CLUSTERS,
                            sph_clusters=ISLAND_SPH_CLUSTERS,
                            t_subs=ISLAND_TRI_SUBS)

    return fn, (scene, state, sky)


def _mesh(n_devices: int, device: torch.device) -> list:
    """n distinct cards where they exist, else n entries of `device`."""
    from raytracing_cuda_tpu_torch.parallel.mesh import make_mesh

    if device.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return make_mesh(n_devices)
    return [device] * n_devices


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One full frame step sharded over an n-device mesh on tiny shapes,
    then frame DP and the hybrid, each against the single-device frame."""
    from raytracing_cuda_tpu_torch.parallel.frames import (
        render_script_dp, render_script_hybrid)
    from raytracing_cuda_tpu_torch.parallel.mesh import (render_frame_sharded,
                                                         replicate)
    from raytracing_cuda_tpu_torch.render.pipeline import (
        pack_actions, render_frame_static_sky)
    from raytracing_cuda_tpu_torch.scene.builders import (
        ISLAND_SPH_CLUSTERS, ISLAND_TRI_CLUSTERS, ISLAND_TRI_SUBS)
    from raytracing_cuda_tpu_torch.scene.textures import pack_sky_all
    from raytracing_cuda_tpu_torch.sim import state as sim
    from raytracing_cuda_tpu_torch.sim.actions import Action

    device = _device(device)
    mesh = _mesh(n_devices, device)
    scene, state, sky = _setup(mesh[0])
    sky_h, sky_w = sky.shape[1:3]
    height, width = 16 * n_devices, 128
    sky_packs = replicate(pack_sky_all(sky), mesh)
    clusters = dict(tri_clusters=ISLAND_TRI_CLUSTERS,
                    sph_clusters=ISLAND_SPH_CLUSTERS, t_subs=ISLAND_TRI_SUBS)

    def single(st):
        """The frame of state st on one device: what every path must give."""
        return render_frame_static_sky(scene, st, sky_packs[mesh[0]], sky_h,
                                       sky_w, height, width, **clusters)

    # the full step: the state machine, then the megakernel row-sharded
    # over the mesh, each entry with the halo rows its FXAA reads, from the
    # static all-panorama sky stack
    action = Action.idle()._replace(move_forward=np.int32(1),
                                    mouse_dx=np.float32(1.0))
    state = sim.animate(state, action, 1 / 60)
    img = render_frame_sharded(scene, state, sky_packs, sky_h, sky_w,
                               mesh=mesh, height=height, width=width,
                               **clusters)
    assert img.shape == (height, width, 3) and img.dtype == torch.uint8
    want = single(state)
    assert torch.equal(img, want), "row-sharded frame != single-device frame"

    # strided sub-bands (device d renders chunks d, d + n, …)
    img2 = render_frame_sharded(scene, state, sky_packs, sky_h, sky_w,
                                mesh=mesh, height=height, width=width,
                                interleave=2, **clusters)
    assert img2.shape == (height, width, 3)
    assert torch.equal(img2, want), "interleave=2 frame != single-device frame"

    # the frames of `action` repeated from `state`, one by one on one
    # device: what the offline paths below must give
    nf = max(n_devices // 4, 1)
    nr = n_devices // nf
    st, seq, clocks = state, [], []
    for _ in range(max(n_devices, nf * 2)):
        st = sim.animate(st, action, 1 / 60)
        seq.append(single(st))
        clocks.append(st.day_time)
    seq = torch.stack(seq)

    # frame-data-parallel offline path: the frame batch sharded over the
    # same devices, the throughput complement of the row-sharded path
    avs = pack_actions([action] * n_devices, [1 / 60] * n_devices)
    imgs, last = render_script_dp(scene, state, sky_packs, sky_h, sky_w, avs,
                                  mesh=mesh, height=height, width=width,
                                  **clusters)
    assert imgs.shape == (n_devices, height, width, 3)
    assert torch.equal(imgs, seq[:n_devices]), (
        "frame-DP frames != sequential frames")
    assert torch.equal(last.day_time, clocks[n_devices - 1])

    # 2-D (frames, rows) hybrid: frame DP composed with the row-sharded
    # band renderer and strided sub-bands
    avs_h = pack_actions([action] * (nf * 2), [1 / 60] * (nf * 2))
    imgs_h, _ = render_script_hybrid(
        scene, state, sky_packs, sky_h, sky_w, avs_h,
        mesh=[mesh[g * nr:(g + 1) * nr] for g in range(nf)], height=height,
        width=width, interleave=2, **clusters)
    assert imgs_h.shape == (nf * 2, height, width, 3)
    assert torch.equal(imgs_h, seq[:nf * 2]), (
        "hybrid frames != sequential frames")
    print(f"dryrun_multichip({n_devices}): ok — frame {tuple(img.shape)} "
          f"mean={img.float().mean().item():.1f} (interleave=2 ok, "
          f"frame-dp {imgs.shape[0]} frames ok, "
          f"hybrid {nf}x{nr} ok; every frame equals the single-device "
          f"frame) on {[str(d) for d in dict.fromkeys(mesh)]}")


if __name__ == "__main__":
    import argparse

    from raytracing_cuda_tpu_torch.utils.timing import device_sync

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), cuda:N or cpu")
    dev = ap.parse_args().device
    dryrun_multichip(8, dev)
    fn, args = entry(dev)
    out = fn(*args)
    device_sync(out.device)
    print("entry: ok", tuple(out.shape), out.dtype)
