"""Row-band sharding of a frame over a list of devices (port of
raytracing_cuda_tpu/parallel/mesh.py).

The JAX package shards the framebuffer by row bands over a
jax.sharding.Mesh with shard_map: every device steps the replicated state,
raytraces its band with the band's global row offset in the megakernel's
params, and the FXAA stencil reads one halo row from each neighbouring
band through lax.ppermute. Here a mesh is a list of torch.devices, one
entry per band slot, run from one process. A device may repeat: ["cpu"] *
n stands in for the JAX tests' virtual CPU devices, ["cuda:0"] * n runs n
bands one after another on one card.

Each mesh entry renders its own rows on its own device, with no exchange
(`entry_bands`; the Engine's sharded path runs it as one CUDA graph per
entry on a card, app/loop.py): its chunks entry, entry + n, …, each
rendered by kernel A with one halo row above and one below recomputed,
then the sky lookup and quantize, and kernel B's band form on the halo'd
band. Rays come from global rows, so a recomputed halo row equals the
neighbouring chunk's edge row bit for bit and there is nothing to
exchange. `place_bands` then copies each entry's rows into the frame (the
gather, one copy per entry), which equals the single-device frame bit for
bit (the JAX package's contract, mesh.py:192-194). `render_frame_sharded`
packs the frame once and runs every entry so.

A band of a `fast` or `oracle` frame runs no megakernel: the entry derives
the frame and blends the sky on its device and renders its chunks and
their halo rows with `render_base_image_fast` at their global rows
(`entry_bands_plain`; the JAX package renders the fast renderer in bands
for `path="oracle"` too, mesh.py:115-118), the early exits masked where a
CUDA graph captures it.

The JAX package's grouped sky resolve, and with it the band alignment rule
of `_resolve_grouped`, is left behind: the port's sky lookup is per pixel.
"""

from __future__ import annotations

import ctypes
import os

import torch

from raytracing_cuda_tpu_torch.core.math3d import true_div
from raytracing_cuda_tpu_torch.core.types import Scene, to_device
from raytracing_cuda_tpu_torch.render.fast import render_base_image_fast
from raytracing_cuda_tpu_torch.render.fxaa import fxaa_batch, fxaa_ext
from raytracing_cuda_tpu_torch.render.pipeline import (PLAIN_RENDERERS,
                                                       bases_from_packs,
                                                       frame_packs)
from raytracing_cuda_tpu_torch.scene.textures import blend_sky
from raytracing_cuda_tpu_torch.sim.state import (FrameState, camera_rays,
                                                 derive_frame, state_to)


def as_device(d) -> torch.device:
    """d as a torch.device; a CUDA device names its card (the current one
    where d names none), so devices compare equal to tensors' devices."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def as_mesh(devices) -> list:
    """A list of devices (names or torch.devices) → torch.devices, each CUDA
    device with its index; all of one type."""
    mesh = [as_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in mesh}) > 1:
        raise ValueError(f"a mesh holds devices of one type, got {mesh}")
    return mesh


def devices(n: int | None, device_type: str, what: str) -> list:
    """n devices of a type for `what`: the first n distinct CUDA cards (all
    of them when n is None), failing fast where fewer exist; on the CPU n
    entries of the one CPU device (one when n is None)."""
    if device_type == "cpu":
        n = 1 if n is None else n
        have = n
    elif device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n is None else n
    else:
        raise ValueError(f"no mesh of {device_type!r} devices")
    if n < 1:
        raise ValueError(f"{what} needs at least one device, got {n}")
    if have < n:
        raise ValueError(f"{what} over {n} {device_type} devices requested "
                         f"but only {have} available")
    if device_type == "cpu":
        return [torch.device("cpu")] * n
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None,
              device_type: str = "cuda") -> list:
    """Row mesh over the first n_devices devices of a type (devices())."""
    return devices(n_devices, device_type, "row sharding")


def replicate(t: torch.Tensor, mesh) -> dict:
    """One copy of t on each distinct device of mesh (t itself where it
    already lies) → {device: tensor}."""
    return {d: t if t.device == d else t.to(d)
            for d in dict.fromkeys(as_mesh(mesh))}


def band_rows(height: int, n: int, interleave: int) -> int:
    """Rows per chunk when n devices take `interleave` chunks each."""
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if height % (n * interleave):
        raise ValueError(f"height {height} not divisible by mesh size {n} "
                         f"x interleave {interleave}")
    return height // (n * interleave)


def entry_bands(coefs, params, n_tri_rows: int, n_sph_rows: int, states,
                sky_pack, sky_h: int, sky_w: int, *, entry: int, n: int,
                height: int, width: int, interleave: int = 1,
                cull=None) -> torch.Tensor:
    """Mesh entry `entry` of n: its rows of K frames, filtered, with no
    exchange → (K, interleave, sub, width, 3) uint8 on the device of
    `coefs`, chunk entry + j * n at [:, j].

    coefs (K, n, C), params (K, P), `cull`, `sky_pack` and the K states lie
    on that device. Each chunk's rows and one halo row above and below
    (none beyond the frame's top or bottom, where a zero row stands in and
    is never read) are one launch of kernel A's band form, then the sky
    lookup and quantize (bases_from_packs); kernel B's band form filters
    the halo'd band and each frame's `aa` flag picks FXAA or the base rows
    on the device. Rays come from global rows, so the halo rows equal the
    neighbouring chunks' edge rows bit for bit: recomputing them replaces
    the JAX package's halo exchange. One chunk (n * interleave == 1) is the
    whole frame, filtered by kernel B's K-frame form."""
    def render(lo: int, hi: int):
        return bases_from_packs(coefs, params, n_tri_rows, n_sph_rows,
                                sky_pack, sky_h, sky_w, states, hi - lo,
                                width, row0=lo, total_h=height, cull=cull)

    return _entry_rows(render, torch.stack([st.aa for st in states]),
                       entry, n, height, interleave)


def _entry_rows(render, aa, entry: int, n: int, height: int,
                interleave: int) -> torch.Tensor:
    """The rows of mesh entry `entry` of n, filtered, with no exchange:
    render(lo, hi) → the K frames' rows lo..hi - 1 before FXAA, (K, hi - lo,
    W, 3) uint8, called once per chunk of the entry for the chunk's rows and
    its halo rows; aa (K,) bool → (K, interleave, sub, W, 3) uint8, chunk
    entry + j * n at [:, j] (entry_bands)."""
    sub = band_rows(height, n, interleave)
    chunks = n * interleave
    aa = aa[:, None, None, None]
    outs = []
    for j in range(interleave):
        c = j * n + entry
        base = render(max(c * sub - 1, 0), min((c + 1) * sub + 1, height))
        if chunks == 1:
            out = fxaa_batch(base)
        else:
            zero = torch.zeros_like(base[:, :1])
            ext = torch.cat([zero] * (c == 0) + [base]
                            + [zero] * (c == chunks - 1), dim=1)
            out = fxaa_ext(ext, c * sub, height)
            base = ext[:, 1:-1]
        outs.append(torch.where(aa, out, base))
    return torch.stack(outs, dim=1) if interleave > 1 else outs[0][:, None]


def entry_bands_plain(scene: Scene, state: FrameState,
                      sky_texels: torch.Tensor, *, entry: int, n: int,
                      height: int, width: int, chunk: int = 32768,
                      aspect: float | None = None, interleave: int = 1,
                      early_exit: bool = True) -> torch.Tensor:
    """Mesh entry `entry` of n on the `fast` and `oracle` paths: its rows of
    the frame of `state`, filtered, with no exchange → (1, interleave, sub,
    width, 3) uint8 on the device of `sky_texels` (the four panoramas,
    (4, H, W, 3) uint8), where `scene` and `state` lie too.

    The entry derives the frame and blends the sky on its own device, then
    renders each of its chunks' rows and their halo rows with
    render_base_image_fast at their global rows (the fast renderer on both
    paths, as mesh.py:115-118 of the JAX package),
    and filters them as entry_bands does. early_exit as in
    render_base_image_fast: False reads nothing back, so a CUDA graph can
    capture the entry."""
    if aspect is None:
        aspect = width / height
    scene_f, lights, ambient = derive_frame(scene, state)
    rays = camera_rays(state.cam, aspect)
    blended = blend_sky(sky_texels, state.sky_vars)
    day_frac = true_div(state.day_time, 24.0)

    def render(lo: int, hi: int):
        return render_base_image_fast(
            scene_f, lights, ambient, blended, day_frac, rays, hi - lo,
            width, row0=lo, total_height=height, chunk=chunk,
            early_exit=early_exit)[None]

    return _entry_rows(render, state.aa.reshape(1), entry, n, height,
                       interleave)


def place_bands(frames: torch.Tensor, bands: torch.Tensor, entry: int,
                n: int) -> None:
    """The gather: write entry_bands' rows of mesh entry `entry` of n,
    (K, interleave, sub, W, 3), into the K frames (K, H, W, 3), contiguous,
    on any device. The entry's chunks lie at one stride in the frames
    (chunk j * n + entry of frame k at block k * interleave + j of the
    frames' n-row-band view), so this is one copy: a plain one where those
    rows are contiguous, else, between CUDA tensors, one 2-D memcpy
    (copy_rows) and not a copy kernel."""
    K, il, sub = bands.shape[:3]
    dst = frames.view(K * il, n, sub, *frames.shape[2:])[:, entry]
    src = bands.reshape(K * il, sub, *bands.shape[3:])
    if dst.is_contiguous() or "cpu" in (dst.device.type, src.device.type):
        dst.copy_(src, non_blocking=True)
    else:
        copy_rows(dst, src)


_CUDART: dict = {}


def _cudart() -> ctypes.CDLL:
    """The CUDA runtime PyTorch loaded (found by its soname; the toolkit's
    where PyTorch links it statically), for the 2-D copy PyTorch does not
    issue."""
    if "lib" not in _CUDART:
        try:
            lib = ctypes.CDLL(
                f"libcudart.so.{torch.version.cuda.split('.')[0]}")
        except OSError:
            lib = ctypes.CDLL(os.path.join(
                os.environ.get("CUDA_HOME", "/usr/local/cuda"), "lib64",
                "libcudart.so"))
        lib.cudaMemcpy2DAsync.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_void_p]
        lib.cudaMemcpy2DAsync.restype = ctypes.c_int
        lib.cudaGetErrorString.argtypes = [ctypes.c_int]
        lib.cudaGetErrorString.restype = ctypes.c_char_p
        _CUDART["lib"] = lib
    return _CUDART["lib"]


CUDA_MEMCPY_DEFAULT = 4     # cudaMemcpyDefault: the pointers say where


def copy_rows(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst ← src between CUDA tensors of one shape and type (B, ...), each
    [b] a contiguous block and the blocks at a uniform stride: one
    cudaMemcpy2DAsync (local, or peer between cards) on the source device's
    current stream, ordered as Tensor.copy_ orders a copy between devices:
    after the work queued on both devices' current streams, and before
    what is queued on the destination's next."""
    if (dst.shape != src.shape or dst.dtype != src.dtype
            or not (dst[0].is_contiguous() and src[0].is_contiguous())):
        raise ValueError(f"copy_rows takes blocks of one shape and type, "
                         f"got {tuple(dst.shape)} {dst.dtype} and "
                         f"{tuple(src.shape)} {src.dtype}")
    size = dst.element_size()
    other = dst.device != src.device
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device)
        if other:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dst.device))
            stream.wait_event(ready)
        lib = _cudart()
        err = lib.cudaMemcpy2DAsync(
            dst.data_ptr(), dst.stride(0) * size, src.data_ptr(),
            src.stride(0) * size, src[0].numel() * size, src.shape[0],
            CUDA_MEMCPY_DEFAULT, stream.cuda_stream)
        if err:
            raise RuntimeError(f"cudaMemcpy2DAsync failed: "
                               f"{lib.cudaGetErrorString(err).decode()}")
        if other:
            done = torch.cuda.Event()
            done.record(stream)
            torch.cuda.current_stream(dst.device).wait_event(done)


def render_frame_sharded(scene: Scene, state: FrameState, sky_packs: dict,
                         sky_h: int, sky_w: int, *, mesh, height: int,
                         width: int, aspect: float | None = None,
                         fxaa_static: bool | None = None, interleave: int = 1,
                         tri_clusters=None, sph_clusters=None,
                         t_subs=None, path: str = "auto", sky_texels=None,
                         chunk: int = 32768) -> torch.Tensor:
    """Row-sharded render of one frame → (height, width, 3) uint8 on
    mesh[0], equal bit for bit to the single-device frame of `path`: each
    entry's rows rendered on its device, then gathered by place_bands.

    path "auto" (the megakernel): the frame is packed once on the scene's
    device and the packs copied to each entry's, which runs entry_bands;
    sky_packs maps each device of mesh to its copy of the static (4, H*W)
    sky stack (replicate), and the frame equals render_frame_static_sky's.
    Paths "fast" and "oracle" run entry_bands_plain on each entry's device
    (the early exits decided on the host), blending the panoramas from
    sky_texels ((4, H, W, 3) uint8 on any device) like render_frame, and
    read neither sky_packs nor the cluster arguments; both render the fast
    renderer in their bands. fxaa_static overrides the state's FXAA toggle.
    interleave = k > 1 gives each device k strided chunks instead of one
    contiguous band (mesh.py:200-209)."""
    mesh = as_mesh(mesh)
    n = len(mesh)
    band_rows(height, n, interleave)
    if fxaa_static is not None:
        state = state._replace(aa=torch.tensor(bool(fxaa_static)))
    if path in PLAIN_RENDERERS:
        def rows(entry, d):
            return entry_bands_plain(
                to_device(scene, d), state_to(state, d), sky_texels.to(d),
                entry=entry, n=n, height=height, width=width, chunk=chunk,
                aspect=aspect, interleave=interleave)
    elif path == "auto":
        coef, params, nt, ns, cull = frame_packs(scene, state, height, width,
                                                 aspect, tri_clusters,
                                                 sph_clusters, t_subs)

        def rows(entry, d):
            return entry_bands(coef[None].to(d), params[None].to(d), nt, ns,
                               [state_to(state, d)], sky_packs[d], sky_h,
                               sky_w, entry=entry, n=n, height=height,
                               width=width, interleave=interleave,
                               cull=cull.to(d))
    else:
        raise ValueError(f"path must be 'auto', 'fast' or 'oracle', got "
                         f"{path!r}")
    frame = torch.empty((1, height, width, 3), dtype=torch.uint8,
                        device=mesh[0])
    for entry, d in enumerate(mesh):
        place_bands(frame, rows(entry, d), entry, n)
    return frame[0]
