"""The port's parallel/ on the CPU: meshes of ["cpu"] * n (plain kernels).

  - render_frame_sharded over n in {2, 4, 8} bands, interleave 2, FXAA on
    and off, and the sharded Engine: bit for bit (torch.equal) the port's
    single-device frame, the JAX package's own contract (mesh.py:192-194);
  - against the JAX render_frame_sharded (interpret mode, flat sky pack) on
    the conftest's virtual CPU devices: the golden contract of
    tests/test_golden.py:82-86, RMSE < 2e-3 and < 0.3 % of pixels off by
    more than 2 levels (the port's frames are the same for every n, and so
    are the JAX package's, tests/test_parallel.py);
  - the FXAA band form: fxaa_ext_torch on bands with row0 != 0 against the
    jitted JAX fxaa_ext, at most 1 level (tests/test_torch_fxaa.py states
    why), and bands assembled against the full-frame fxaa_torch, bit for bit;
  - render_script_dp and render_script_hybrid (K = 4) against the port's
    step_and_frame sequence, bit for bit, and against the JAX versions in
    interpret mode, under the golden contract;
  - the errors, the device meshes and `record --dp/--dp-rows`.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_cuda_tpu.parallel import frames as jframes
from raytracing_cuda_tpu.parallel.mesh import (make_mesh as jax_make_mesh,
                                               render_frame_sharded as
                                               jax_render_frame_sharded)
from raytracing_cuda_tpu.render import fxaa as jfx
from raytracing_cuda_tpu.scene import builders as jb
from raytracing_cuda_tpu.scene.textures import (procedural_skies,
                                                sky_static_init)
from raytracing_cuda_tpu.sim import state as jsim
from raytracing_cuda_tpu.sim.actions import Action as JAction
from chip_smoke import (CASES, GOLDEN_OFF_FRAC, GOLDEN_RMSE, golden_stats,
                        halo_bands, make_state)
from raytracing_cuda_tpu_torch import _build, interop
from raytracing_cuda_tpu_torch.__main__ import main as cli_main
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.parallel import frames as F
from raytracing_cuda_tpu_torch.parallel import mesh as M
from raytracing_cuda_tpu_torch.render import fxaa as tfx
from raytracing_cuda_tpu_torch.sim.actions import Action as TAction
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.images import load_png
from test_torch_sim import jax_fields

torch.set_num_threads(2)

# widths that are multiples of 16: every band's pixel count then leaves the
# same (empty) scalar tail as the full frame in ATen's vectorised CPU
# loops, so asin/atan2 in the sky lookup round alike in bands and frame
H, W = 64, 128
SKY = (32, 64)
K = 4
DT = 0.25
START_DAY = 8.5          # the 8-10 h crossfade: two panoramas per texel
ACTIONS = [dict(mouse_dx=np.float32(30.0), time_control=np.int32(1)),
           dict(move_forward=np.int32(1), set_aa_off=np.bool_(True)),
           dict(time_control=np.int32(1), set_aa_on=np.bool_(True)),
           dict(mouse_dx=np.float32(-20.0))]
CLUSTERS = dict(tri_clusters=jb.ISLAND_TRI_CLUSTERS,
                sph_clusters=jb.ISLAND_SPH_CLUSTERS,
                t_subs=jb.ISLAND_TRI_SUBS)


def small_engine(**kw) -> Engine:
    sharded = kw.pop("sharded", False)
    return Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY,
                               **kw), device="cpu", sharded=sharded)


def golden_ok(img, ref):
    rmse, off = golden_stats(np.asarray(img), np.asarray(ref))
    assert rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC, (rmse, off)


def port_vecs():
    return np.stack([TAction.idle()._replace(**a).pack(DT) for a in ACTIONS])


@pytest.fixture(scope="module")
def start():
    """The start state in both packages, and a port engine holding it."""
    jst = jsim.settle(jsim.init_state()._replace(
        day_time=jnp.float32(START_DAY)))
    tst = interop.state_from_numpy(jax_fields(jst))
    eng = small_engine()
    eng.set_state(tst)
    return jst, tst, eng


@pytest.fixture(scope="module")
def single(start):
    """The port's single-device frame, FXAA on and off."""
    _, tst, eng = start
    eng.set_state(tst)
    on = eng.frame()
    eng.set_state(tst._replace(aa=torch.tensor(False)))
    off = eng.frame()
    eng.set_state(tst)
    return {True: on, False: off}


@pytest.fixture(scope="module")
def sequence(start):
    """K step_and_frame calls from the start state, and the end state."""
    _, tst, eng = start
    eng.set_state(tst)
    imgs = torch.stack([eng.step_and_frame(TAction.idle()._replace(**a), DT)
                        for a in ACTIONS])
    end = eng.state
    eng.set_state(tst)
    return imgs, end


@pytest.fixture(scope="module")
def jax_sharded(start):
    """The JAX package's row-sharded frame (4 devices, interpret mode, flat
    sky), FXAA on and off: one compile, two calls."""
    jst = start[0]
    sky = jnp.asarray(procedural_skies(*SKY))
    pack = sky_static_init(sky, grouped=False)
    out = {}
    for aa in (True, False):
        out[aa] = np.asarray(jax_render_frame_sharded(
            jb.build_scene(), jst._replace(aa=jnp.bool_(aa)), sky,
            mesh=jax_make_mesh(4), height=H, width=W,
            path="pallas_interpret", sky_pack=pack, sky_mode="flat",
            **CLUSTERS))
    return out


def packs(eng):
    """The engine's sky stack on the one CPU device, as a mesh's map."""
    return M.replicate(eng.sky_pack, ["cpu"])


def sharded(start, n, interleave=1, fxaa_static=None):
    _, tst, eng = start
    return M.render_frame_sharded(
        eng.scene, tst, packs(eng), eng.sky_h, eng.sky_w, mesh=["cpu"] * n,
        height=H, width=W, fxaa_static=fxaa_static, interleave=interleave,
        tri_clusters=eng.tri_clusters, sph_clusters=eng.sph_clusters,
        t_subs=eng.tri_subs)


@pytest.mark.parametrize("n,interleave,aa", [
    (2, 1, True), (4, 1, True), (8, 1, True), (4, 2, True), (2, 4, True),
    (4, 1, False), (8, 2, False)])
def test_sharded_matches_single_device_and_jax(start, single, jax_sharded,
                                               n, interleave, aa):
    img = sharded(start, n, interleave, fxaa_static=aa)
    assert img.shape == (H, W, 3) and img.dtype == torch.uint8
    assert torch.equal(img, single[aa]), (
        f"{(img != single[aa]).any(-1).float().mean():.4%} pixels differ")
    golden_ok(img.numpy(), jax_sharded[aa])


def test_sharded_engine_matches_single_device(start, sequence):
    _, tst, _ = start
    seq, end = sequence
    eng = small_engine(sharded=["cpu"] * 4, shard_interleave=2)
    eng.set_state(tst)
    for k, a in enumerate(ACTIONS):
        assert torch.equal(eng.step_and_frame(TAction.idle()._replace(**a),
                                              DT), seq[k]), k
    eng.set_state(tst)
    assert torch.equal(eng.step_and_frame_batch(port_vecs()), seq)
    assert torch.equal(eng.state.day_time, end.day_time)
    big = eng.resized(W, 2 * H)
    assert big.mesh == eng.mesh and big.sky_pack is eng.sky_pack
    assert big.frame().shape == (2 * H, W, 3)
    with pytest.raises(ValueError, match="alternative"):
        eng.render_script_dp(port_vecs())


def test_sharded_engine_on_one_device_degrades_with_warning(start, single):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng = small_engine(sharded=True, shard_interleave=7)
    assert any("shard_interleave" in str(w.message) for w in rec)
    assert eng.mesh is None
    eng.set_state(start[1])
    assert torch.equal(eng.frame(), single[True])


def test_degraded_sharded_engine_allows_frame_dp(start, sequence):
    """sharded=True on one device splits nothing, so frame DP stays open
    (the JAX Engine refuses it only with a mesh in use, loop.py:338)."""
    seq, end = sequence
    eng = small_engine(sharded=True)
    assert eng.mesh is None
    eng.set_state(start[1])
    acts = [TAction.idle()._replace(**a) for a in ACTIONS]
    assert torch.equal(eng.render_script_dp(acts, dt=DT, mesh=["cpu"] * 2),
                       seq)
    assert torch.equal(eng.state.cam.pos, end.cam.pos)


@pytest.fixture(scope="module")
def pre_fxaa():
    """Pre-FXAA frames of the four golden states, from the port."""
    eng = small_engine(antialiasing=False)
    out = []
    for kw in CASES.values():
        eng.set_state(make_state(**dict(kw, aa=False)))
        out.append(eng.frame())
    return out


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fxaa_band_form(pre_fxaa, n):
    ref_ext = jax.jit(jfx.fxaa_ext, static_argnames=("total_height",))
    for img in pre_fxaa:
        outs = []
        for row0, ext in halo_bands(img, n):
            out = tfx.fxaa_ext_torch(ext, row0, H)
            ref = np.asarray(ref_ext(jnp.asarray(ext.numpy()), row0,
                                     total_height=H))
            assert np.abs(out.numpy().astype(int) - ref.astype(int)).max() <= 1
            assert torch.equal(tfx.fxaa_ext(ext, row0, H), out)
            outs.append(out)
        assert torch.equal(torch.cat(outs), tfx.fxaa_torch(img))
    # the K-frame band form filters each frame's band
    row0, ext = list(halo_bands(pre_fxaa[0], n))[1]
    stack = torch.stack([ext, ext.flip(1), 255 - ext])
    assert torch.equal(tfx.fxaa_ext(stack, row0, H),
                       torch.stack([tfx.fxaa_ext_torch(e, row0, H)
                                    for e in stack]))


def test_band_halos_at_frame_borders_are_never_read():
    img = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (18, 32, 3)).astype(np.uint8))
    junk = img.clone()
    junk[0] = 255 - junk[0]
    junk[-1] = 255 - junk[-1]
    for ext in (img, junk):         # a whole 16-row frame as one band
        assert torch.equal(tfx.fxaa_ext_torch(ext, 0, 16),
                           tfx.fxaa_torch(img[1:-1]))


@pytest.fixture(scope="module")
def jax_script(start):
    """The JAX frame-DP and hybrid renders of the script (interpret)."""
    jst = start[0]
    pack = sky_static_init(jnp.asarray(procedural_skies(*SKY)),
                           grouped=False)
    vecs = jnp.asarray(np.stack([JAction.idle()._replace(**a).pack(DT)
                                 for a in ACTIONS]))
    common = dict(sky_h=SKY[0], sky_w=SKY[1], height=H, width=W,
                  interpret=True, **CLUSTERS)
    dp, _ = jframes.render_script_dp(
        jb.build_scene(), jst, pack, vecs, mesh=jframes.make_frames_mesh(2),
        **common)
    hy, _ = jframes.render_script_hybrid(
        jb.build_scene(), jst, pack, vecs,
        mesh=jframes.make_hybrid_mesh(2, 2), sky_mode="flat", **common)
    return {"dp": np.asarray(dp), "hybrid": np.asarray(hy)}


@pytest.mark.parametrize("kind,mesh,interleave", [
    ("dp", ["cpu"] * 2, 1), ("dp", ["cpu"] * 4, 1),
    ("hybrid", [["cpu"] * 2] * 2, 1), ("hybrid", [["cpu"] * 2] * 2, 2),
    ("hybrid", [["cpu"] * 4], 1)])
def test_script_matches_sequence_and_jax(start, sequence, jax_script, kind,
                                         mesh, interleave):
    _, tst, eng = start
    seq, end = sequence
    kw = dict(mesh=mesh, height=H, width=W, tri_clusters=eng.tri_clusters,
              sph_clusters=eng.sph_clusters, t_subs=eng.tri_subs)
    if kind == "dp":
        imgs, last = F.render_script_dp(eng.scene, tst, packs(eng),
                                        eng.sky_h, eng.sky_w, port_vecs(),
                                        **kw)
    else:
        imgs, last = F.render_script_hybrid(eng.scene, tst, packs(eng),
                                            eng.sky_h, eng.sky_w,
                                            port_vecs(),
                                            interleave=interleave, **kw)
    assert torch.equal(imgs, seq)
    assert torch.equal(last.day_time, end.day_time)
    assert torch.equal(last.cam.pos, end.cam.pos)
    for k in range(K):
        golden_ok(imgs[k].numpy(), jax_script[kind][k])


@pytest.mark.parametrize("n_rows,mesh", [(1, None), (2, None),
                                         (1, ["cpu"] * 4),
                                         (2, [["cpu"] * 2] * 2)])
def test_engine_render_script_dp(start, sequence, n_rows, mesh):
    _, tst, _ = start
    seq, end = sequence
    eng = small_engine(shard_interleave=2)
    eng.set_state(tst)
    acts = [TAction.idle()._replace(**a) for a in ACTIONS]
    imgs = eng.render_script_dp(acts, dt=DT, n_rows=n_rows, mesh=mesh)
    assert torch.equal(imgs, seq)
    assert torch.equal(eng.state.cam.pos, end.cam.pos)


def test_errors(start):
    _, tst, eng = start
    with pytest.raises(ValueError, match="divisible"):
        M.render_frame_sharded(eng.scene, tst, packs(eng), eng.sky_h,
                               eng.sky_w, mesh=["cpu"] * 8, height=60,
                               width=W)
    for il in (0, -1):
        with pytest.raises(ValueError, match="interleave"):
            M.render_frame_sharded(eng.scene, tst, packs(eng), eng.sky_h,
                                   eng.sky_w, mesh=["cpu"] * 2, height=H,
                                   width=W, interleave=il)
    with pytest.raises(ValueError, match="interleave"):
        sharded(start, 4, interleave=3)              # 64 % 12 != 0
    common = dict(height=H, width=W)
    with pytest.raises(ValueError, match="divisible"):
        F.render_script_dp(eng.scene, tst, packs(eng), eng.sky_h,
                           eng.sky_w, port_vecs()[:3], mesh=["cpu"] * 2,
                           **common)
    with pytest.raises(ValueError, match="divisible"):
        F.render_script_hybrid(eng.scene, tst, packs(eng), eng.sky_h,
                               eng.sky_w, port_vecs()[:3],
                               mesh=[["cpu"]] * 2, **common)
    with pytest.raises(ValueError, match="divisible"):
        F.render_script_hybrid(eng.scene, tst, packs(eng), eng.sky_h,
                               eng.sky_w, port_vecs(), mesh=[["cpu"] * 3],
                               **common)
    with pytest.raises(ValueError, match="divisible"):
        small_engine(sharded=["cpu"] * 3)
    with pytest.raises(ValueError, match=">= 1"):
        F.make_hybrid_mesh(0, 2, "cpu")
    with pytest.raises(ValueError):
        M.as_mesh([])
    with pytest.raises(ValueError, match="shard_interleave"):
        RenderConfig(shard_interleave=0)


def test_cpu_meshes():
    assert M.make_mesh(device_type="cpu") == [torch.device("cpu")]
    assert M.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert F.make_hybrid_mesh(2, 3, "cpu") == [[torch.device("cpu")] * 3] * 2
    with pytest.raises(ValueError):
        M.make_mesh(2, "meta")


@pytest.fixture
def one_card(monkeypatch):
    """torch.cuda as a machine with one card shows it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


def test_cuda_mesh_larger_than_card_count(one_card):
    assert M.make_mesh() == [torch.device("cuda", 0)]
    for make in (lambda: M.make_mesh(2), lambda: F.make_frames_mesh(2),
                 lambda: F.make_hybrid_mesh(1, 2),
                 lambda: F.make_hybrid_mesh(2, 1)):
        with pytest.raises(ValueError, match="only 1 available"):
            make()


def test_record_dp_on_one_card_fails_before_any_frame(one_card, tmp_path,
                                                      monkeypatch):
    def no_engine(*a, **k):
        raise AssertionError("an engine was built")

    monkeypatch.setattr(Engine, "__init__", no_engine)
    out = tmp_path / "frames"
    for flags in (["--dp", "2"], ["--dp-rows", "2"]):
        with pytest.raises(SystemExit, match="only 1 available") as e:
            cli_main(["record", str(out), "--frames", "4", "--path", "cuda",
                      "--size", "128x64", *flags])
        assert e.value.code not in (0, None)
    assert not out.exists()


def test_cpu_wrappers_never_build_or_count(start, monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    before = (tfx.fxaa_ext.launches, tfx.fxaa_ext.frames)
    sharded(start, 2)
    assert (tfx.fxaa_ext.launches, tfx.fxaa_ext.frames) == before


SMALL = ["--size", "128x64", "--sky-shape", "64x32", "--path", "plain"]


@pytest.mark.parametrize("flags", [["--dp", "2", "--dp-rows", "2"],
                                   ["--dp", "2"]], ids=["hybrid", "dp"])
def test_cli_record_dp_writes_the_plain_record_frames(tmp_path, flags):
    """6 frames: one batch of 4 over the mesh, then 2 single steps."""
    plain, dp = str(tmp_path / "plain"), str(tmp_path / "dp")
    assert cli_main(["record", plain, "--frames", "6", *SMALL]) == 0
    assert cli_main(["record", dp, "--frames", "6", *SMALL, *flags]) == 0
    names = sorted(os.listdir(plain))
    assert names == sorted(os.listdir(dp)) == [f"{i:04d}.png"
                                               for i in range(6)]
    for name in names:
        assert np.array_equal(load_png(os.path.join(dp, name)),
                              load_png(os.path.join(plain, name))), name
