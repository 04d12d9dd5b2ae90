"""The megakernel's diagnostic arms, the probes that use them, and the
reference-sky source, on the CPU.

  - The port's plain arms (render/cuda_rt.py parse_ablate) against the JAX
    kernel's (`render_base_planes_pallas(..., interpret=True, ablate=...)`)
    at 48x96 for island_morning (day 6, the sun below the sea) and
    mountains_day, under the tolerances of tests/test_torch_raytrace.py
    (hit/miss class on < 0.3 % of pixels; RGB off by > 1/255 on < 0.3 % and
    by <= 0.5 anywhere; miss weight within 1e-6; miss direction off by
    > 1e-4 on < 1 % and by <= 0.01 anywhere). The port's `noshadow` is
    held against JAX's ("noshadow", "nohcull"): JAX's ("noshadow",) alone
    keeps its below-horizon cull on (HCULL_DEFAULT, pallas_rt.py:141,
    :577-578), whose tile-wide plane kill (:953-955) still blocks a light
    below the sea, so at day 6 it is not "lights never blocked".
  - The arms' meaning on the port, as tests/test_render_fast.py:272-304
    holds it for JAX: noshadow only brightens the hit-path RGB and leaves
    the miss planes bit for bit; noshade's RGB is exactly 0; depth4 and
    every cull arm equal the shipped function bit for bit; an unknown arm
    raises ValueError on every device.
  - One CPU run of each ported probe at a tiny size.
  - Both packages' reference-sky loaders on four synthetic panoramas.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from experiments import (megakernel_ablation_torch, readback_fps_torch,
                         tail_probe_torch, worst_pose_decompose_torch)
from raytracing_cuda_tpu.render.pallas_rt import render_base_planes_pallas
from raytracing_cuda_tpu.scene import builders as jb
from raytracing_cuda_tpu.scene import textures as jtx
from raytracing_cuda_tpu.sim import state as jsim
from raytracing_cuda_tpu_torch import interop
from raytracing_cuda_tpu_torch.render import cuda_rt as trt
from raytracing_cuda_tpu_torch.render.pipeline import frame_packs
from raytracing_cuda_tpu_torch.scene import builders as tb
from raytracing_cuda_tpu_torch.scene import textures as ttx
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils.images import save_png
from tests.test_golden import CASES, make_state
from tests.test_torch_raytrace import assert_planes_agree
from tests.test_torch_sim import jax_fields

torch.set_num_threads(2)

H, W = 48, 96
POSES = ("island_morning", "mountains_day")
# the port's arm → the JAX package's arm with the same function
JAX_ARMS = {
    "noshadow": ("noshadow", "nohcull"),
    "noshade": ("noshade",),
    "sweep_only": ("noshade", "noshadow"),
    "depth0": ("depth0",),
    "depth1": ("depth1",),
    "depth2": ("depth2",),
}
PORT_ARMS = {"noshadow": ("noshadow",), "noshade": ("noshade",),
             "sweep_only": ("noshade", "noshadow"), "depth0": ("depth0",),
             "depth1": ("depth1",), "depth2": ("depth2",)}
# arms that compute the shipped function
IDENTITY_ARMS = [("depth4",), ("nocull",), ("no_tbound",), ("nohcull",),
                 ("hcull",), ("nocull", "no_tbound")]
CSRC = Path(trt.__file__).resolve().parent.parent / "csrc"


@functools.lru_cache(maxsize=None)
def jax_planes(pose: str, arm: str) -> np.ndarray:
    """JAX interpret-mode planes (7, H, W) of an arm at a pose (each arm
    compiles once; its second pose reuses the compile)."""
    st = make_state(**CASES[pose])
    scene_f, lights, ambient = jsim.derive_frame(jb.build_scene(), st)
    rays = jsim.camera_rays(st.cam, W / H)
    return np.stack([np.asarray(p) for p in render_base_planes_pallas(
        scene_f, lights, ambient, rays, H, W, interpret=True,
        tri_clusters=jb.ISLAND_TRI_CLUSTERS,
        sph_clusters=jb.ISLAND_SPH_CLUSTERS, ablate=JAX_ARMS[arm])])


@functools.lru_cache(maxsize=None)
def packs(pose: str):
    """The port's packs of a pose at H x W, from the JAX state."""
    st = interop.state_from_numpy(jax_fields(make_state(**CASES[pose])))
    return frame_packs(tb.build_scene(), st, H, W, None,
                      tb.ISLAND_TRI_CLUSTERS, tb.ISLAND_SPH_CLUSTERS,
                      tb.ISLAND_TRI_SUBS)


def port_planes(pose: str, ablate=()) -> torch.Tensor:
    coef, params, nt, ns, _ = packs(pose)
    return torch.stack(trt.raytrace_planes_torch(coef, params, H, W, nt, ns,
                                                 ablate=ablate))


@pytest.mark.parametrize("pose", POSES)
@pytest.mark.parametrize("arm", sorted(JAX_ARMS))
def test_plain_arm_matches_pallas_interpret(arm, pose):
    ref = jax_planes(pose, arm)
    got = port_planes(pose, PORT_ARMS[arm]).numpy()
    assert got.shape == ref.shape == (7, H, W)
    assert_planes_agree(ref, got)


@pytest.mark.parametrize("pose", POSES)
def test_noshadow_brightens_hit_path_only(pose):
    full, nosh = port_planes(pose), port_planes(pose, ("noshadow",))
    assert (nosh[:3] >= full[:3] - 1e-6).all()
    assert (nosh[:3] > full[:3] + 1e-3).any()       # some shadow was lit
    assert torch.equal(nosh[3:], full[3:])


@pytest.mark.parametrize("pose", POSES)
def test_noshade_adds_nothing_and_ends_at_the_first_hit(pose):
    dark = port_planes(pose, ("noshade",))
    assert not dark[:3].any()
    # level 0 only: the miss planes are depth0's, and sweep_only is noshade
    assert torch.equal(dark[3:], port_planes(pose, ("depth0",))[3:])
    assert torch.equal(dark, port_planes(pose, ("noshade", "noshadow")))


@pytest.mark.parametrize("ablate", IDENTITY_ARMS, ids="+".join)
def test_identity_arms_equal_the_shipped_function(ablate):
    for pose in POSES:
        assert torch.equal(port_planes(pose, ablate), port_planes(pose))


def test_depth_arms_trace_fewer_levels():
    coef, params, nt, ns, cull = packs("island_morning")
    rays = {}
    for d in range(5):
        work = dict.fromkeys(trt.WORK_KEYS, 0)
        trt.raytrace_planes_torch(coef, params, H, W, nt, ns, work=work,
                                  cull=cull, ablate=(f"depth{d}",))
        rays[d] = work["rays"]
    assert rays[0] == H * W
    assert all(rays[d] < rays[d + 1] for d in range(2))
    work = dict.fromkeys(trt.WORK_KEYS, 0)
    trt.raytrace_planes_torch(coef, params, H, W, nt, ns, work=work,
                              cull=cull, ablate=("noshadow",))
    assert work["shadow"] == 0 and work["rays"] == rays[4]


def test_parse_ablate_normalises():
    p = trt.parse_ablate
    A = trt
    assert p(()) == p(("hcull",)) == p(("depth4",)) == (0, trt.MAX_DEPTH)
    assert p(("noshade", "noshadow")) == p(("noshade", "depth1")) == p(
        ("noshade", "nohcull")) == (A.ARM_NOSHADE, trt.MAX_DEPTH)
    assert p(("noshadow", "nohcull")) == (A.ARM_NOSHADOW, trt.MAX_DEPTH)
    assert p(("nocull",)) == (A.ARM_NOCULL | A.ARM_NOHCULL, trt.MAX_DEPTH)
    assert p(("depth2",)) == (0, 2)
    for bad in (("shadowless",), ("depth5",), ("depth",), ("specgate",),
                ("nospecgate",)):
        with pytest.raises(ValueError):
            p(bad)


def test_unknown_and_uninstantiated_arms_raise_on_every_wrapper():
    coef, params, nt, ns, cull = packs("island_morning")
    for bad in (("shadowless",), ("specgate",)):
        with pytest.raises(ValueError):
            trt.raytrace_planes_torch(coef, params, H, W, nt, ns,
                                      ablate=bad)
        with pytest.raises(ValueError):
            trt.raytrace_planes(coef, params, H, W, nt, ns, ablate=bad)
    # a combination the card has no instantiation for: the plain version
    # runs it, the wrappers refuse it on the CPU as they would on a card
    combo = ("noshadow", "depth1")
    trt.raytrace_planes_torch(coef, params, 8, 16, nt, ns, ablate=combo)
    for call in (lambda: trt.raytrace_planes(coef, params, H, W, nt, ns,
                                             ablate=combo),
                 lambda: trt.raytrace_planes_batch(
                     coef[None], params[None], H, W, nt, ns, ablate=combo)):
        with pytest.raises(ValueError, match="no instantiation"):
            call()


def test_cpu_wrappers_run_the_plain_arm_and_count_nothing():
    coef, params, nt, ns, cull = packs("mountains_day")
    counts = (trt.raytrace_planes.launches, trt.raytrace_planes.arm_launches,
              trt.raytrace_planes_batch.launches,
              trt.raytrace_planes_batch.arm_launches)
    ab = ("depth1",)
    one = torch.stack(trt.raytrace_planes(coef, params, H, W, nt, ns,
                                          cull=cull, ablate=ab))
    assert torch.equal(one, port_planes("mountains_day", ab))
    band = trt.raytrace_planes_batch(coef[None], params[None], 16, W, nt, ns,
                                     row0=8, total_h=H, ablate=ab)
    assert torch.equal(torch.stack(band)[:, 0], one[:, 8:24])
    assert counts == (trt.raytrace_planes.launches,
                      trt.raytrace_planes.arm_launches,
                      trt.raytrace_planes_batch.launches,
                      trt.raytrace_planes_batch.arm_launches)


def test_arm_tables_match_the_cuda_sources():
    """ARM_* and ARMS_ON_CARD are the bits of csrc/raytrace_body.cuh and
    the instantiations of csrc/raytrace_arms.cu."""
    body = (CSRC / "raytrace_body.cuh").read_text()
    bits = dict(re.findall(r"ARM_(\w+) = (\d+),", body))
    assert {k: int(v) for k, v in bits.items()} == {
        k[4:]: getattr(trt, k) for k in dir(trt)
        if re.fullmatch(r"ARM_[A-Z_]+", k) and k != "ARM_FLAGS"}
    env = {f"ARM_{k}": int(v) for k, v in bits.items()}
    env["MAX_DEPTH"] = trt.MAX_DEPTH
    arms_cu = (CSRC / "raytrace_arms.cu").read_text()
    pairs = {(eval(a, {}, env), eval(d, {}, env))
             for a, d in re.findall(r"^\s*RT_ARM\(([^,]+), ([^)]+)\)$",
                                    arms_cu, re.M)}
    assert pairs == set(trt.ARMS_ON_CARD)
    for name in megakernel_ablation_torch.ARMS.values():
        assert not name or trt.parse_ablate(name) in trt.ARMS_ON_CARD


# --- the probes, once each on the CPU ---

def _sky_dir(root: Path, h: int = 24, w: int = 48) -> Path:
    """Four synthetic panoramas from a seed: morning and evening RGBA (PIL),
    day and night RGB (the port's writer)."""
    rng = np.random.default_rng(7)
    root.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(ttx.SKY_NAMES):
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        if i % 2 == 0:
            Image.fromarray(img, "RGBA").save(root / f"{name}.png")
        else:
            save_png(img[..., :3], str(root / f"{name}.png"))
    return root


def test_ablation_probe_on_cpu(capsys):
    report = {}
    assert megakernel_ablation_torch.main(
        ["--size", "32x16", "--reps", "2", "--n", "1", "--device", "cpu"],
        report) == 0
    out = capsys.readouterr().out
    for arm in megakernel_ablation_torch.ARMS:
        assert f"\n{arm}: " in out
    assert "host-clock ms per call of the plain version" in out
    assert "shadow sweeps" in out and "levels 2+" in out
    assert set(report["arms"]) == set(megakernel_ablation_torch.ARMS)
    assert megakernel_ablation_torch.main(
        ["--size", "32x16", "--reps", "1", "--n", "1", "--device", "cpu",
         "--arms", "hcull,noshade"]) == 0
    out = capsys.readouterr().out
    assert "\nfull: " in out and "\nnoshade: " in out
    assert "\nnoshadow: " not in out
    for arms in ("full,specgate", "nospecgate", "full,bogus"):
        with pytest.raises(SystemExit) as e:
            megakernel_ablation_torch.main(["--device", "cpu", "--arms",
                                            arms])
        assert e.value.code == 2
    assert "specular gate" in capsys.readouterr().err


def test_decompose_probe_on_cpu(capsys, tmp_path):
    small = ["--size", "32x16", "--reps", "2", "--n", "1", "--device", "cpu"]
    report = {}
    assert worst_pose_decompose_torch.main(
        [*small, "--sky-shape", "64x32"], report) == 0
    out = capsys.readouterr().out
    for stage in worst_pose_decompose_torch.DEVICE_STAGES:
        assert f"\n{stage}: " in out
    for stage in worst_pose_decompose_torch.HOST_STAGES:
        assert f" {stage} " in out.split("\nhost: ")[1]
    assert report["sky"] == ("procedural", 32, 64)
    assert worst_pose_decompose_torch.main(
        [*small, "--sky", "reference", "--sky-dir",
         str(_sky_dir(tmp_path / "sky")), "--sky-downsample", "2"],
        report) == 0
    assert report["sky"] == ("reference", 12, 24)
    missing = tmp_path / "none"
    assert worst_pose_decompose_torch.main(
        [*small, "--sky", "reference", "--sky-dir", str(missing)]) == 2
    assert str(missing / "morning.png") in capsys.readouterr().err


def test_tail_and_readback_probes_on_cpu(capsys):
    small = ["--size", "32x16", "--sky-shape", "64x32", "--device", "cpu"]
    report = {}
    assert tail_probe_torch.main([*small, "--blocks", "2", "--frames", "2"],
                                 report) == 0
    assert report["frame"]["p50"] > 0 and report["block_host"]["p99"] > 0
    assert readback_fps_torch.main([*small, "--frames", "3", "--reps", "1"],
                                   report) == 0
    out = capsys.readouterr().out
    assert "p50" in out and "p99" in out and "host clock" in out
    assert "serialised" in out and "one_behind" in out
    assert all(report[m]["host_fps"][0] > 0
               for m in readback_fps_torch.MODES)


# --- the reference-sky source ---

@pytest.mark.parametrize("downsample", [1, 3])
def test_reference_skies_equal_the_jax_loader(tmp_path, downsample):
    sky = _sky_dir(tmp_path / "sky", 30, 60)
    want = jtx.load_reference_skies(str(sky), downsample, cache=False)
    got = ttx.load_reference_skies(str(sky), downsample, cache=False)
    assert got.dtype == np.uint8 and got.shape == (4, 30 // downsample,
                                                   60 // downsample, 3)
    assert np.array_equal(got, want)
    loaded = ttx.load_skies("reference", downsample, path=str(sky))
    assert np.array_equal(loaded.texels, want)


def test_load_skies_auto_and_missing_panoramas(tmp_path):
    sky = _sky_dir(tmp_path / "sky")
    auto = ttx.load_skies("auto", 1, (16, 32), path=str(sky)).texels
    assert np.array_equal(auto, ttx.load_reference_skies(str(sky),
                                                         cache=False))
    absent = tmp_path / "absent"
    assert ttx.load_skies("auto", 1, (16, 32),
                          path=str(absent)).texels.shape == (4, 16, 32, 3)
    (sky / "night.png").unlink()
    with pytest.raises(FileNotFoundError, match="night.png"):
        ttx.load_reference_skies(str(sky), cache=False)
    with pytest.raises(ValueError):
        ttx.load_skies("panorama")


def test_render_config_sky_downsample():
    assert RenderConfig(sky_source="reference", sky_downsample=4)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="sky_downsample"):
            RenderConfig(sky_downsample=bad)
