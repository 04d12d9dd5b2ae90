"""The pack base (render/packs.py) against the torch packs on the CPU.

On a card a frame's packs are one launch of csrc/packs.cu that copies the
base and rewrites only the entries `moving_entries` lists. These tests hold
the claim that launch rests on, for the island and the classic scene: in
every entry outside that list the torch packs (pipeline.frame_packs on the
CPU) equal the base, over the poses, the degenerate states and seeded
flights; and every entry in the list does move over those states. The
kernel's own arithmetic is held to the torch packs on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from chip_smoke import POSES, make_state, random_actions, toggling_actions
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.render import cuda_rt
from raytracing_cuda_tpu_torch.render.packs import (LAKE, STATIC, base_to,
                                                    layout_key,
                                                    moving_entries, pack_base)
from raytracing_cuda_tpu_torch.render.pipeline import (batch_packs,
                                                       frame_packs,
                                                       frame_packs_torch)
from raytracing_cuda_tpu_torch.scene import builders as tb
from raytracing_cuda_tpu_torch.sim import state as sim
from raytracing_cuda_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

H, W = 96, 160
SCENES = ("island", "classic")


def _clusters(name):
    return tb.TRI_CLUSTERS[name], tb.SPH_CLUSTERS[name], tb.TRI_SUBS[name]


def _flight(n: int, seed: int, acts=random_actions):
    """The states of n seeded frames from the initial state, at varied dt."""
    st = sim.settle(sim.init_state())
    out = []
    for i, a in enumerate(acts(n, seed)):
        st = sim.animate(st, a, 0.02 + 0.03 * (i % 4))
        out.append(st)
    return out


@pytest.fixture(scope="module")
def states():
    """The poses (golden, worst, the seven degenerate), then seeded flights
    with presets, clock scrubs and sea moves."""
    return ([make_state(**kw) for kw in POSES.values()]
            + _flight(60, 11) + _flight(60, 12, toggling_actions))


@pytest.fixture(scope="module", params=SCENES)
def packed(request, states):
    """(scene name, base, the torch packs of every state stacked: coefs,
    params)."""
    name = request.param
    scene = tb.build_named_scene(name)
    base = pack_base(scene, *_clusters(name))
    packs = [frame_packs(scene, st, H, W, None, *_clusters(name))
             for st in states]
    return (name, base, torch.stack([p[0] for p in packs]),
            torch.stack([p[1] for p in packs]))


def test_base_holds_every_entry_the_kernel_does_not_write(packed):
    _, base, coefs, params = packed
    coef_m, params_m = moving_entries(base)
    assert coefs.shape[1:] == base.coef.shape
    for k in range(len(coefs)):
        assert torch.equal(coefs[k][~coef_m], base.coef[~coef_m]), k
        assert torch.equal(params[k][~params_m], base.params[~params_m]), k


def test_every_moving_entry_moves(packed):
    """Each entry the base marks as moving differs between some two states:
    each float of a classed row's colour, of a light row and of the params'
    moving slots; each moving bound in one of its four floats (the island's
    light cluster holds the sun and its antipode, so its centre's y stays
    0)."""
    _, base, coefs, params = packed
    coef_m, params_m = moving_entries(base)
    coef_moved = (coefs != coefs[0]).any(0)
    params_moved = (params != params[0]).any(0)
    assert bool(coef_moved[coef_m].all()), torch.nonzero(
        coef_m & ~coef_moved).tolist()
    bounds = set()
    for _, _, g in base.moving.tolist():
        sl = slice(cuda_rt.P_CLUSTERS + 4 * g, cuda_rt.P_CLUSTERS + 4 * g + 4)
        assert bool(params_moved[sl].any()), g
        bounds.update(range(sl.start, sl.stop))
    slots = [i for i in torch.nonzero(params_m).flatten().tolist()
             if i not in bounds]
    assert bool(params_moved[slots].all()), [
        i for i in slots if not params_moved[i]]


def test_frame_packs_of_the_engine_read_its_base(packed):
    """frame_packs with the base passed, with the base and cull table
    passed, and frame_packs_torch are the same packs on the CPU."""
    name, base, coefs, params = packed
    scene = tb.build_named_scene(name)
    st = make_state(**POSES["worst_pose"])
    want = frame_packs_torch(scene, st, H, W, None, *_clusters(name))
    cull = cuda_rt.cull_table(base.coef, base.layout[2])
    for got in (frame_packs(scene, st, H, W, None, *_clusters(name),
                            base=base),
                frame_packs(scene, st, H, W, None, *_clusters(name), cull,
                            base)):
        assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
        assert got[2:4] == want[2:4] == (base.n_tri_rows, base.n_sph_rows)
        assert torch.equal(got[4], want[4])


@pytest.mark.parametrize("name", SCENES)
def test_base_layout(name):
    """The light rows are the last two sphere rows, emissive spheres; the
    moving bounds are the sphere clusters that hold them; the sea plane is
    the one lake row; radii sit on sphere rows only."""
    scene = tb.build_named_scene(name)
    base = pack_base(scene, *_clusters(name))
    flags = base.coef[:, cuda_rt.C_FLAGS]
    emissive = torch.nonzero(flags == 3.0).flatten().tolist()
    assert list(base.lights) == emissive[-2:]
    for first, rows, g in base.moving.tolist():
        assert (first, rows) == base.layout[2][g]
        assert any(first <= r < first + rows for r in base.lights)
    assert [g for _, _, g in base.moving.tolist()] == [
        g for g, (first, rows) in enumerate(base.layout[2])
        if any(first <= r < first + rows for r in base.lights)]
    assert torch.nonzero(base.row_class == LAKE).flatten().tolist() == [0]
    spheres = (flags % 2) == 1
    assert bool((base.sph_r[~spheres] == 0).all())
    assert bool((base.sph_r[spheres] > 0).all())
    assert torch.equal(
        base.sph_r[spheres] ** 2, base.coef[spheres, cuda_rt.C_R2])
    pads = base.coef[:, cuda_rt.C_GIDX] == 1e9
    assert bool((base.row_class[pads] == STATIC).all())


def test_a_base_of_another_layout_is_refused():
    island = tb.build_scene()
    classic = tb.build_classic_scene()
    base = pack_base(classic)
    st = make_state(6.0)
    with pytest.raises(ValueError, match="layout"):
        frame_packs(island, st, H, W, None, *_clusters("island"), base=base)
    with pytest.raises(ValueError, match="layout"):
        frame_packs(island, st, H, W, base=pack_base(
            island, *_clusters("island")))
    assert base.layout == layout_key(classic)
    with pytest.raises(ValueError, match="t_subs"):
        pack_base(island, None, None, (1,))


def test_engine_keeps_one_base_per_device_shared_by_resized():
    eng = Engine(RenderConfig(width=W, height=H, procedural_sky_shape=(32, 64)),
                 device="cpu", sharded=["cpu"] * 2)
    assert eng.pack_base.layout == layout_key(
        eng.scene, eng.tri_clusters, eng.sph_clusters, eng.tri_subs)
    assert torch.equal(eng.cull, cuda_rt.cull_table(
        eng.pack_base.coef, eng.pack_base.layout[2]))
    assert eng._pack_bases[eng.device] is eng.pack_base
    small = eng.resized(W // 2, H // 2)
    assert small.pack_base is eng.pack_base
    assert small._pack_bases[eng.device] is eng.pack_base
    moved = base_to(eng.pack_base, "cpu")
    assert all(torch.equal(getattr(moved, f), getattr(eng.pack_base, f))
               for f in ("coef", "params", "row_class", "sph_r", "moving"))


def test_batch_packs_with_the_base_equal_the_singles():
    scene = tb.build_scene()
    cl = _clusters("island")
    base = pack_base(scene, *cl)
    st = make_state(6.0)
    vecs = np.stack([a.pack(0.05) for a in random_actions(4, seed=3)])
    coefs, params, nt, ns, cull, states = batch_packs(
        scene, st, vecs, H, W, None, *cl, base=base)
    for k, s in enumerate(states):
        c, p, *_ = frame_packs_torch(scene, s, H, W, None, *cl)
        assert torch.equal(coefs[k], c) and torch.equal(params[k], p)
    assert (nt, ns) == (base.n_tri_rows, base.n_sph_rows)
