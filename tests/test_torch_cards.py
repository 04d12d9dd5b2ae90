"""Card-only tests of the offline record job's path (skipped without the
cards they need): `to_host` of a 16-frame 1920x1080 batch reuses its
page-locked memory once warm and equals `.cpu()`, and frame DP, the
sharded Engine and the (frames x rows) hybrid capture and replay one CUDA
graph per entry on distinct cards, their frames and states equal bit for
bit to the same layout on a repeated cuda:0.

On the card's machine (which has no JAX):
    python -m pytest tests/test_torch_cards.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from chip_smoke import make_state, states_equal, toggling_actions
from raytracing_cuda_tpu_torch.app import loop
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.sim import state as tsim
from raytracing_cuda_tpu_torch.utils import images, profiling
from raytracing_cuda_tpu_torch.utils.config import RenderConfig

pytestmark = pytest.mark.cuda

H, W = 96, 160
SKY = (64, 128)


def _cards(n: int) -> list:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} distinct CUDA cards, this machine has {have}")
    return [f"cuda:{i}" for i in range(n)]


def small_engine(sharded=False, **kw) -> Engine:
    return Engine(RenderConfig(width=W, height=H, procedural_sky_shape=SKY,
                               **kw), device="cuda:0", sharded=sharded)


def test_to_host_of_a_1080p_batch_reuses_pinned_memory():
    """Six copies of a 16-frame 1920x1080 batch, each held until the next
    is in host memory, as `record` holds them: every array equals .cpu() of
    its batch and keeps its values through the later copies, and after the
    first two copies no host memory is allocated (also as counted while a
    profiler records)."""
    _cards(1)
    src = torch.randint(0, 256, (16, 1080, 1920, 3), dtype=torch.uint8,
                        device="cuda:0")
    held, allocated = None, []
    for k in range(6):
        before = images._host_bytes()
        arr = images.to_host(src)
        allocated.append(images._host_bytes() - before)
        assert np.array_equal(arr, src.cpu().numpy()), k
        if held is not None:
            assert np.array_equal(held[0], held[1]), k
        src.add_(1)                 # the graph's output buffer, overwritten
        held = (arr, arr.copy())
    del arr                         # one batch held, as the job holds it
    assert allocated[0] > 0 and allocated[2:] == [0] * 4, allocated
    calls = profiling.COUNTERS.get("images.to_host.calls", 0)
    new = profiling.COUNTERS.get("images.to_host.host_alloc_bytes", 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            held = images.to_host(src)
    assert profiling.COUNTERS["images.to_host.calls"] == calls + 3
    assert profiling.COUNTERS["images.to_host.host_alloc_bytes"] == new


def _run(eng, call, n_calls, st0):
    """Calls call(eng, j), j < n_calls, from st0 → [(frames, end state)],
    on the CPU."""
    eng.set_state(st0)
    return [(call(eng, j).cpu(), tsim.state_to(eng.state, "cpu"))
            for j in range(n_calls)]


def _same(got, want):
    for j, ((a, sa), (b, sb)) in enumerate(zip(got, want)):
        assert torch.equal(a, b), j
        assert states_equal(sa, sb), j


def _captured_on_their_cards(eng, mesh):
    reps = eng._replicas[tuple(torch.device(d) for d in mesh)]
    graphs = next(iter(reps.graphs.values()))
    assert len(graphs) == len(mesh)
    for d in dict.fromkeys(mesh):
        assert loop._capture_stream(d).device == torch.device(d)


@pytest.mark.parametrize("n", [2, 4])
def test_frame_dp_on_distinct_cards_equals_the_repeated_card(n):
    """render_script_dp over n distinct cards: three calls of 16 frames
    (eager, the capture, a replay) equal the same calls on
    ["cuda:0"] * n, frames and states, bit for bit."""
    mesh = _cards(n)
    acts = toggling_actions(16, seed=21)
    st0 = make_state(9.5)
    eng = small_engine()

    def on(m):
        return lambda e, j: e.render_script_dp(acts, dt=0.05, mesh=m)

    got = _run(eng, on(mesh), 3, st0)
    want = _run(eng, on(["cuda:0"] * n), 3, st0)
    _same(got, want)
    _captured_on_their_cards(eng, mesh)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["frame", "batch"])
def test_sharded_engine_on_distinct_cards_equals_the_repeated_card(kind, n):
    """A row-sharded Engine over n distinct cards: four calls (eager,
    capture, two replays) equal those of an Engine sharded over cuda:0
    repeated n times, frames and states, bit for bit."""
    mesh = _cards(n)
    acts = toggling_actions(32, seed=22)
    st0 = make_state(17.5)

    def call(e, j):
        if kind == "frame":
            return e.step_and_frame(acts[j], 0.03)
        return e.step_and_frame_batch(acts[8 * j:8 * j + 8], [0.03] * 8)

    distinct = small_engine(sharded=mesh)
    repeated = small_engine(sharded=["cuda:0"] * n)
    _same(_run(distinct, call, 4, st0), _run(repeated, call, 4, st0))
    _captured_on_their_cards(distinct, mesh)


def test_hybrid_on_distinct_cards_equals_the_repeated_card():
    """The (frames x rows) hybrid over 2 groups of 2 distinct cards: three
    calls of 16 frames equal those on [["cuda:0"] * 2] * 2, bit for bit."""
    cards = _cards(4)
    mesh = [cards[:2], cards[2:]]
    acts = toggling_actions(16, seed=23)
    st0 = make_state(6.5)
    eng = small_engine(shard_interleave=2)

    def on(m):
        return lambda e, j: e.render_script_dp(acts, dt=0.05, n_rows=2,
                                               mesh=m)

    got = _run(eng, on(mesh), 3, st0)
    want = _run(eng, on([["cuda:0"] * 2] * 2), 3, st0)
    _same(got, want)
    _captured_on_their_cards(eng, cards)
