"""__torch_entry__.py, the port of __graft_entry__.py, on the CPU.

  - dryrun_multichip(8, "cpu") passes: every row-sharded, strided,
    frame-parallel and hybrid frame equals the single-device frame bit for
    bit (the script asserts it; the test also holds the pieces it prints);
  - entry()'s frame against __graft_entry__.entry()'s under the golden
    contract (RMSE < 2e-3, < 0.3 % of pixels off by more than 2 levels):
    the same scene, state and 64x128 sky at 144x256 through both packages'
    one-shot render_frame.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import __torch_entry__ as tentry
from chip_smoke import GOLDEN_OFF_FRAC, GOLDEN_RMSE, golden_stats
from tests.test_torch_sim import assert_state_match

torch.set_num_threads(2)


def test_dryrun_multichip_8_on_the_cpu(capsys):
    tentry.dryrun_multichip(8, "cpu")
    out = capsys.readouterr().out
    assert out.startswith("dryrun_multichip(8): ok")
    assert "frame (128, 128, 3)" in out and "frame-dp 8 frames ok" in out
    assert "hybrid 2x4 ok" in out


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_other_mesh_sizes(n, capsys):
    tentry.dryrun_multichip(n, "cpu")
    nf = max(n // 4, 1)
    assert f"hybrid {nf}x{n // nf} ok" in capsys.readouterr().out


def test_dryrun_catches_a_wrong_band(monkeypatch):
    """The bit-equality asserts are live: a band renderer that drops the
    row offset fails the dry run."""
    from raytracing_cuda_tpu_torch.parallel import mesh

    real = mesh.bases_from_packs

    def no_offset(*a, row0=0, **kw):
        return real(*a, row0=0, **kw)

    monkeypatch.setattr(mesh, "bases_from_packs", no_offset)
    with pytest.raises(AssertionError, match="single-device frame"):
        tentry.dryrun_multichip(2, "cpu")


def test_entry_matches_the_jax_entry():
    jfn, (jscene, jstate, jsky) = jentry.entry()
    tfn, (tscene, tstate, tsky) = tentry.entry("cpu")
    assert_state_match(jstate, tstate)
    assert np.array_equal(np.asarray(jsky), tsky.numpy())
    want = np.asarray(jfn(jscene, jstate, jsky))
    got = tfn(tscene, tstate, tsky)
    assert got.shape == (144, 256, 3) and got.dtype == torch.uint8
    assert want.shape == got.shape
    rmse, off = golden_stats(got.numpy(), want)
    print(f"entry: port vs JAX rmse {rmse:.6f} off>2 {off:.4%}")
    assert rmse < GOLDEN_RMSE and off < GOLDEN_OFF_FRAC, (rmse, off)


def test_entries_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the no-CUDA refusal cannot be checked")
    with pytest.raises(RuntimeError, match="is_available"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="is_available"):
        tentry.dryrun_multichip(8)
