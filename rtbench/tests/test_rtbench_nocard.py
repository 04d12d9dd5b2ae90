"""The command fails, and prints no result, where it cannot run the cell:
no card, or a checkout that holds only BENCHMARK.json and rtbench/. On a
card (marked `cuda`, decided in the fixture) a short run at a small size,
plain and traced, is correct."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "island_720p.fly", "--seed", "2147483999",
        "--seconds", "1", "--trace", "0"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_no_card_no_result(no_card):
    out = subprocess.run([sys.executable, "rtbench/run.py", *ARGS],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "rtbench/run.py", *ARGS],
                         capture_output=True, text=True, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
def test_a_short_run_on_the_card(card, traced):
    from rtbench import run
    res = run.run_cell("island_720p.fly", 31, 1.0, traced, device=card,
                       render_over={"width": 160, "height": 96,
                                    "procedural_sky_shape": [64, 128]})
    assert res["correct"] and res["device"]["platform"] == "gpu"
    if not traced:
        assert res["metrics"]["fps"]["value"] > 0
        return
    m = res["metrics"]
    assert 0 <= m["device_idle_pct"]["value"] < 100
    assert 0 < m["frame_mfu"]["value"] < 100
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
