"""What the harness and the reference may import: never JAX nor the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the reference nothing of the port either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

RTBENCH = Path(__file__).resolve().parents[1]
ROOT = RTBENCH.parent
NEVER = {"jax", "jaxlib", "flax", "raytracing_cuda_tpu"}
PORT = "raytracing_cuda_tpu_torch"
# the reference's side: it imports nothing of the program
REFERENCE = [*sorted((RTBENCH / "reference").glob("*.py")),
             RTBENCH / "correct.py"]


def _imported(path: Path) -> set:
    """The top-level names of the modules a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(RTBENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(RTBENCH)))
def test_no_source_imports_jax(path):
    assert not _imported(path) & NEVER


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(RTBENCH)))
def test_the_reference_imports_nothing_of_the_port(path):
    assert PORT not in _imported(path)


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, check=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_reference_check_loads_no_program():
    loaded = _loaded_after(
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from rtbench import correct, generator\n"
        "f = generator.Flight(generator.load_traffic('fly'), 4)\n"
        "r = {'width': 32, 'height': 16, 'antialiasing': True,\n"
        "     'procedural_sky_shape': [16, 32]}\n"
        "correct.reference_outputs(r, f.start, f.take(30), {29}, 'cpu')\n")
    assert "torch" in loaded
    assert not loaded & (NEVER | {PORT})


def test_a_run_loads_no_jax():
    loaded = _loaded_after(
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from rtbench import run\n"
        "run.run_cell('island_720p.fly', 8, 0.3, False, device='cpu',\n"
        "             render_over={'width': 32, 'height': 16,\n"
        "                          'procedural_sky_shape': [16, 32]})\n")
    assert PORT in loaded
    assert not loaded & NEVER


def test_a_record_run_loads_no_jax(record_root):
    loaded = _loaded_after(
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from rtbench import run\n"
        "run.run_cell('island_720p.record8', 8, 0.3, False,\n"
        "             device='cpu', mesh=['cpu'] * 2,\n"
        f"             root=Path({str(record_root)!r}),\n"
        "             render_over={'width': 32, 'height': 16,\n"
        "                          'procedural_sky_shape': [16, 32]})\n")
    assert PORT in loaded
    assert not loaded & NEVER
