"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference loads nothing of the engine."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "gie_mapping_tpu")


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint('\\n'.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'mapbench/tests')\n"
            "from conftest import load, tiny\n"
            "from mapbench.run import run_cell\n"
            "c, t = tiny(load('configs', 'depthcam'), load('traffic', 'hover'))\n"
            "r, checks, _ = run_cell(c, t, seed=1, seconds=0, device='cpu', max_frames=2)\n"
            "assert r['correct']")
    tops = _modules(code)
    assert "gie_mapping_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_engine():
    tops = _modules("import mapbench.reference.mapper, mapbench.compare, mapbench.generate, "
                    "mapbench.control, mapbench.roofline, mapbench.paths.circle, "
                    "mapbench.sensors.depth, mapbench.sensors.pinhole_cloud")
    assert not tops & set(FORBIDDEN + ("gie_mapping_tpu_torch",))


def test_refuses_without_a_card(tmp_path):
    """Without a CUDA device the run exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "mapbench.run", "--workload", "depthcam.flight",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0 and r.stdout.strip() == ""
