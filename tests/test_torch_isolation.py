"""The port stands alone: no JAX, nothing of ``repro``, and the GPU by
default.

``src/repro_torch`` must import neither ``jax`` nor any module of the JAX
package (even a NumPy-only one pulls JAX in through its package
``__init__``), and its entry points must refuse to run on the CPU unless
the caller asks for it.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py"))

torch.set_num_threads(1)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(PORT))
                                             for p in FILES])
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_port_imports_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch.serve.prune_service as s\n"
        "import repro_torch.core, repro_torch.kernels, repro_torch.data.generator\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', s.PruningService.__name__)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok PruningService"


def test_service_without_a_card_raises(monkeypatch):
    from repro_torch.core.flow import PruningPipeline
    from repro_torch.serve.prune_service import PruningService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PruningService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PruningService(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PruningPipeline(filter_mode="device").device_service()
    assert PruningService(device="cpu").device.type == "cpu"
