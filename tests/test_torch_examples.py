"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``), on the CPU.

Each JAX example runs in a subprocess (``JAX_PLATFORMS=cpu``) and the
port's ``main(device="cpu")`` in process; every printed line must be the
same, counts, bytes, hits, evictions, retries and ratios included.  Left
out of the comparison: wall times and speed-ups (the host clock), and
``topk_serving``'s sampled tokens (the port's ``init_params`` draws from
a ``torch.Generator``, not from ``jax.random``).  A line may differ only
where a deliberate difference listed in ROADMAP queue 3 explains it,
named in ``DELIBERATE`` below.

``pruned_pretraining`` trains: both packages run it with a short argv
(``PRETRAIN_ARGV`` and a temporary ``--ckpt-dir`` each), and its loss
values and times are left out (``PRETRAIN_NOT_COMPARED``: the port's
``init_params`` draws from a ``torch.Generator``), its curation and
checkpoint lines compared.
"""

import importlib.util
import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart", "fleet_serving", "resilient_serving",
            "streaming_ingest", "sublinear_pruning", "topk_serving"]
PRETRAIN_ARGV = ["--steps", "4", "--batch", "2", "--seq", "32"]
PRETRAIN_NOT_COMPARED = [
    (r"loss=[\d.]+ \([\d.]+s/step\)", "loss=<loss> (<s>/step)"),
    (r"first loss [\d.]+ -> last [\d.]+", "first loss <loss> -> last <loss>"),
    (r"checkpoint -> .*/step_", "checkpoint -> <dir>/step_"),
]

# (what is left out of the comparison, as a pattern and its stand-in)
NOT_COMPARED = [
    (r"flat\s+[\d.]+ ms\s+tree\s+[\d.]+ ms\s+\(\s*[\d.]+x,",
     "flat <ms> tree <ms> (<speed-up>,"),        # sublinear_pruning
    (r" in \d+ ms$", " in <ms>"),                # topk_serving
    (r"sample: \[[\d, ]*\]", "sample: <tokens>"),  # topk_serving
]

# example -> {the JAX example's text: the port's, and the queue 3 entry}
DELIBERATE = {
    "sublinear_pruning": {
        # ROADMAP queue 3, "ServiceCounters.launches counts kernel launches
        # only ... A gathered tree filter group counts under tree_launches
        # alone.  The reference counts it as a launch too."
        "launches=1 tree_launches=1": "launches=0 tree_launches=1",
    },
}

torch.set_num_threads(1)


def _compared(text: str, not_compared=NOT_COMPARED):
    lines = []
    for line in text.splitlines():
        for pat, stand_in in not_compared:
            line = re.sub(pat, stand_in, line)
        lines.append(line)
    return lines


def _jax_example(name: str, argv=()) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py"),
                          *argv],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def load_example(name: str):
    """The port's example ``name`` as a module (``examples_torch`` is a
    directory of scripts, not a package)."""
    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, device) -> str:
    """What the port's example ``name`` prints on ``device``."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        load_example(name).main(device=device)
    return buf.getvalue()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_the_jax_examples_counts(name):
    want = _compared(_jax_example(name))
    got = _compared(run_example(name, "cpu"))
    assert len(got) == len(want), "\n".join(got)
    for g, w in zip(got, want):
        for jax_text, port_text in DELIBERATE.get(name, {}).items():
            if jax_text in w:
                assert port_text in g, (g, w)
                w = w.replace(jax_text, port_text)
        assert g == w


def test_pruned_pretraining_prints_the_jax_examples_lines(tmp_path):
    want = _compared(_jax_example("pruned_pretraining", PRETRAIN_ARGV + [
        "--ckpt-dir", str(tmp_path / "jax")]), PRETRAIN_NOT_COMPARED)
    buf = io.StringIO()
    with redirect_stdout(buf):
        losses = load_example("pruned_pretraining").main(
            PRETRAIN_ARGV + ["--ckpt-dir", str(tmp_path / "port")], "cpu")
    got = _compared(buf.getvalue(), PRETRAIN_NOT_COMPARED)
    assert got == want
    assert any("curation pruned" in line for line in got)
    assert any("checkpoint -> <dir>/step_00000004" in line for line in got)
    assert len(losses) == 4 and all(np.isfinite(losses))


@pytest.mark.parametrize("name", EXAMPLES + ["pruned_pretraining"])
def test_example_imports_only_the_port(name):
    # no jax or repro import, and the GPU by default: without a card the
    # example raises before it prints a line
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        f"sys.argv = ['{name}.py']\n"
        "try:\n"
        f"    exec(open('examples_torch/{name}.py').read(),\n"
        "         {'__name__': '__main__', '__file__': 'x'})\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "    print('raised')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + str(ROOT / "examples_torch"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised"
