"""The port's dry-run (``python -m repro_torch.launch.dryrun``): the
counterparts of the JAX package's ``tests/test_dryrun.py`` on the same six
smoke cells, on the scaled 8-rank fake mesh (``REPRO_DRYRUN_DEVICES=8``,
``REPRO_MESH_SCALE=8``: 2x2 and 2x2x2).

Every cell runs in one subprocess (the fake process group is a process's
default group), each through the CLI's ``main`` into its own JSON file.
The JAX dry-run itself fails on these cells under jax 0.9 (ROADMAP queue
3, R3), so the port is held to the JAX package here by its record
fields, its SKIP and its collectives; the specs and the analytic terms
are held to JAX's in ``tests/test_torch_launch_specs.py``.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CASES = [
    ("llama3.2-3b", "train_4k"),                 # dense train
    ("kimi-k2-1t-a32b", "train_4k"),             # MoE
    ("mamba2-1.3b", "long_500k"),                # SSM decode
    ("zamba2-2.7b", "decode_32k"),               # hybrid cache
    ("whisper-small", "decode_32k"),             # enc-dec cross-cache
    ("llava-next-34b", "prefill_32k"),           # VLM prefix
]
# (arch, shape, multi_pod)
RUNS = [(a, s, False) for a, s in CASES] + [
    ("llama3.2-3b", "train_4k", True), ("glm4-9b", "long_500k", False)]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    code = textwrap.dedent("""
        import json, sys
        from repro_torch.launch import dryrun
        for arch, shape, mp in json.loads(sys.argv[1]):
            argv = ["--arch", arch, "--shape", shape, "--smoke", "--out",
                    f"{sys.argv[2]}/{arch}_{shape}_{mp}.json"]
            dryrun.main(argv + (["--multi-pod"] if mp else []))
    """)
    env = dict(os.environ, PYTHONPATH="src", REPRO_DRYRUN_DEVICES="8",
               REPRO_MESH_SCALE="8")
    r = subprocess.run([sys.executable, "-c", code, json.dumps(RUNS),
                        str(d)], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = {}
    for arch, shape, mp in RUNS:
        recs = json.loads((d / f"{arch}_{shape}_{mp}.json").read_text())
        assert len(recs) == 1
        out[(arch, shape, mp)] = recs[0]
    return out


@pytest.mark.parametrize("arch,shape", CASES)
def test_cell_runs(arch, shape, records):
    rec = records[(arch, shape, False)]
    assert rec["status"] == "OK", rec
    rl = rec["roofline"]
    assert rl["compute_s"] > 0 and rl["memory_s"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert rec["mesh_shape"] == {"data": 2, "model": 2}
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes"):
        assert isinstance(rec[k], int) and rec[k] >= 0, k
    assert rec["argument_size_in_bytes"] > 0
    temp = rec["temp_size_in_bytes"]
    assert temp is None or temp >= 0
    assert rec["peak_bytes_per_device"] == (
        rec["argument_size_in_bytes"] + rec["output_size_in_bytes"]
        + (temp or 0) - rec["alias_size_in_bytes"])
    assert rl["hardware"].startswith("NVIDIA H100")


def test_multipod_mesh_shards_pod_axis(records):
    rec = records[("llama3.2-3b", "train_4k", True)]
    assert rec["status"] == "OK", rec
    assert rec["mesh"] == "2x16x16"
    assert rec["mesh_shape"] == {"pod": 2, "data": 2, "model": 2}
    # collectives must exist: gradient reduction spans the pod axis
    assert rec["roofline"]["coll_bytes"] > 0
    assert sum(rec["roofline"]["coll_by_axis"]["pod"].values()) > 0


def test_long_context_skips_full_attention(records):
    rec = records[("glm4-9b", "long_500k", False)]
    assert rec["status"] == "SKIP"
    assert "sub-quadratic" in rec["reason"]


def test_port_holds_no_tpu_constant():
    """The roofline's hardware is the H100's: none of the JAX package's
    TPU v5e figures (197 TFLOP/s, 819 GB/s HBM, 50 GB/s a link as ICI)
    stands anywhere in the port."""
    pat = re.compile(r"197e12|819e9|ICI_BW|\bICI\b.*50e9|50e9.*\bICI\b")
    hits = [f"{p}:{i + 1}" for p in sorted((ROOT / "src" / "repro_torch")
                                           .rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines())
            if pat.search(line)]
    assert not hits, hits
    from repro_torch.launch import roofline as RL
    assert RL.PEAK_FLOPS == 989e12 and RL.HBM_BW == 3.35e12
    assert RL.NVLINK_BW == 450e9
