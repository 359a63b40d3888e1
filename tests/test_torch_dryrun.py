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
import math
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


# ---------------------------------------------------------------------------
# the expert-parallel MoE block on the fake mesh
# ---------------------------------------------------------------------------

MOE_LAYOUTS = [("scatter", "fsdp"), ("scatter", "expert_only"),
               ("grouped", "fsdp"), ("grouped", "expert_only"),
               ("grouped", "resident")]
MOE_MESHES = {"2x2": False, "2x2x2": True}


@pytest.fixture(scope="module")
def moe_counted(tmp_path_factory):
    """Kimi's smoke MoE block (forward and backward, bf16) on the 8-rank
    fake mesh under ``CollectiveCounter``, every collective's kind, axis,
    dtype and shape recorded, for each layout on 2x2 and 2x2x2; and the
    ``"resident"`` + ``"grouped"`` smoke record of ``kimi-k2-1t-a32b
    train_4k`` beside the default one."""
    d = tmp_path_factory.mktemp("dryrun_moe")
    code = textwrap.dedent("""
        import dataclasses, json, sys
        import torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.fx.experimental.symbolic_shapes import ShapeEnv
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models import moe
        from repro_torch.models.sharding import (NamedSharding, P,
                                                 tree_shardings, use_mesh)
        from repro_torch.train.elastic import place

        class Seen(dryrun.CollectiveCounter):
            def __init__(self, mesh):
                super().__init__(mesh)
                self.seen = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = super().__torch_dispatch__(func, types, args, kwargs)
                name = func.overloadpacket.__name__
                if func.namespace == "_c10d_functional" and \\
                        name in self.KINDS:
                    g = args[-1] if isinstance(args[-1], str) \\
                        else kwargs.get("group_name")
                    self.seen.append([self.KINDS[name], self.axis(g),
                                      str(out.dtype), list(out.shape)])
                return out

        layouts, meshes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
        dryrun.init_fake_group(8)
        out = {}
        for mname, mp in meshes.items():
            mesh = make_production_mesh(multi_pod=mp, device="cpu")
            for disp, sh in layouts:
                cfg = dataclasses.replace(
                    get_smoke_config("kimi-k2-1t-a32b"), moe_dispatch=disp,
                    moe_sharding=sh, moe_seq_chunk=8)
                specs = moe.moe_specs(cfg)
                seen = Seen(mesh)
                with FakeTensorMode(allow_non_fake_inputs=True,
                                    shape_env=ShapeEnv()):
                    sh_ = tree_shardings(specs, mesh)
                    p = {k: place(torch.empty(s.shape, dtype=torch.bfloat16)
                                  .requires_grad_(), sh_[k])
                         for k, s in specs.items()}
                    dp = ("pod", "data") if mp else "data"
                    x = place(torch.empty(8, 16, cfg.d_model,
                                          dtype=torch.bfloat16),
                              NamedSharding(mesh, P(dp, None, None)))
                    with use_mesh(mesh), seen:
                        y, aux = moe.moe_block(p, x, cfg)
                        (y.float().sum() + aux).backward()
                    local = {k: list(v.to_local().shape)
                             for k, v in p.items()}
                out[f"{mname} {disp} {sh}"] = dict(
                    seen=seen.seen, counted=seen.counted, local=local)
        recs = {}
        for over in (None, dict(moe_dispatch="grouped",
                                moe_sharding="resident")):
            rec = dryrun.run_cell("kimi-k2-1t-a32b", "train_4k", False,
                                  overrides=over, smoke=True)
            recs["resident" if over else "default"] = rec
        json.dump(dict(blocks=out, records=recs),
                  open(sys.argv[3], "w"))
    """)
    env = dict(os.environ, PYTHONPATH="src", REPRO_MESH_SCALE="8")
    out = d / "moe.json"
    r = subprocess.run([sys.executable, "-c", code, json.dumps(MOE_LAYOUTS),
                        json.dumps(MOE_MESHES), str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("mesh", sorted(MOE_MESHES))
@pytest.mark.parametrize("dispatch,sharding", MOE_LAYOUTS)
def test_moe_block_gathers_no_expert_weights(mesh, dispatch, sharding,
                                             moe_counted):
    """On the fake mesh, forward and backward, the block issues no
    all-gather at all (the routes are gathered by a sum of zero-padded
    blocks), so none carries expert-weight bytes, and each rank's expert
    weights are their local shards."""
    got = moe_counted["blocks"][f"{mesh} {dispatch} {sharding}"]
    assert got["seen"], "the block issued no collective"
    kinds = {s[0] for s in got["seen"]}
    assert "all-gather" not in kinds, got["seen"]
    local = got["local"]
    full = {"router": [64, 8], "wg": [8, 64, 32], "wu": [8, 64, 32],
            "wd": [8, 32, 64]}
    for n in ("wg", "wu", "wd"):
        assert math.prod(local[n]) < math.prod(full[n]), (n, local[n])


@pytest.mark.parametrize("mesh,axis", [("2x2", "data"),
                                       ("2x2x2", "pod+data")])
def test_resident_moe_moves_tokens_by_all_to_all(mesh, axis, moe_counted):
    """``"resident"``: the experts on the batch axes, each kept slot's row
    travels to them by an all-to-all over those axes (forward and
    backward); ``"experts"`` over ``model`` needs none."""
    res = moe_counted["blocks"][f"{mesh} grouped resident"]["counted"]
    assert res[axis]["all-to-all"] > 0, res
    for layout in ("grouped fsdp", "scatter expert_only"):
        other = moe_counted["blocks"][f"{mesh} {layout}"]["counted"]
        assert all("all-to-all" not in kinds for kinds in other.values())


@pytest.mark.parametrize("layout", ["default", "resident"])
def test_moe_cells_count_their_temp_bytes(layout, moe_counted):
    """The expert-parallel dispatch's shapes are static, so MemTracker
    adds up the MoE cells' temp bytes (null before it); the resident
    record's collectives include its all-to-all over ``data``."""
    rec = moe_counted["records"][layout]
    assert rec["status"] == "OK", rec
    assert isinstance(rec["temp_size_in_bytes"], int)
    assert rec["temp_size_in_bytes"] > 0
    by_axis = rec["roofline"]["coll_by_axis"]
    if layout == "resident":
        assert by_axis["data"]["all-to-all"] > 0, by_axis
