"""The mesh half of the port's ``models/sharding.py`` against the JAX
package's, on the CPU.

* ``logical_to_pspec`` for every ParamSpec of every config the repo lists
  (full and smoke sizes, the per-arch train rules on top), on abstract
  meshes of the production shapes and of the test shapes: equal.
* ``NamedSharding.devices_indices_map``: every rank's slice equals the one
  JAX's ``NamedSharding`` gives the device at the same mesh coordinate of
  a ``Mesh`` over 8 host devices (built with ``jax.sharding.Mesh``:
  ``jax.make_mesh`` makes Explicit axes, ROADMAP queue 3, R3), computed in
  a subprocess that sets the host device count.
* On 4 gloo ranks (a 2x2 DeviceMesh over a FileStore), each rank's local
  DTensor shard (``distribute_tensor`` to ``placements()``) equals that
  slice of the whole tensor.
* ``constrain`` is the identity off a mesh and on a mesh of one rank;
  ``placements()`` refuses a tuple entry out of the mesh's axis order.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke
from repro.launch.specs import arch_rules as r_arch_rules
from repro.models import build_model as r_build
from repro.models import sharding as RSH

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch.specs import arch_rules
from repro_torch.models import build_model
from repro_torch.models import sharding as TSH

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16), "2x2": (2, 2),
          "2x2x2": (2, 2, 2), "1x1": (1, 1)}


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _pairs(rtree, ttree, path=""):
    """(path, JAX ParamSpec, port ParamSpec) over two spec trees."""
    if isinstance(ttree, dict):
        assert sorted(rtree) == sorted(ttree), path
        for k in ttree:
            yield from _pairs(rtree[k], ttree[k], f"{path}/{k}")
    else:
        yield path, rtree, ttree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_logical_to_pspec_matches_jax(arch, mesh):
    shape = MESHES[mesh]
    jm = JAbstractMesh(shape, _names(shape))
    tm = TSH.AbstractMesh(shape, _names(shape))
    n = 0
    for r_get, t_get in ((r_get_config, get_config),
                         (r_get_smoke, get_smoke_config)):
        rcfg, cfg = r_get(arch), t_get(arch)
        rules = [None, arch_rules(cfg, tm, "train"),
                 arch_rules(cfg, tm, "decode")]
        rrules = [None, r_arch_rules(rcfg, jm, "train"),
                  r_arch_rules(rcfg, jm, "decode")]
        specs = build_model(cfg, device="cpu").specs
        for path, rs, ts in _pairs(r_build(rcfg).specs, specs):
            assert tuple(rs.shape) == tuple(ts.shape), path
            for rr, tr in zip(rrules, rules):
                want = tuple(RSH.logical_to_pspec(rs.logical, rs.shape, jm,
                                                  rr))
                got = tuple(TSH.logical_to_pspec(ts.logical, ts.shape, tm,
                                                 tr))
                assert got == want, (path, rr)
                n += 1
            assert TSH.mesh_axis_size(tm, ("pod", "data")) == \
                RSH.mesh_axis_size(jm, ("pod", "data"))
    assert n > 0


# (mesh shape, spec entries, tensor shape)
MAP_CASES = [
    ((2, 4), [None, None], (8, 12)),
    ((2, 4), ["data", None], (8, 12)),
    ((2, 4), [None, "model"], (8, 12)),
    ((2, 4), ["model", "data"], (8, 12)),
    ((2, 4), [["data", "model"], None], (16, 3)),
    ((2, 2, 2), [["pod", "data"], "model"], (8, 6)),
    ((2, 2, 2), [None, ["pod", "data", "model"]], (3, 16)),
    ((2, 2, 2), ["model", None, "pod"], (4, 5, 2)),
]


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _slices_json(idx):
    return [[s.start, s.stop] for s in idx]


@pytest.fixture(scope="module")
def jax_maps():
    """JAX's devices_indices_map of every MAP_CASES case, by device id, on
    8 host devices in a subprocess."""
    code = textwrap.dedent("""
        import json, sys
        import numpy as np
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        cases = json.loads(sys.argv[1])
        out = []
        for shape, entries, tshape in cases:
            names = ("data", "model") if len(shape) == 2 else \\
                ("pod", "data", "model")
            n = int(np.prod(shape))
            mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
            spec = P(*[tuple(e) if isinstance(e, list) else e
                       for e in entries])
            m = NamedSharding(mesh, spec).devices_indices_map(tuple(tshape))
            out.append({str(d.id): [[s.start, s.stop] for s in idx]
                        for d, idx in m.items()})
        print(json.dumps(out))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", code, json.dumps(MAP_CASES)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", range(len(MAP_CASES)))
def test_devices_indices_map_matches_jax(case, jax_maps):
    shape, entries, tshape = MAP_CASES[case]
    mesh = TSH.AbstractMesh(shape, _names(shape))
    got = TSH.NamedSharding(mesh, TSH.P(*_spec(entries))) \
        .devices_indices_map(tshape)
    assert {str(r): _slices_json(idx) for r, idx in got.items()} == \
        jax_maps[case]


# specs over the 2x2 gloo mesh: (entries, tensor shape)
SHARD_CASES = [
    ([None, None], (4, 6)),
    (["data", None], (4, 6)),
    ([None, "model"], (4, 6)),
    (["model", "data"], (4, 6)),
    ([["data", "model"], None], (8, 3)),
    ([None, ["data", "model"]], (3, 8)),
]


def _shard_worker(rank, world, store, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        ok = []
        for entries, shape in SHARD_CASES:
            full = torch.arange(int(np.prod(shape)),
                                dtype=torch.float32).reshape(shape)
            sh = TSH.NamedSharding(mesh, TSH.P(*_spec(entries)))
            local = distribute_tensor(full, mesh, sh.placements(),
                                      src_data_rank=None).to_local()
            want = full[sh.devices_indices_map(shape)[rank]]
            ok.append(bool(torch.equal(local, want)))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(ok, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    mp.spawn(_shard_worker, args=(4, str(d / "store"), str(d)), nprocs=4,
             join=True)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(4)]


@pytest.mark.parametrize("case", range(len(SHARD_CASES)))
def test_gloo_local_shard_is_the_slice(case, gloo_shards):
    assert all(r[case] for r in gloo_shards)


def test_constrain_is_identity_without_a_larger_mesh():
    x = torch.randn(4, 8, 2)
    assert TSH.constrain(x, "batch", "seq", "embed") is x
    with TSH.use_mesh(TSH.AbstractMesh((1, 1), ("data", "model"))):
        assert not TSH.on_mesh()
        assert TSH.constrain(x, "batch", "seq", "embed") is x
    assert TSH.current_mesh() is None


def test_placements_refuse_a_tuple_out_of_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = TSH.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    ok = TSH.NamedSharding(mesh, TSH.P(("pod", "data"), None, "model"))
    assert ok.placements() == (Shard(0), Shard(0), Shard(2))
    assert TSH.NamedSharding(mesh, TSH.P(None)).placements() == \
        (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        TSH.NamedSharding(mesh, TSH.P(("data", "pod"))).placements()
