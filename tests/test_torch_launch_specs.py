"""The port's ``launch/specs.py``, ``models/sharding.py`` rules and the
hardware-free half of ``launch/roofline.py`` against the JAX package's.

Everything here is device-free: both sides run on an abstract mesh
(``jax.sharding.AbstractMesh`` and the port's ``AbstractMesh``) of the
production shapes, (16, 16) and (2, 16, 16), with the full published
configs.  Specs are compared as tuples of their entries; the analytic
FLOP and byte counts must be equal exactly (the port's are a copy).
"""

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import get_config as r_get_config
from repro.configs.base import SHAPES as R_SHAPES
from repro.launch import roofline as RR
from repro.launch import specs as RS
from repro.models import build_model as r_build

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import roofline as TR
from repro_torch.launch import specs as TS
from repro_torch.models import build_model
from repro_torch.models.sharding import AbstractMesh

torch.set_num_threads(1)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list_archs()


def _meshes(name):
    shape, names = MESHES[name]
    return JAbstractMesh(shape, names), AbstractMesh(shape, names)


def _specs_of(tree):
    """{key: spec tuple} of a dict of NamedShardings (either package)."""
    return {k: tuple(v.spec) for k, v in tree.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    rcfg, cfg = r_get_config(arch), get_config(arch)
    rmodel, model = r_build(rcfg), build_model(cfg, device="cpu")
    for name in SHAPES:
        shape, rshape = SHAPES[name], R_SHAPES[name]
        for kind in ("train", "prefill", "decode"):
            assert TS.arch_rules(cfg, tm, kind) == RS.arch_rules(rcfg, jm,
                                                                 kind)
        assert TS.batch_pspec(tm, shape.global_batch) == RS.batch_pspec(
            jm, rshape.global_batch)
        for fn in ("train_batch_specs", "prefill_batch_specs"):
            tb, tsh = getattr(TS, fn)(cfg, shape, tm)
            rb, rsh = getattr(RS, fn)(rcfg, rshape, jm)
            assert {k: tuple(v.shape) for k, v in tb.items()} == \
                {k: tuple(v.shape) for k, v in rb.items()}
            assert {k: str(v.dtype).split(".")[-1] for k, v in tb.items()} \
                == {k: str(v.dtype) for k, v in rb.items()}
            assert all(v.device.type == "meta" for v in tb.values())
            assert _specs_of(tsh) == _specs_of(rsh)
        (tc, ttok, tpos), (tcs, ttoks, tposs) = TS.decode_specs(
            cfg, shape, tm, model)
        (rc, rtok, rpos), (rcs, rtoks, rposs) = RS.decode_specs(
            rcfg, rshape, jm, rmodel)
        assert {k: tuple(v.shape) for k, v in tc.items()} == \
            {k: tuple(v.shape) for k, v in rc.items()}
        assert _specs_of(tcs) == _specs_of(rcs)
        assert tuple(ttok.shape) == tuple(rtok.shape)
        assert tuple(tpos.shape) == tuple(rpos.shape)
        assert tuple(ttoks.spec) == tuple(rtoks.spec)
        assert tuple(tposs.spec) == tuple(rposs.spec)
        assert _specs_of(TS.cache_shardings(cfg, tc, tm)) == \
            _specs_of(RS.cache_shardings(rcfg, rc, jm))


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_match_jax(arch):
    rcfg, cfg = r_get_config(arch), get_config(arch)
    assert TR._matmul_params(cfg) == RR._matmul_params(rcfg)
    assert TR._attention_layers(cfg) == RR._attention_layers(rcfg)
    for name in SHAPES:
        shape, rshape = SHAPES[name], R_SHAPES[name]
        assert TR.analytic_flops(cfg, shape) == RR.analytic_flops(rcfg,
                                                                  rshape)
        for chips in (256, 512):
            assert TR.analytic_hbm_bytes(cfg, shape, chips) == \
                RR.analytic_hbm_bytes(rcfg, rshape, chips)
        assert TR.model_flops_for(cfg, shape) == RR.model_flops_for(rcfg,
                                                                    rshape)


def test_roofline_prices_axes_by_link():
    """The collective term: an axis inside one 8-card host at NVLink's
    rate, any other at the inter-host one; the production 16x16 mesh's
    ``model`` axis spans two hosts."""
    assert TR.link_of(range(16)) == "inter_host"      # 16x16's model axis
    assert TR.link_of(range(8, 16)) == "nvlink"
    assert TR.link_of(range(0, 256, 16)) == "inter_host"  # its data axis
    cfg = get_config("llama3.2-3b")
    counted = {"model": {"all-gather": 4e9}, "data": {"all-reduce": 9e8}}
    rl = TR.derive(cfg, SHAPES["train_4k"], counted, 256,
                   {"model": "nvlink", "data": "inter_host"})
    assert rl.coll_breakdown == {"all-gather": 4e9, "all-reduce": 9e8}
    assert rl.collective_s == pytest.approx(4e9 / TR.NVLINK_BW
                                            + 9e8 / TR.INTER_HOST_BW)
    assert rl.compute_s == pytest.approx(
        TR.analytic_flops(cfg, SHAPES["train_4k"]) / (256 * 989e12))
    assert rl.memory_s == pytest.approx(
        TR.analytic_hbm_bytes(cfg, SHAPES["train_4k"], 256) / (256 * 3.35e12))
    assert rl.bottleneck == max(("compute", "memory", "collective"),
                                key=lambda k: getattr(rl, f"{k}_s"))
    assert np.isclose(rl.useful_ratio, rl.model_flops / rl.flops)
